"""Text-grounded masks: detector boxes -> SAM box prompts -> one clean mask,
and the edit of the region a sentence names.

Counterpart of ``editanything_tpu/perception/grounding.py``
(sam2vlpart_edit.py:119-238 and sam2groundingdino_edit.py:130-262):
``prompt2mask`` keeps the boxes scoring at least ``score_thresh`` (the best
``max_boxes`` of them), turns each box into one SAM mask through
``SamPredictor.predict(box=...)`` (kernels D and C on CUDA), fills its holes
below ``small_region_area`` pixels and unions them;
``TextGuidedEditPipeline`` repaints that region through
``EditAnythingEditor.process``. The detector is any callable ``detect(image,
text) -> (boxes (N, 4) xyxy pixels, scores (N,), labels)``:
``models/groundingdino.py::GroundingDINODetector`` (the reference's UI
default, thresholds 0.25 and the top 2 boxes) or
``models/vlpart.py::VLPartDetector`` (0.7).
``remove_small_regions`` is segment_anything's, with ``scipy.ndimage``'s
8-connected labels for cv2's connected components.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy import ndimage

from editanything_tpu_torch.perception.predictor import SamPredictor

Detector = Callable[[np.ndarray, str],
                    Tuple[np.ndarray, np.ndarray, List[str]]]


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """mode "holes" fills holes smaller than area_thresh, "islands" removes
    connected components smaller than it -> (mask, whether it changed)."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode is 'holes' or 'islands', got {mode!r}")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask.astype(bool)).astype(np.uint8)
    regions, n_labels = ndimage.label(working, structure=np.ones((3, 3)))
    sizes = ndimage.sum_labels(working, regions,
                               index=np.arange(1, n_labels + 1))
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask.astype(bool), False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n_labels + 1) if i not in fill]
        if not fill:
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


def prompt2mask(detector: Detector, sam_predictor: SamPredictor,
                image: np.ndarray, text_prompt: str, *,
                score_thresh: float = 0.7, union_score_thresh: float = 0.5,
                max_boxes: Optional[int] = None,
                small_region_area: float = 400.0) -> np.ndarray:
    """Text -> the union of the boxes' SAM masks, (H, W, 3) uint8 in {0,
    255}. SAM encodes the image only when a box passes; a box below
    `union_score_thresh` is skipped."""
    h, w = image.shape[:2]
    boxes, scores, _ = detector(image, text_prompt)
    scores = np.asarray(scores)
    keep = scores >= score_thresh
    boxes, scores = np.asarray(boxes)[keep], scores[keep]
    if max_boxes is not None and len(boxes) > max_boxes:
        order = np.argsort(-scores)[:max_boxes]
        boxes, scores = boxes[order], scores[order]
    final = np.zeros((h, w), bool)
    if len(boxes) > 0:
        sam_predictor.set_image(image)
        for box, score in zip(boxes, scores):
            if score < union_score_thresh:
                continue
            masks, _, _ = sam_predictor.predict(box=box,
                                                multimask_output=False)
            m, _ = remove_small_regions(masks[0], small_region_area,
                                        mode="holes")
            final |= m
    out = final.astype(np.uint8) * 255
    return np.dstack([out, out, out])


class TextGuidedEditPipeline:
    """The region a sentence names, repainted: ``prompt2mask`` with the
    editor's SAM predictor, then ``editor.process`` with that mask (which
    builds its SAM condition map as a brushed edit does)."""

    def __init__(self, editor, detector: Detector, **prompt2mask_kw):
        self.editor = editor
        self.detector = detector
        self.kw = prompt2mask_kw

    def __call__(self, *, image: np.ndarray, mask_prompt: str, prompt: str,
                 **process_kw):
        mask = prompt2mask(self.detector, self.editor.sam_predictor, image,
                           mask_prompt, **self.kw)
        return self.editor.process(image=image, mask=mask[..., 0],
                                   prompt=prompt, **process_kw)
