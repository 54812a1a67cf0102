"""The demo presets, the combined editors and the semantic-label overlay.

Counterpart of ``editanything_tpu/apps/demos.py``: ``CONFIG_DICT``, the
four released EditAnything ControlNets by name (editany_lora.py:72-79);
``DEMO_PRESETS``, the beauty and handsome demos' base model, LoRA and
example prompts (editany_beauty.py, editany_handsome.py);
``build_combined_editors``, app.py:15-76's editors sharing one SAM and one
captioner; and ``show_semantic_image_label`` / ``semantic_overlay``,
``EditAnythingEditor.semantic``'s drawing (sam2semantic.py:100-146:
random-colour region fills and centred, wrapped labels, drawn with PIL
where the reference uses cv2). The overlay is the port's one use of PIL
outside the trainers' JPEGs, imported where the text is drawn: without PIL
it raises ``ImportError``.
"""

from __future__ import annotations

import textwrap
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from editanything_tpu_torch.utils.image import resize_bilinear


# Named ControlNet checkpoints (editany_lora.py:72-79): Hugging Face repo
# ids. Nothing is fetched: a name resolves to a local file through the
# editor's ``condition_model_paths`` or the bundle spec.
CONFIG_DICT = OrderedDict([
    ("LAION Pretrained(v0-4)-SD15", "shgao/edit-anything-v0-4-sd15"),
    ("LAION Pretrained(v0-4)-SD21", "shgao/edit-anything-v0-4-sd21"),
    ("LAION Pretrained(v0-3)-SD21", "shgao/edit-anything-v0-3"),
    ("SAM Pretrained(v0-1)-SD21", "shgao/edit-anything-v0-1-1"),
])

# The demo presets: base model, LoRA (file, multiplier) and short example
# prompts in place of the reference's long lists
DEMO_PRESETS = {
    "beauty": {
        "base_model": "chilloutmix_NiPrunedFp32Fix",
        "lora": ("cuteGirlMix4_v10.safetensors", 0.5),
        "examples": [
            ("1girl, beautiful face, solo, brown hair, best quality, "
             "masterpiece, photorealistic", 5),
            ("ultra high res, photorealistic, detailed beautiful girl, "
             "looking at viewer, smile", 8),
        ],
    },
    "handsome": {
        "base_model": "Realistic_Vision_V2.0",
        "lora": None,
        "examples": [
            ("1boy, handsome face, suit, best quality, masterpiece, "
             "photorealistic", 5),
        ],
    },
}


def build_combined_editors(bundles: Dict[str, "ModelBundle"], *, sam=None,
                           captioner=None,
                           lora_specs: Dict[str, Sequence] = None,
                           **editor_kw) -> "OrderedDict":
    """The combined app's editors (app.py:15-76): one
    ``EditAnythingEditor`` per named tab ("Edit Anything", "Beauty", ...),
    all sharing one SAM (`sam`, (config, module)) and one captioner, as the
    reference builds both once for every tab. `lora_specs` {tab: [(state
    dict or path, multiplier), ...]} merges kohya LoRAs into that tab's
    bundle in place (the Beauty tab's cuteGirlMix4 at 0.5, app.py:41-52).
    ``apps/ui.py::create_combined_app`` lays them out."""
    from editanything_tpu_torch.checkpoints.convert import \
        load_torch_state_dict
    from editanything_tpu_torch.checkpoints.lora import merge_kohya_lora
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor

    editors = OrderedDict()
    for name, bundle in bundles.items():
        for spec in (lora_specs or {}).get(name, ()):
            sd, mult = spec if isinstance(spec, (tuple, list)) else (spec, 1.0)
            if isinstance(sd, str):
                sd = load_torch_state_dict(sd)
            merge_kohya_lora({"unet": bundle.unet,
                              "text_encoder": bundle.text}, sd,
                             multiplier=float(mult))
        editors[name] = EditAnythingEditor(bundle, sam=sam,
                                           captioner=captioner, **editor_kw)
    return editors


def show_semantic_image_label(image_hw: Tuple[int, int],
                              regions: Sequence[Tuple[np.ndarray, str]],
                              seed: int = 0) -> np.ndarray:
    """[(mask (H, W) bool, label)] -> (H, W, 3) uint8 overlay: each region
    filled with a random colour, its label wrapped at 20 characters and
    centred on the region's mean pixel, in another random colour."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("the semantic overlay draws its labels with PIL "
                          "(Pillow), which is not installed") from e
    rng = np.random.RandomState(seed)
    h, w = image_hw
    full = np.zeros((h, w, 3), np.float32)
    for mask, _ in regions:
        full[np.asarray(mask) != 0] = rng.random(3)
    img = Image.fromarray((full * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for mask, label in regions:
        ys, xs = np.nonzero(np.asarray(mask))
        if len(ys) == 0:
            continue
        cx, cy = int(xs.mean()), int(ys.mean())
        lines = textwrap.wrap(label, width=20)
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        spacing = 14
        y0 = cy - (len(lines) - 1) * spacing // 2
        for i, line in enumerate(lines):
            tw = draw.textlength(line)
            draw.text((cx - tw / 2, y0 + i * spacing - 6), line, fill=color)
    return np.asarray(img)


def semantic_overlay(image: np.ndarray, masks: np.ndarray,
                     valid: np.ndarray, labels: List[Tuple[int, str]], *,
                     mask_threshold: float = 0.0, seed: int = 0) -> np.ndarray:
    """Mask logits (N, h, w) and (index, label) pairs -> the overlay at the
    image's size, each valid labelled mask resized with jax.image.resize
    "bilinear" semantics and thresholded."""
    h, w = image.shape[:2]
    regions = []
    for idx, label in labels:
        if not valid[idx]:
            continue
        m = torch.from_numpy(np.asarray(masks[idx], np.float32))
        up = resize_bilinear(m[None, None], (h, w))[0, 0].numpy()
        regions.append((up > mask_threshold, label))
    return show_semantic_image_label((h, w), regions, seed=seed)
