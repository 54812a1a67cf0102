"""EditAnythingEditor: SAM's automatic masks and click predictor in front
of the dual-ControlNet inpaint edit.

Counterpart of ``editanything_tpu/pipelines/editor.py`` for the main path:
``process`` builds the SAM ID condition map when none is given
(editor.py:358-360) and runs the edit; ``process_image_click`` is the
click-to-segment entry point. Images in and out are numpy HWC uint8. The
SAM resize is torch (``resize_uint8_bilinear``) and ``resize_image`` is
numpy, so no path needs PIL.

``process`` also takes every sampler, DDIM's ``eta``, the per-pixel scale
map of the SAM control (``use_scale_map``, derived from the mask unless
``scale_map`` is given), alpha mixing (``use_alpha_mixing``,
``alpha_weight``, through the "mix" pipeline), reference-only control
(``ref_image``, ``ref_mask``, ``ref_prompt``, ``reference_attn``,
``reference_adain``, ``attention_auto_weight``, ``gn_auto_weight``,
``style_fidelity``, ``ref_scale``, ``ref_sam_scale``,
``ref_inpaint_scale``), tile refinement (``enable_tile``,
``refine_image_resolution``, ``refine_alignment_ratio``, through the
bundle's "tile" ControlNet) and, beyond the JAX editor's arguments,
``encoder_interval``. Not ported yet; set to anything but its default, each
raises ``NotImplementedError`` naming its ROADMAP item: auto prompt,
condition-model swap, the ref image's caption and textual inversion, and
``EA_SAVE_INPUTS`` capture (Queue 1 item 7).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from editanything_tpu_torch.models import sam as SAM
from editanything_tpu_torch.perception.amg import (AMGConfig, _grid_points,
                                                   build_amg, encode_id_map)
from editanything_tpu_torch.perception.predictor import SamPredictor
from editanything_tpu_torch.pipelines.bundle import ModelBundle
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.utils.image import (HWC3, resize_image,
                                                resize_points)

# process() arguments of the JAX editor that are not ported yet: their
# defaults, and the ROADMAP item that ports each
_NOT_PORTED = {
    "enable_auto_prompt": (False, "Queue 1 item 7 (captioner)"),
    "condition_model": (None, "Queue 1 item 7 (ControlNet hot-swap)"),
    "ref_auto_prompt": (False, "Queue 1 item 7 (captioner)"),
    "ref_textinv": (False, "Queue 1 item 7 (textual inversion)"),
    "ref_textinv_path": (None, "Queue 1 item 7 (textual inversion)"),
}


def draw_click_overlay(image: np.ndarray, mask: np.ndarray,
                       points: Sequence[Tuple[int, int, int]],
                       radius: int = 5) -> np.ndarray:
    """Green mask at 0.75 alpha and point discs (green foreground, red
    background), the reference's overlay (editany_lora.py:581-601)."""
    out = image.astype(np.float32).copy()
    m = mask.astype(bool)
    green = np.array([0.0, 255.0, 0.0], np.float32)
    out[m] = 0.25 * out[m] + 0.75 * green
    h, w = out.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    for (x, y, lab) in points:
        disk = (xx - x) ** 2 + (yy - y) ** 2 <= radius ** 2
        out[disk] = green if lab == 1 else np.array([255.0, 0.0, 0.0])
    return out.clip(0, 255).astype(np.uint8)


class EditAnythingEditor:
    """``process``/``process_image_click`` over the port's pipelines."""

    def __init__(self, bundle: ModelBundle, *,
                 sam: Optional[Tuple[SAM.SAMConfig, SAM.Sam]] = None,
                 amg_config: Optional[AMGConfig] = None,
                 extra_inpaint: bool = True, tile_control: str = "tile"):
        self.bundle = bundle
        controls = (("sam", "inpaint") if extra_inpaint
                    and "inpaint" in bundle.controlnets else ("sam",))
        self.pipe = EditPipeline(bundle, controls=controls,
                                 inpaint_mode="blend")
        self.mix_pipe = EditPipeline(bundle, controls=controls,
                                     inpaint_mode="mix")
        # the ControlNet of tile refinement; None: the bundle has none
        self.tile_control = (tile_control if tile_control in bundle.controlnets
                             else None)
        self.sam = sam
        self.amg_cfg = amg_config or AMGConfig()
        if sam is not None:
            sam_cfg, sam_module = sam
            self.sam_predictor = SamPredictor(sam_module, sam_cfg)
            self._amg_encode, self._amg_generate = build_amg(sam_cfg,
                                                             self.amg_cfg)
        self.click_points: List[Tuple[int, int, int]] = []
        # non-finite values in the last edit's images, before the uint8 cast
        self.last_nonfinite = None

    # -- SAM auto condition ----------------------------------------------

    def get_sam_control(self, image: np.ndarray) -> np.ndarray:
        """Automatic masks of the whole image -> uint8 (H, W, 3) R/G ID
        condition map (editany_lora.py:522-525 and show_anns :426-449)."""
        if self.sam is None:
            raise RuntimeError("no SAM weights in this editor")
        sam_cfg, sam = self.sam
        dev = self.sam_predictor.device
        x, (nh, nw) = SAM.prepare_image(image, sam_cfg, dev)
        emb = self._amg_encode(sam, x.to(sam.mask_decoder.iou_token.weight.dtype))
        pts = torch.from_numpy(_grid_points(self.amg_cfg, nh, nw)).to(dev)
        out = self._amg_generate(sam, emb, pts)
        cond = encode_id_map(out["logits"], out["valid"],
                             out_hw=image.shape[:2],
                             mask_threshold=self.amg_cfg.mask_threshold)
        return cond.cpu().numpy()

    # -- interactive click segmentation ------------------------------------

    def process_image_click(self, image: np.ndarray, x: int, y: int,
                            is_foreground: bool = True,
                            detect_resolution: int = 1024):
        """Accumulate click points, predict the mask, return (overlay,
        mask), editany_lora.py:545-607."""
        self.click_points.append((x, y, 1 if is_foreground else 0))
        img = resize_image(HWC3(image.astype(np.uint8)), detect_resolution)
        pts = resize_points(self.click_points, image.shape, detect_resolution)
        self.sam_predictor.set_image(img)
        coords = np.array([[p[0], p[1]] for p in pts], np.float32)
        labels = np.array([p[2] for p in pts], np.int64)
        masks, _, _ = self.sam_predictor.predict(
            point_coords=coords, point_labels=labels, multimask_output=False)
        mask = masks[0]
        overlay = draw_click_overlay(img, mask, pts)
        return overlay, (mask.astype(np.uint8) * 255)

    def clear_clicks(self):
        self.click_points = []

    # -- the main edit -----------------------------------------------------

    def process(self, *, image: np.ndarray, mask: Optional[np.ndarray],
                prompt: str = "", a_prompt: str = "", n_prompt: str = "",
                condition_image: Optional[np.ndarray] = None,
                enable_all_generate: bool = False,
                num_samples: int = 1, image_resolution: int = 512,
                detect_resolution: int = 1024,
                ddim_steps: int = 30, scale: float = 9.0,
                control_scale: float = 0.5, seed: int = 0,
                eta: float = 0.0, sampler: str = "unipc",
                guess_mode: bool = False, use_scale_map: bool = False,
                scale_map: Optional[np.ndarray] = None,
                alpha_weight: float = 0.5, use_alpha_mixing: bool = False,
                alignment_ratio: Optional[float] = None,
                enable_tile: bool = False,
                refine_image_resolution: int = 1024,
                refine_alignment_ratio: float = 0.95,
                encoder_interval: int = 1,
                ref_image: Optional[np.ndarray] = None,
                ref_mask: Optional[np.ndarray] = None,
                ref_prompt: Optional[str] = None,
                reference_attn: bool = True, reference_adain: bool = False,
                attention_auto_weight: float = 1.0,
                gn_auto_weight: float = 1.0, style_fidelity: float = 0.5,
                ref_scale: float = 0.0,
                ref_sam_scale: Optional[float] = None,
                ref_inpaint_scale: Optional[float] = None,
                generator: Optional[torch.Generator] = None, noise=None,
                mix_noise=None, step_noise=None, eta_noise=None,
                tile_noise=None, **not_ported):
        """Returns (results_tile, results, [condition_map, mask], prompt),
        the reference's process() contract (editany_lora.py:609-938).
        `use_scale_map` scales the SAM control per pixel by `scale_map`, or
        when none is given by 1 - the binarised mask (the SAM control off
        inside the edit region); `use_alpha_mixing` runs the "mix" edit.
        The reference-only arguments, `encoder_interval`, `generator` and
        the noises go to ``EditPipeline`` as it takes them. With
        `enable_tile`, and a "tile" ControlNet in the bundle, the results
        go through ``EditPipeline.tile_refine`` at
        `refine_image_resolution` (UniPC, `ddim_steps`, CFG `scale`,
        `refine_alignment_ratio`), its initial latents `tile_noise` ((S,
        H/8, W/8, 4)) or drawn from `generator` (default: seeded with
        `seed`); results_tile is empty otherwise. ``last_nonfinite`` counts
        both passes."""
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"process() got an unexpected argument {name!r}")
            default, item = _NOT_PORTED[name]
            if not (value is default or (isinstance(value, (bool, int, float))
                                         and value == default)):
                raise NotImplementedError(f"{name}={value!r}: not ported yet "
                                          f"(ROADMAP {item})")
        if os.environ.get("EA_SAVE_INPUTS") == "1":
            raise NotImplementedError("EA_SAVE_INPUTS capture: not ported yet "
                                      "(ROADMAP Queue 1 item 7)")
        image = HWC3(np.asarray(image, np.uint8))
        if condition_image is None:
            condition_image = self.get_sam_control(
                resize_image(image, detect_resolution))
        positive = f"{prompt}, {a_prompt}" if a_prompt else prompt
        if enable_all_generate or mask is None:
            mask = np.full(image.shape[:2], 255, np.uint8)
        if use_scale_map and scale_map is None:
            # the SAM control off inside the edit region (editor.py:367-376)
            m01 = np.asarray(mask, np.float32)
            if m01.ndim == 3:
                m01 = m01[..., 0]
            if m01.max() > 1.5:
                m01 = m01 / 255.0
            scale_map = 1.0 - (m01 >= 0.5).astype(np.float32)
        pipe = self.mix_pipe if use_alpha_mixing else self.pipe
        results = pipe(
            image=image, mask=mask, prompt=positive,
            condition_image=condition_image, negative_prompt=n_prompt,
            num_samples=num_samples, image_resolution=image_resolution,
            num_steps=ddim_steps, guidance_scale=scale,
            control_scale=control_scale, sampler=sampler, eta=eta,
            scale_map=scale_map if use_scale_map else None,
            alignment_ratio=alignment_ratio, alpha_weight=alpha_weight,
            guess_mode=guess_mode, seed=seed,
            encoder_interval=encoder_interval, generator=generator,
            noise=noise, mix_noise=mix_noise, step_noise=step_noise,
            eta_noise=eta_noise, ref_image=ref_image, ref_mask=ref_mask,
            ref_prompt=ref_prompt, reference_attn=reference_attn,
            reference_adain=reference_adain,
            attention_auto_weight=attention_auto_weight,
            gn_auto_weight=gn_auto_weight, style_fidelity=style_fidelity,
            ref_scale=ref_scale, ref_sam_scale=ref_sam_scale,
            ref_inpaint_scale=ref_inpaint_scale)
        self.last_nonfinite = pipe.last_nonfinite
        results_tile = []
        if enable_tile and self.tile_control is not None:
            results_tile = self.pipe.tile_refine(
                results, mask, positive, tile_control=self.tile_control,
                negative_prompt=n_prompt,
                refine_image_resolution=refine_image_resolution,
                num_steps=ddim_steps, guidance_scale=scale,
                alignment_ratio=refine_alignment_ratio, seed=seed,
                noise=tile_noise, generator=generator)
            self.last_nonfinite += self.pipe.last_nonfinite
        return (results_tile, [results[i] for i in range(len(results))],
                [condition_image, mask], positive)
