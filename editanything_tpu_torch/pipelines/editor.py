"""EditAnythingEditor: SAM's automatic masks and click predictor and the
BLIP-2 captioner in front of the dual-ControlNet inpaint edit.

Counterpart of ``editanything_tpu/pipelines/editor.py``: ``process`` builds
the SAM ID condition map when none is given (editor.py:358-360) and runs
the edit; ``process_image_click`` is the click-to-segment entry point;
``semantic`` labels the largest SAM regions with the captioner and draws
them (sam2semantic.py). Images in and out are numpy HWC uint8. The SAM
resize is torch (``resize_uint8_bilinear``) and ``resize_image`` is numpy,
so no path needs PIL but ``semantic``'s overlay, which draws its text with
it (``apps/demos.py``).

``process`` also takes every sampler, DDIM's ``eta``, the per-pixel scale
map of the SAM control (``use_scale_map``, derived from the mask unless
``scale_map`` is given), alpha mixing (``use_alpha_mixing``,
``alpha_weight``, through the "mix" pipeline), reference-only control
(``ref_image``, ``ref_mask``, ``ref_prompt``, ``reference_attn``,
``reference_adain``, ``attention_auto_weight``, ``gn_auto_weight``,
``style_fidelity``, ``ref_scale``, ``ref_sam_scale``,
``ref_inpaint_scale``), tile refinement (``enable_tile``,
``refine_image_resolution``, ``refine_alignment_ratio``, through the
bundle's "tile" ControlNet), the condition-model swap
(``condition_model``: a checkpoint path, or a name in
``condition_model_paths``, loaded into the "sam" ControlNet in place),
textual inversion of the reference crop (``ref_textinv`` with
``ref_textinv_path``: the embedding loaded and its placeholder
``textinv_token`` registered, or the crop staged for training), the auto
prompts of an editor built with a captioner (``enable_auto_prompt``: the
image's caption before the prompt; ``ref_auto_prompt``: the masked
reference crop's caption appended to ``ref_prompt`` and ``a_prompt``),
``EA_SAVE_INPUTS=1`` capture and, beyond the JAX editor's arguments,
``encoder_interval`` and the noises. It takes every argument of the JAX
editor's ``process``.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from editanything_tpu_torch.checkpoints.convert import load_torch_state_dict
from editanything_tpu_torch.apps.demos import semantic_overlay
from editanything_tpu_torch.checkpoints.lora import (append_textual_inversion,
                                                     load_ti_file)
from editanything_tpu_torch.models import sam as SAM
from editanything_tpu_torch.perception.amg import (AMGConfig, _grid_points,
                                                   build_amg, encode_id_map)
from editanything_tpu_torch.perception.predictor import SamPredictor
from editanything_tpu_torch.pipelines.bundle import ModelBundle
from editanything_tpu_torch.pipelines.captioner import semantic_labels
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.utils import trace
from editanything_tpu_torch.utils.image import (HWC3, resize_bilinear,
                                                resize_image, resize_points,
                                                write_png)


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
    """``process``/``process_image_click``/``semantic`` over the port's
    pipelines; `captioner` is a ``pipelines.captioner.Captioner`` or None
    (no auto prompts: they caption nothing)."""

    def __init__(self, bundle: ModelBundle, *,
                 sam: Optional[Tuple[SAM.SAMConfig, SAM.Sam]] = None,
                 captioner=None, amg_config: Optional[AMGConfig] = None,
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
        self.captioner = captioner
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
        # textual inversion: where the ref crop is staged for training, and
        # the placeholder a loaded embedding registers
        self.textinv_stage_dir = "./utils/tmp/textinv/img"
        self.textinv_token = "<new-obj>"
        # the "sam" ControlNet's checkpoint; "EditAnything" is the
        # reference's name for the one the bundle was built with
        self.current_condition_model = "EditAnything"
        # name -> checkpoint path, for names that are not paths
        self.condition_model_paths: dict = {}

    def set_condition_model(self, name_or_path: Optional[str]) -> bool:
        """Load another checkpoint into the "sam" ControlNet in place (the
        reference rebuilds its pipeline, editany_lora.py:677-693). Returns
        whether it swapped: None, "" and the current name keep it, and so
        does, with a warning, a name that is neither a file nor in
        ``condition_model_paths`` (nothing is fetched)."""
        if name_or_path in (None, "", self.current_condition_model):
            return False
        path = self.condition_model_paths.get(name_or_path, name_or_path)
        if not os.path.exists(path):
            warnings.warn(
                f"condition model {name_or_path!r} is not a local path and "
                "has no entry in editor.condition_model_paths; keeping "
                f"{self.current_condition_model!r} (nothing is downloaded)")
            return False
        net = self.bundle.controlnets["sam"][1]
        w = net.conv_in.weight
        self.bundle.swap_controlnet("sam", load_torch_state_dict(
            path, device=w.device, dtype=w.dtype))
        self.current_condition_model = name_or_path
        return True

    # -- captioning --------------------------------------------------------

    def get_blip2_text(self, image: np.ndarray) -> str:
        """The captioner's caption of one uint8 image; "" without a
        captioner (editany_lora.py:512-520)."""
        if self.captioner is None:
            return ""
        return self.captioner(image[None])[0]

    # -- SAM auto condition ----------------------------------------------

    def _amg(self, image: np.ndarray) -> dict:
        """The AMG's output slots for a uint8 image."""
        if self.sam is None:
            raise RuntimeError("no SAM weights in this editor")
        sam_cfg, sam = self.sam
        dev = self.sam_predictor.device
        x, (nh, nw) = SAM.prepare_image(image, sam_cfg, dev)
        emb = self._amg_encode(sam, x.to(sam.mask_decoder.iou_token.weight.dtype))
        trace.count("sync.amg.points")
        pts = torch.from_numpy(_grid_points(self.amg_cfg, nh, nw)).to(dev)
        return self._amg_generate(sam, emb, pts)

    def get_sam_control(self, image: np.ndarray) -> np.ndarray:
        """Automatic masks of the whole image -> uint8 (H, W, 3) R/G ID
        condition map (editany_lora.py:522-525 and show_anns :426-449)."""
        with trace.span("editor.sam"):
            out = self._amg(image)
            with trace.span("amg.id_map"):
                cond = encode_id_map(
                    out["logits"], out["valid"], out_hw=image.shape[:2],
                    mask_threshold=self.amg_cfg.mask_threshold)
                return trace.host_read(cond, "editor.id_map").numpy()

    # -- region-level semantics (sam2semantic.py) --------------------------

    def semantic(self, image: np.ndarray, *, top_k: int = 10,
                 detect_resolution: int = 1024):
        """Region labels and their overlay (sam2semantic.py:73-146): the
        AMG's top_k largest masks, upscaled to the image with
        jax.image.resize "bilinear" semantics, each region's crop captioned
        (one captioner call) and drawn. Returns ([(AMG slot, label)], uint8
        (H, W, 3) overlay); the overlay needs PIL."""
        if self.sam is None or self.captioner is None:
            raise RuntimeError("semantic needs SAM weights and a captioner")
        img = resize_image(HWC3(image.astype(np.uint8)), detect_resolution)
        order, up, valid = self.top_regions(img, top_k)
        masks_hr = up > self.amg_cfg.mask_threshold
        labels_local = semantic_labels(
            img, masks_hr, valid, masks_hr.reshape(len(order), -1).sum(-1),
            self.captioner, top_k=top_k)
        labels = [(int(order[i]), lab) for i, lab in labels_local]
        overlay = semantic_overlay(img, up, valid, labels_local,
                                   mask_threshold=self.amg_cfg.mask_threshold)
        return labels, overlay

    def top_regions(self, image: np.ndarray, top_k: int):
        """The AMG's top_k largest masks of a uint8 image: (their slots,
        their logits (k, H, W) upscaled to the image as jax.image.resize
        "bilinear" does, their valid flags). Only these go to image
        resolution: all slots would be hundreds of MB at 1024^2."""
        out = self._amg(image)
        valid = trace.host_read(out["valid"], "editor.regions").numpy()
        # int32 as the JAX package's, so that argsort breaks ties alike
        areas = trace.host_read(out["areas"],
                                "editor.regions").numpy().astype(np.int32)
        order = np.argsort(-np.where(valid, areas, -1))[:top_k]
        logits = trace.host_read(out["logits"].float(),
                                 "editor.regions")[torch.from_numpy(order)]
        up = resize_bilinear(logits[:, None], image.shape[:2])[:, 0].numpy()
        return order, up, valid[order]

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

    # -- the reference crop and textual inversion ------------------------

    @staticmethod
    def _crop_masked_region(ref_image: np.ndarray,
                            ref_mask: Optional[np.ndarray]) -> np.ndarray:
        """The bounding box of the masked ref region, pixels outside the
        mask zeroed (editany_lora.py:708-722)."""
        img = HWC3(np.asarray(ref_image, np.uint8))
        if ref_mask is None:
            return img
        m = np.asarray(ref_mask, np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        if m.max() > 1.5:
            m = m / 255.0
        ys, xs = np.nonzero(m >= 0.5)
        if len(ys) == 0:
            return img
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        crop = img[y0:y1, x0:x1].astype(np.float32)
        crop *= m[y0:y1, x0:x1, None]
        return crop.astype(np.uint8)

    def _load_or_stage_textinv(self, crop: np.ndarray,
                               path: Optional[str]) -> bool:
        """Append the TI embedding at `path` to the text tower's table and
        register ``textinv_token`` for its rows; without a file there,
        stage the ref crop as ``ref.png`` for TI training
        (editany_lora.py:732-745). Returns whether it loaded."""
        if path and os.path.exists(path):
            ids = append_textual_inversion(self.bundle.text, load_ti_file(path))
            self.bundle.tokenizer.add_placeholder(self.textinv_token, ids)
            return True
        os.makedirs(self.textinv_stage_dir, exist_ok=True)
        write_png(os.path.join(self.textinv_stage_dir, "ref.png"), crop)
        print(f"No textual-inversion embedding found; staged the ref crop "
              f"in {self.textinv_stage_dir} — train with "
              f"`train_staged_textinv` or `python -m "
              f"editanything_tpu_torch.train.train_ti --train-data-dir "
              f"{self.textinv_stage_dir}` (editany_lora.py:737-745)")
        return False

    def train_staged_textinv(self, output_path: str, *,
                             max_steps: int = 3000, num_vectors: int = 10,
                             batch_size: int = 4, resolution: int = 512,
                             lr: float = 5e-4, seed: int = 0,
                             **kwargs) -> str:
        """Textual inversion on the staged reference crop(s), learned into
        this editor's bundle (the reference's run_texutal_inversion.sh flow,
        callable; JAX editor.py:268-285). Returns `output_path`; a later
        ``process(ref_textinv=True, ref_textinv_path=output_path)``, or a
        prompt with ``textinv_token``, uses the embedding. `kwargs` go to
        ``train.train_ti.train_textual_inversion``."""
        from editanything_tpu_torch.train.train_ti import \
            train_textual_inversion
        train_textual_inversion(
            data_dir=self.textinv_stage_dir, output_path=output_path,
            bundle=self.bundle, placeholder_token=self.textinv_token,
            max_steps=max_steps, num_vectors=num_vectors,
            batch_size=batch_size, resolution=resolution, lr=lr, seed=seed,
            **kwargs)
        return output_path

    # -- the main edit -----------------------------------------------------

    def process(self, *, image: np.ndarray, mask: Optional[np.ndarray],
                prompt: str = "", a_prompt: str = "", n_prompt: str = "",
                condition_image: Optional[np.ndarray] = None,
                enable_auto_prompt: bool = False,
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
                ref_auto_prompt: bool = False,
                reference_attn: bool = True, reference_adain: bool = False,
                attention_auto_weight: float = 1.0,
                gn_auto_weight: float = 1.0, style_fidelity: float = 0.5,
                ref_scale: float = 0.0,
                ref_sam_scale: Optional[float] = None,
                ref_inpaint_scale: Optional[float] = None,
                condition_model: Optional[str] = None,
                ref_textinv: bool = False,
                ref_textinv_path: Optional[str] = None,
                generator: Optional[torch.Generator] = None, noise=None,
                mix_noise=None, step_noise=None, eta_noise=None,
                tile_noise=None):
        """Returns (results_tile, results, [condition_map, mask], prompt),
        the reference's process() contract (editany_lora.py:609-938).
        `use_scale_map` scales the SAM control per pixel by `scale_map`, or
        when none is given by 1 - the binarised mask (the SAM control off
        inside the edit region); `use_alpha_mixing` runs the "mix" edit.
        The reference-only arguments, `encoder_interval`, `generator` and
        the noises go to ``EditPipeline`` as it takes them.
        `condition_model` swaps the "sam" ControlNet first
        (``set_condition_model``). With a captioner, `enable_auto_prompt`
        puts the caption of the image (resized to min(detect_resolution,
        512)) before `prompt`, and with `ref_image`, `ref_auto_prompt`
        appends the masked crop's caption to `ref_prompt` and `a_prompt`;
        with `ref_image`, `ref_textinv` loads the embedding at
        `ref_textinv_path` or stages the masked crop. With
        `enable_tile`, and a "tile" ControlNet in the bundle, the results
        go through ``EditPipeline.tile_refine`` at
        `refine_image_resolution` (UniPC, `ddim_steps`, CFG `scale`,
        `refine_alignment_ratio`), its initial latents `tile_noise` ((S,
        H/8, W/8, 4)) or drawn from `generator` (default: seeded with
        `seed`); results_tile is empty otherwise. ``last_nonfinite`` counts
        both passes."""
        with trace.span("editor.process"):
            if condition_model is not None:
                self.set_condition_model(condition_model)
            if os.environ.get("EA_SAVE_INPUTS") == "1":
                # the reference's pickle-replay capture
                # (annotator/util.py:77-95)
                with open("input_data.pkl", "wb") as f:
                    pickle.dump({"args": (), "kwargs": dict(
                        image=image, mask=mask, prompt=prompt,
                        a_prompt=a_prompt, n_prompt=n_prompt,
                        condition_image=condition_image,
                        num_samples=num_samples,
                        image_resolution=image_resolution,
                        ddim_steps=ddim_steps, scale=scale,
                        control_scale=control_scale, seed=seed)}, f)
            image = HWC3(np.asarray(image, np.uint8))
            if enable_auto_prompt and self.captioner is not None:
                caption = self.get_blip2_text(
                    resize_image(image, min(detect_resolution, 512)))
                prompt = f"{caption}, {prompt}" if prompt else caption
            if ref_image is not None and (ref_auto_prompt or ref_textinv):
                crop = self._crop_masked_region(ref_image, ref_mask)
                if ref_auto_prompt and self.captioner is not None:
                    caption = self.get_blip2_text(crop)
                    ref_prompt = (ref_prompt or "") + caption
                    a_prompt = a_prompt + caption
                if ref_textinv:
                    self._load_or_stage_textinv(crop, ref_textinv_path)
            if condition_image is None:
                condition_image = self.get_sam_control(
                    resize_image(image, detect_resolution))
            positive = f"{prompt}, {a_prompt}" if a_prompt else prompt
            if enable_all_generate or mask is None:
                mask = np.full(image.shape[:2], 255, np.uint8)
            if use_scale_map and scale_map is None:
                # the SAM control off inside the edit region
                # (editor.py:367-376)
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
