"""The main edit pipeline: inpainting with [SAM control, inpaint control].

Counterpart of ``editanything_tpu/pipelines/edit.py``
(``make_inpaint_condition``; ``EditPipeline.__call__``, :105-278) in every
inpaint mode ("none", "blend", "mix", and "unet9" with the 9-channel UNet),
with every sampler of engine/denoise.py (DDIM with eta), per-pixel scale
maps on the SAM control, guess mode, encoder caching and reference-only
control (``ref_image`` and its arguments, the write pass re-noising the
reference latents with the initial noise each step). Images in and out are
the JAX package's numpy HWC uint8. The random draws can be handed in or
come from explicit generators: the initial
latents (``noise``, and for "mix" the noise that re-noises the original
before the loop, ``mix_noise``, both in the JAX package's (B, h, w, 4)
layout) or ``generator``; the per-step noises of "mix" and of DDIM's eta
(``step_noise``, ``eta_noise``, (steps, B, 4, h, w)) or generators seeded
with seed + 1 and seed + 2. ``tile_refine`` (:282-350) is the second pass
at the refine resolution, its initial latents handed in or drawn the same
way; above ``vae_oneshot_max_px`` its encode and decode run tiled.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from editanything_tpu_torch.engine import prompts as P
from editanything_tpu_torch.engine.denoise import DenoiseConfig, build_denoiser
from editanything_tpu_torch.engine.refctrl import RefConfig
from editanything_tpu_torch.pipelines.bundle import ModelBundle
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.samplers.schedule import add_noise, make_timesteps
from editanything_tpu_torch.utils import trace
from editanything_tpu_torch.utils.image import (HWC3, resize_bilinear,
                                                resize_image, resize_nearest)


def make_inpaint_condition(image_01: np.ndarray,
                           mask: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0,1] + (H, W) mask -> inpaint-ControlNet condition:
    masked pixels set to -1."""
    cond = np.array(image_01, np.float32, copy=True)
    cond[mask > 0.5] = -1.0
    return cond


class EditPipeline(GenerationPipeline):
    """Inpainting edit; the LAST of `controls` receives the masked-pixel
    condition at scale 1.0, the first the condition map at control_scale."""

    def __init__(self, bundle: ModelBundle,
                 controls: Sequence[str] = ("sam", "inpaint"),
                 inpaint_mode: str = "blend", group=None, mesh=None):
        super().__init__(bundle, controlnet=controls[0], group=group,
                         mesh=mesh)
        self.controls = tuple(controls)
        self.inpaint_mode = inpaint_mode

    @staticmethod
    def _norm_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
        """Any mask (HxW / HxWxC, 0-1 or 0-255) -> binary (h, w) float mask
        at the target resolution (nearest, >= 0.5)."""
        m = np.asarray(mask, np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        if m.max() > 1.5:
            m = m / 255.0
        m = resize_nearest(torch.from_numpy(np.ascontiguousarray(m))[None, None],
                           (h, w))[0, 0].numpy()
        return (m >= 0.5).astype(np.float32)

    def _prep(self, image: np.ndarray, mask: np.ndarray, image_resolution: int):
        img = resize_image(HWC3(image.astype(np.uint8)), image_resolution)
        h, w = img.shape[:2]
        return img, self._norm_mask(mask, h, w), h, w

    def _latent_inputs(self, img_uint8, mask_hw, h, w, num_samples):
        """VAE-encode the masked image (H, W, 3), or images (S, H, W, 3);
        the mask at latent resolution, both over `num_samples`."""
        b = self.bundle
        img01 = img_uint8.astype(np.float32) / 255.0
        masked = img01 * (mask_hw[..., None] < 0.5) * 2.0 - 1.0
        x = torch.from_numpy(masked.reshape((-1,) + masked.shape[-3:]))
        # the masked images' and the mask's copies to the device
        trace.count("sync.edit.latent_inputs", 2)
        lat = self._encode(x.permute(0, 3, 1, 2).to(b.device, b.dtype)).float()
        lat = lat.expand(num_samples, -1, -1, -1)
        mlat = resize_nearest(torch.from_numpy(mask_hw)[None, None],
                              (h // 8, w // 8))
        mlat = mlat.expand(num_samples, -1, -1, -1).to(b.device)
        return lat, mlat

    def _reference_inputs(self, ref_image, ref_mask, ref_prompt: str, h: int,
                          w: int, image_resolution: int, num_samples: int,
                          conds, scales, ref_sam_scale, ref_inpaint_scale):
        """The write pass's inputs: the reference image resized to the
        edit's size and VAE-encoded; its mask at latent size (>= 0.5); the
        reference prompt's cond-only context; the main conditions with the
        last replaced by the reference image; and the write pass's scales
        where either is given (the main scales otherwise)."""
        if ref_mask is None:
            raise ValueError("ref_image needs ref_mask (the reference region)")
        b = self.bundle
        rimg = resize_image(HWC3(ref_image.astype(np.uint8)), image_resolution)
        rimg = torch.from_numpy(rimg.astype(np.float32)).permute(2, 0, 1)[None]
        rimg = resize_bilinear(rimg, (h, w))
        rlat = self._encode((rimg / 127.5 - 1.0).to(b.device, b.dtype))
        rm = np.asarray(ref_mask, np.float32)
        if rm.ndim == 3:
            rm = rm[..., 0]
        if rm.max() > 1.5:
            rm = rm / 255.0
        rm = resize_nearest(torch.from_numpy(np.ascontiguousarray(rm))[None, None],
                            (h // 8, w // 8))
        ref_ctx, _ = P.get_pipeline_embeds(b.text, b.tokenizer, ref_prompt, "")
        ref_conds = [c[:num_samples] for c in conds]
        ref_conds[-1] = (rimg / 255.0).expand(num_samples, -1, -1, -1).to(
            b.device, b.dtype)
        inputs = {
            "ref_image_latents": rlat.float().expand(num_samples, -1, -1, -1),
            "ref_mask": (rm >= 0.5).float().to(b.device),
            "ref_context": ref_ctx.expand(num_samples, -1, -1).to(b.dtype),
            "ref_controlnet_conds": ref_conds,
        }
        if ref_sam_scale is not None or ref_inpaint_scale is not None:
            rs = [float(ref_sam_scale if ref_sam_scale is not None
                        else scales[0])]
            if len(self.controls) > 1:
                rs.append(float(ref_inpaint_scale
                                if ref_inpaint_scale is not None
                                else scales[-1]))
            inputs["ref_controlnet_scales"] = rs
        return inputs

    @torch.inference_mode()
    def __call__(self, *, image: np.ndarray, mask: np.ndarray, prompt: str,
                 condition_image: np.ndarray, negative_prompt: str = "",
                 num_samples: int = 1, image_resolution: int = 512,
                 num_steps: int = 30, guidance_scale: float = 9.0,
                 control_scale: float = 0.5,
                 scale_map: Optional[np.ndarray] = None,
                 alignment_ratio: Optional[float] = None,
                 alpha_weight: float = 0.5,
                 guess_mode: bool = False, sampler: str = "unipc",
                 eta: float = 0.0, seed: int = 0, encoder_interval: int = 1,
                 return_latents: bool = False,
                 generator: Optional[torch.Generator] = None,
                 noise=None, mix_noise=None, step_noise=None,
                 eta_noise=None, ref_image: Optional[np.ndarray] = None,
                 ref_mask: Optional[np.ndarray] = None,
                 ref_prompt: Optional[str] = None,
                 reference_attn: bool = True, reference_adain: bool = False,
                 attention_auto_weight: float = 1.0,
                 gn_auto_weight: float = 1.0, style_fidelity: float = 0.5,
                 ref_scale: float = 0.0,
                 ref_sam_scale: Optional[float] = None,
                 ref_inpaint_scale: Optional[float] = None) -> np.ndarray:
        """Returns (num_samples, H, W, 3) uint8 edited images, or with
        return_latents the final (num_samples, H/8, W/8, 4) fp32 latents.

        The initial latents are `noise` when given ((num_samples, H/8, W/8,
        4), the JAX package's layout), else drawn from `generator` (on the
        bundle's device; default: seeded with `seed`), which also draws
        `mix_noise` when "mix" needs it and it is not given. `scale_map`
        (Hm, Wm) scales the SAM control per pixel. `eta` counts for DDIM
        only. `encoder_interval` k > 1 runs the encoder half of the model
        every k-th step only (UniPC and DDIM; approximate), and is 1 under
        reference control.

        `ref_image` with `ref_mask` (its region, HxW 0-1 or 0-255) turns on
        reference-only control: `reference_attn` / `reference_adain` the
        attention and AdaIN hooks (each at blocks whose weight is below
        `attention_auto_weight` / at most `gn_auto_weight`),
        `style_fidelity` how far the uncond rows keep their own features,
        `ref_scale` the FFT magnitude mix, `ref_prompt` the write pass's
        prompt (default: `prompt`), `ref_sam_scale` / `ref_inpaint_scale`
        its ControlNet scales (default: the main ones)."""
        b = self.bundle
        device = b.device
        schedule = b.noise_schedule()
        img, m, h, w = self._prep(image, mask, image_resolution)
        ref_cfg = None
        if ref_image is not None:
            ref_cfg = RefConfig(
                reference_attn=reference_attn, reference_adain=reference_adain,
                attention_auto_weight=attention_auto_weight,
                gn_auto_weight=gn_auto_weight, style_fidelity=style_fidelity,
                ref_scale=ref_scale, do_cfg=True)
        dcfg = DenoiseConfig(
            unet=b.unet_cfg, controlnets=b.controlnet_cfgs(self.controls),
            num_steps=num_steps, sampler=sampler, guess_mode=guess_mode,
            eta=float(eta) if sampler == "ddim" else 0.0,
            inpaint_mode=self.inpaint_mode, alignment_ratio=alignment_ratio,
            alpha_weight=alpha_weight, ref=ref_cfg,
            encoder_interval=encoder_interval if ref_cfg is None else 1)
        ts = make_timesteps(num_steps, spacing=dcfg.timestep_spacing)
        denoise = build_denoiser(dcfg, schedule, ts)

        context = self.embed_prompts(prompt, negative_prompt, num_samples)
        with trace.span("edit.prepare"):
            # control conditions: SAM map first, inpaint condition last
            conds = [self.prepare_condition(condition_image, h, w,
                                            num_samples)]
            scales = [float(control_scale)]
            if len(self.controls) > 1:
                inp = make_inpaint_condition(img.astype(np.float32) / 255.0,
                                             m)
                inp = torch.from_numpy(inp).permute(2, 0, 1)[None]
                trace.count("sync.edit.inpaint_condition")
                conds.append(inp.expand(num_samples, -1, -1, -1)
                             .to(device, b.dtype))
                scales.append(1.0)

            image_latents, mask_latents = self._latent_inputs(img, m, h, w,
                                                              num_samples)
            shape = image_latents.shape
            if generator is None:
                generator = torch.Generator(device).manual_seed(seed)
            latents = self.initial_latents(shape, noise=noise,
                                           generator=generator)

        # the same tensor re-noises the original in blend mode
        inputs = {
            "controlnet_conds": conds,
            "controlnet_scales": scales,
            "guidance_scale": float(guidance_scale),
            "mask": mask_latents.float(),
            "image_latents": image_latents,
            "noise": latents,
        }
        if self.inpaint_mode == "unet9":
            inputs["masked_image_latents"] = image_latents
        if self.inpaint_mode == "mix":
            inputs["step_noise"] = self.per_step_noise(
                shape, num_steps, noise=step_noise, seed=seed + 1)
        if dcfg.eta > 0.0:
            inputs["eta_noise"] = self.per_step_noise(
                shape, num_steps, noise=eta_noise, seed=seed + 2)
        if scale_map is not None:
            # the per-pixel map applies to the first (SAM) control only
            inputs["controlnet_scale_maps"] = [
                self.prepare_scale_map(scale_map, h, w, num_samples)
            ] + [None] * (len(conds) - 1)
        if ref_cfg is not None:
            inputs.update(self._reference_inputs(
                ref_image, ref_mask, prompt if ref_prompt is None else ref_prompt,
                h, w, image_resolution, num_samples, conds, scales,
                ref_sam_scale, ref_inpaint_scale))
        if self.inpaint_mode == "mix":
            # outside the mask the loop starts from the re-noised original
            renoised = add_noise(schedule, image_latents, self.initial_latents(
                shape, noise=mix_noise, generator=generator), int(ts[0]))
            latents = (1.0 - mask_latents) * renoised + mask_latents * latents

        params = {"unet": b.unet,
                  "controlnets": b.controlnet_modules(self.controls)}
        out = self.run_denoise(denoise, params, latents.to(b.dtype), context,
                               inputs)
        return self.finish(out, return_latents)

    # -- tile refinement ---------------------------------------------------

    @torch.inference_mode()
    def tile_refine(self, images_uint8, mask: np.ndarray, prompt: str, *,
                    tile_control: str = "tile", negative_prompt: str = "",
                    refine_image_resolution: int = 1024, num_steps: int = 30,
                    guidance_scale: float = 9.0,
                    alignment_ratio: float = 0.95, sampler: str = "unipc",
                    seed: int = 0, noise=None,
                    generator: Optional[torch.Generator] = None
                    ) -> List[np.ndarray]:
        """Second diffusion pass at `refine_image_resolution`
        (editany_lora.py:886-936), all samples as one batch: each image
        upscaled (``resize_image``: LANCZOS) is its own tile-ControlNet
        condition in [0, 1] at scale 1.0, and its masked pixels' latents
        blend in while the step is below `alignment_ratio`. Returns one
        (H, W, 3) uint8 image per sample. The initial latents are `noise`
        ((S, H/8, W/8, 4), the JAX package's layout) when given, else drawn
        from `generator` (default: seeded with `seed`)."""
        b = self.bundle
        device = b.device
        imgs = np.stack([resize_image(HWC3(np.asarray(im).astype(np.uint8)),
                                      refine_image_resolution)
                         for im in images_uint8])
        s, h, w = imgs.shape[:3]
        m = self._norm_mask(mask, h, w)
        dcfg = DenoiseConfig(
            unet=b.unet_cfg, controlnets=b.controlnet_cfgs((tile_control,)),
            num_steps=num_steps, sampler=sampler, inpaint_mode="blend",
            alignment_ratio=alignment_ratio)
        denoise = build_denoiser(
            dcfg, b.noise_schedule(),
            make_timesteps(num_steps, spacing=dcfg.timestep_spacing))
        context = self.embed_prompts(prompt, negative_prompt, s)
        cond = torch.from_numpy(imgs.astype(np.float32) / 255.0)
        cond = cond.permute(0, 3, 1, 2).to(device, b.dtype)
        image_latents, mask_latents = self._latent_inputs(imgs, m, h, w, s)
        latents = self.initial_latents(image_latents.shape, noise=noise,
                                       generator=generator, seed=seed)
        inputs = {
            "controlnet_conds": [cond],
            "controlnet_scales": [1.0],
            "guidance_scale": float(guidance_scale),
            "mask": mask_latents.float(),
            "image_latents": image_latents,
            "noise": latents,
        }
        params = {"unet": b.unet,
                  "controlnets": b.controlnet_modules((tile_control,))}
        out = self.finish(self.run_denoise(denoise, params, latents.to(b.dtype),
                                           context, inputs))
        return [out[i] for i in range(s)]
