"""The main edit pipeline: inpainting with [SAM control, inpaint control].

Counterpart of ``editanything_tpu/pipelines/edit.py``
(``make_inpaint_condition``; ``EditPipeline.__call__``, :105-278) in every
inpaint mode ("none", "blend", "mix", and "unet9" with the 9-channel UNet),
with UniPC or DDIM (with eta), per-pixel scale maps on the SAM control and
guess mode. Images in and out are the JAX package's numpy HWC uint8. The
random draws can be handed in or come from explicit generators: the initial
latents (``noise``, and for "mix" the noise that re-noises the original
before the loop, ``mix_noise``, both in the JAX package's (B, h, w, 4)
layout) or ``generator``; the per-step noises of "mix" and of DDIM's eta
(``step_noise``, ``eta_noise``, (steps, B, 4, h, w)) or generators seeded
with seed + 1 and seed + 2. Not ported yet: reference-only control (ROADMAP
Queue 1 item 4) and tile refinement (item 5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from editanything_tpu_torch.engine.denoise import DenoiseConfig, build_denoiser
from editanything_tpu_torch.pipelines.bundle import ModelBundle
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.samplers.schedule import add_noise, make_timesteps
from editanything_tpu_torch.utils.image import HWC3, resize_image, resize_nearest


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
                 inpaint_mode: str = "blend"):
        super().__init__(bundle, controlnet=controls[0])
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
        """VAE-encode the masked image; the mask at latent resolution."""
        b = self.bundle
        img01 = img_uint8.astype(np.float32) / 255.0
        masked = img01 * (mask_hw[..., None] < 0.5) * 2.0 - 1.0
        x = torch.from_numpy(masked).permute(2, 0, 1)[None]
        lat = self._encode(x.to(b.device, b.dtype)).float()
        lat = lat.expand(num_samples, -1, -1, -1)
        mlat = resize_nearest(torch.from_numpy(mask_hw)[None, None],
                              (h // 8, w // 8))
        mlat = mlat.expand(num_samples, -1, -1, -1).to(b.device)
        return lat, mlat

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
                 eta_noise=None) -> np.ndarray:
        """Returns (num_samples, H, W, 3) uint8 edited images, or with
        return_latents the final (num_samples, H/8, W/8, 4) fp32 latents.

        The initial latents are `noise` when given ((num_samples, H/8, W/8,
        4), the JAX package's layout), else drawn from `generator` (on the
        bundle's device; default: seeded with `seed`), which also draws
        `mix_noise` when "mix" needs it and it is not given. `scale_map`
        (Hm, Wm) scales the SAM control per pixel. `eta` counts for DDIM
        only."""
        b = self.bundle
        device = b.device
        schedule = b.noise_schedule()
        img, m, h, w = self._prep(image, mask, image_resolution)
        dcfg = DenoiseConfig(
            unet=b.unet_cfg, controlnets=b.controlnet_cfgs(self.controls),
            num_steps=num_steps, sampler=sampler, guess_mode=guess_mode,
            eta=float(eta) if sampler == "ddim" else 0.0,
            inpaint_mode=self.inpaint_mode, alignment_ratio=alignment_ratio,
            alpha_weight=alpha_weight,
            encoder_interval=encoder_interval)
        ts = make_timesteps(num_steps, spacing=dcfg.timestep_spacing)
        denoise = build_denoiser(dcfg, schedule, ts)

        context = self.embed_prompts(prompt, negative_prompt, num_samples)
        # control conditions: SAM map first, inpaint condition last
        conds = [self.prepare_condition(condition_image, h, w, num_samples)]
        scales = [float(control_scale)]
        if len(self.controls) > 1:
            inp = make_inpaint_condition(img.astype(np.float32) / 255.0, m)
            inp = torch.from_numpy(inp).permute(2, 0, 1)[None]
            conds.append(inp.expand(num_samples, -1, -1, -1)
                         .to(device, b.dtype))
            scales.append(1.0)

        image_latents, mask_latents = self._latent_inputs(img, m, h, w,
                                                          num_samples)
        shape = image_latents.shape
        if generator is None:
            generator = torch.Generator(device).manual_seed(seed)
        latents = self.initial_latents(shape, noise=noise, generator=generator)

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
        if self.inpaint_mode == "mix":
            # outside the mask the loop starts from the re-noised original
            renoised = add_noise(schedule, image_latents, self.initial_latents(
                shape, noise=mix_noise, generator=generator), int(ts[0]))
            latents = (1.0 - mask_latents) * renoised + mask_latents * latents

        params = {"unet": b.unet,
                  "controlnets": b.controlnet_modules(self.controls)}
        out = denoise(params, latents.to(b.dtype), context, inputs)
        if return_latents:
            return out.float().permute(0, 2, 3, 1).cpu().numpy()
        return self.decode(out)
