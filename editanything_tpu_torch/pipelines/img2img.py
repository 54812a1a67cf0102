"""img2img: strength-controlled regeneration of an input image.

Counterpart of ``editanything_tpu/pipelines/img2img.py``
(``Img2ImgPipeline``): the input's latents are noised to the first
timestep of the denoise grid's tail (``samplers/ddim.py::
stochastic_encode``) and denoised over that tail, with an optional
ControlNet. The tail is the last ``max(1, round(strength * num_steps))``
steps of the full grid (Python's ``round``, as the JAX pipeline's: 22 of 30
at strength 0.75). Above ``vae_oneshot_max_px`` the encode and decode run
tiled. The JAX pipeline draws the noise of ``stochastic_encode`` from
``split(PRNGKey(seed))[1]``; here it is handed in (``noise``) or drawn from
``generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from editanything_tpu_torch.engine.denoise import DenoiseConfig, build_denoiser
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.samplers.ddim import stochastic_encode
from editanything_tpu_torch.samplers.schedule import make_timesteps
from editanything_tpu_torch.utils.image import HWC3, resize_image


class Img2ImgPipeline(GenerationPipeline):
    """Strength-based img2img with an optional ControlNet condition."""

    @torch.inference_mode()
    def __call__(self, *, image: np.ndarray, prompt: str,
                 strength: float = 0.75,
                 condition_image: Optional[np.ndarray] = None,
                 negative_prompt: str = "", num_samples: int = 1,
                 image_resolution: int = 512, num_steps: int = 30,
                 guidance_scale: float = 9.0, control_scale: float = 1.0,
                 sampler: str = "unipc", seed: int = 0, noise=None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Returns (num_samples, H, W, 3) uint8 images, H x W the input
        resized to `image_resolution`. `noise` ((num_samples, H/8, W/8, 4),
        the JAX package's layout) noises the input's latents; else it is
        drawn from `generator` (default: seeded with `seed`)."""
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        b = self.bundle
        img = resize_image(HWC3(image.astype(np.uint8)), image_resolution)
        h, w = img.shape[:2]
        full_ts = make_timesteps(num_steps)
        n_run = max(1, int(round(strength * num_steps)))
        ts = full_ts[num_steps - n_run:]
        controls = (self.controlnet,) if condition_image is not None else ()
        schedule = b.noise_schedule()
        dcfg = DenoiseConfig(unet=b.unet_cfg,
                             controlnets=b.controlnet_cfgs(controls),
                             num_steps=n_run, sampler=sampler)
        denoise = build_denoiser(dcfg, schedule, ts)
        context = self.embed_prompts(prompt, negative_prompt, num_samples)
        inputs = {"guidance_scale": float(guidance_scale)}
        if condition_image is not None:
            inputs["controlnet_conds"] = [self.prepare_condition(
                condition_image, h, w, num_samples)]
            inputs["controlnet_scales"] = [float(control_scale)]
        x = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
        z = self._encode((x / 127.5 - 1.0).to(b.device, b.dtype)).float()
        z = z.expand(num_samples, -1, -1, -1)
        eps = self.initial_latents(z.shape, noise=noise, generator=generator,
                                   seed=seed)
        latents = stochastic_encode(schedule, z, int(ts[0]), eps)
        params = {"unet": b.unet, "controlnets": b.controlnet_modules(controls)}
        return self.finish(self.run_denoise(denoise, params,
                                            latents.to(b.dtype), context,
                                            inputs))
