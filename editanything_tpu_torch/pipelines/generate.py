"""txt2img with one ControlNet (the reference's sam2image path), and the
helpers every pipeline over a bundle shares: uint8 output, condition maps,
scale maps, prompt context, VAE encode, initial latents and per-step noise.

Counterpart of ``editanything_tpu/pipelines/generate.py``
(``GenerationPipeline.__call__``, :168-229, with ``to_uint8``,
``prepare_condition``, ``embed_prompts``, ``_decode_tile_spec`` and
``_encode``) for every sampler of engine/denoise.py, encoder caching,
per-pixel scale maps and guess mode. Above ``vae_oneshot_max_px`` the VAE
encodes and decodes tiled (models/vae.py), as the JAX pipelines do.
Two additions, as in
``EditPipeline``: the initial latents can be handed in (``noise``) or drawn
from an explicit ``generator``. Decoded images pass the bundle's safety
checker, where one is loaded, as every pipeline's of the JAX package do
(edit.py:276, :348, generate.py:227, img2img.py:104); its flags are
``last_nsfw``.

Data parallelism (``group=``, a ``torch.distributed`` group; JAX's
``mesh=``): every rank builds the request's inputs and draws its noise for
the whole batch, denoises and decodes its contiguous slice of the samples
(``shard_denoise_inputs``), and the uint8 images are gathered back in
order, so N ranks return what one process returns. The batch
(`num_samples`) must divide by the ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from editanything_tpu_torch.engine import prompts as P
from editanything_tpu_torch.engine.denoise import DenoiseConfig, build_denoiser
from editanything_tpu_torch.models.vae import _scale_factor
from editanything_tpu_torch.parallel.sharding import (gather_batch,
                                                      rank_and_size,
                                                      replicate, shard_batch)
from editanything_tpu_torch.pipelines.bundle import ModelBundle
from editanything_tpu_torch.samplers.schedule import make_timesteps
from editanything_tpu_torch.utils.image import HWC3, resize_bilinear, resize_image


def to_uint8(img_f32: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(img_f32, np.float32) + 1.0) * 127.5,
                   0, 255).astype(np.uint8)


# the per-sample inputs of engine/denoise.py's loop and their batch axes
# (the others, "ref_mask" and the scalars, are shared by every sample)
_BATCH_AXES = {"mask": 0, "image_latents": 0, "masked_image_latents": 0,
               "noise": 0, "ref_image_latents": 0, "ref_context": 0,
               "step_noise": 1, "eta_noise": 1}
_BATCH_LISTS = ("controlnet_conds", "controlnet_scale_maps",
                "ref_controlnet_conds")


def shard_denoise_inputs(latents, context, inputs, group):
    """This rank's slice of the samples of one denoise call: the initial
    latents, the contexts and every per-sample input."""
    def cut(x, axis=0):
        return None if x is None else shard_batch(x, group, axis=axis)
    inputs = dict(inputs)
    for key, axis in _BATCH_AXES.items():
        if key in inputs:
            inputs[key] = cut(inputs[key], axis)
    for key in _BATCH_LISTS:
        if key in inputs:
            inputs[key] = [cut(x) for x in inputs[key]]
    return cut(latents), {k: cut(v) for k, v in context.items()}, inputs


class GenerationPipeline:
    """txt2img with one ControlNet condition (sam2image.py semantics); the
    base of ``EditPipeline``."""

    # the one-shot VAE up to this side; above it the encode and decode run
    # tiled. Per instance (tests lower it to tile tiny images)
    vae_oneshot_max_px = 2048
    vae_tile_latent = 128        # latent-px decode tile -> 1024^2 image tiles
    vae_tile_overlap = 32

    def __init__(self, bundle: ModelBundle, controlnet: str = "sam",
                 group=None):
        self.bundle = bundle
        self.controlnet = controlnet
        # data parallelism over the samples; None: this process alone
        self.group = group
        if rank_and_size(group)[1] > 1:
            for m in [bundle.unet, bundle.vae, bundle.text] + [
                    net for _, net in bundle.controlnets.values()]:
                replicate(m, group)
        # non-finite values in the last decoded batch, before the uint8 cast
        self.last_nonfinite = None
        # per-image NSFW flags of the last call; None: no checker is loaded
        self.last_nsfw = None

    def _decode_tile_spec(self, h: int, w: int):
        """(tile, overlap) in latent px for a decode to h x w images, or
        None where the one-shot decode runs (<= vae_oneshot_max_px)."""
        if max(h, w) <= self.vae_oneshot_max_px:
            return None
        return (self.vae_tile_latent, self.vae_tile_overlap)

    def _encode(self, x):
        """(B, 3, H, W) in [-1, 1] -> scaled latents (fp32); tiled above the
        one-shot bound, with the decode's tile and overlap in image px."""
        vae = self.bundle.vae
        if max(x.shape[-2:]) <= self.vae_oneshot_max_px:
            return vae.encode_to_latents(x)
        f = _scale_factor(self.bundle.vae_cfg)
        return vae.encode_to_latents(x, tile=self.vae_tile_latent * f,
                                     overlap=self.vae_tile_overlap * f)

    def prepare_condition(self, condition_map: np.ndarray, h: int, w: int,
                          batch: int) -> torch.Tensor:
        """uint8 (Hc, Wc, 3) ID map -> (B, 3, H, W) in [0, 1], resized
        bilinearly, in the bundle's dtype on its device."""
        cond = torch.from_numpy(
            HWC3(condition_map.astype(np.uint8)).astype(np.float32)) / 255.0
        cond = resize_bilinear(cond.permute(2, 0, 1)[None], (h, w))
        b = self.bundle
        return cond.expand(batch, -1, -1, -1).to(b.device, b.dtype)

    def prepare_scale_map(self, scale_map: np.ndarray, h: int, w: int,
                          batch: int) -> torch.Tensor:
        """(Hm, Wm) per-pixel ControlNet scale -> (B, H, W) fp32 on the
        bundle's device, resized bilinearly as ``jax.image.resize``."""
        m = torch.from_numpy(np.asarray(scale_map, np.float32))[None, None]
        m = resize_bilinear(m, (h, w))[0]
        return m.expand(batch, -1, -1).to(self.bundle.device)

    def embed_prompts(self, prompt: str, negative_prompt: str, batch: int):
        b = self.bundle
        cond, uncond = P.get_pipeline_embeds(
            b.text, b.tokenizer, prompt, negative_prompt,
            layer_skip=b.text_cfg.layer_skip)
        rep = lambda x: x.expand(batch, -1, -1).to(b.dtype)
        return {"cond": rep(cond), "uncond": rep(uncond)}

    def initial_latents(self, shape, *, noise=None,
                        generator: Optional[torch.Generator] = None,
                        seed: int = 0) -> torch.Tensor:
        """(B, 4, h, w) fp32 initial latents on the bundle's device: `noise`
        when given (the JAX package's (B, h, w, 4) layout), else drawn from
        `generator` (on that device; default: seeded with `seed`)."""
        device = self.bundle.device
        if noise is None:
            if generator is None:
                generator = torch.Generator(device).manual_seed(seed)
            return torch.randn(shape, generator=generator, device=device,
                               dtype=torch.float32)
        latents = (noise.float() if isinstance(noise, torch.Tensor) else
                   torch.tensor(np.asarray(noise), dtype=torch.float32))
        latents = latents.permute(0, 3, 1, 2).to(device)
        if latents.shape != shape:
            b, c, h, w = shape
            raise ValueError(f"noise is {tuple(noise.shape)}; this call needs "
                             f"{(b, h, w, c)}")
        return latents

    def per_step_noise(self, shape, num_steps: int, *, noise=None,
                       seed: int = 0) -> torch.Tensor:
        """(num_steps, B, 4, h, w) fp32 noise, one slice per denoise step, on
        the bundle's device: `noise` when given (that layout), else drawn
        from a generator on that device seeded with `seed`."""
        device = self.bundle.device
        want = (num_steps,) + tuple(shape)
        if noise is None:
            g = torch.Generator(device).manual_seed(seed)
            return torch.randn(want, generator=g, device=device,
                               dtype=torch.float32)
        out = (noise if isinstance(noise, torch.Tensor) else
               torch.from_numpy(np.asarray(noise, np.float32)))
        out = out.float().to(device)
        if tuple(out.shape) != want:
            raise ValueError(f"step noise is {tuple(out.shape)}; this call "
                             f"needs {want}")
        return out

    def run_denoise(self, denoise, params, latents, context, inputs):
        """`denoise` over this rank's slice of the samples (all of them
        without a group)."""
        if self.group is not None:
            latents, context, inputs = shard_denoise_inputs(
                latents, context, inputs, self.group)
        return denoise(params, latents, context, inputs)

    def finish(self, out, return_latents: bool = False) -> np.ndarray:
        """A denoise call's final latents -> (B, H, W, 3) uint8 images
        (``decode``), or with `return_latents` (B, h, w, 4) fp32 latents,
        every rank's gathered in order."""
        if return_latents:
            out = gather_batch(out.float(), self.group)
            return out.permute(0, 2, 3, 1).cpu().numpy()
        imgs = self.decode(out)
        if self.group is None:
            return imgs
        device = self.bundle.device
        if self.last_nsfw is not None:
            self.last_nsfw = gather_batch(torch.as_tensor(
                np.asarray(self.last_nsfw)).to(device), self.group).cpu().numpy()
        return gather_batch(torch.from_numpy(imgs).to(device),
                            self.group).cpu().numpy()

    def decode(self, latents) -> np.ndarray:
        """Final latents -> (B, H, W, 3) uint8 images, tiled above the
        one-shot bound, counting non-finite values before the cast, then
        through the bundle's safety checker (flags in ``last_nsfw``)."""
        f = _scale_factor(self.bundle.vae_cfg)
        spec = self._decode_tile_spec(latents.shape[-2] * f,
                                      latents.shape[-1] * f)
        tile, overlap = spec if spec else (None, 32)
        imgs = self.bundle.vae.decode_from_latents(
            latents.to(self.bundle.dtype), tile=tile, overlap=overlap).float()
        self.last_nonfinite = int((~torch.isfinite(imgs)).sum())
        out, self.last_nsfw = self.bundle.run_safety(
            to_uint8(imgs.permute(0, 2, 3, 1).cpu().numpy()))
        return out

    @torch.inference_mode()
    def __call__(self, *, prompt: str, condition_image: np.ndarray,
                 negative_prompt: str = "", num_samples: int = 1,
                 image_resolution: int = 512, num_steps: int = 20,
                 guidance_scale: float = 9.0, control_scale: float = 1.0,
                 scale_map: Optional[np.ndarray] = None,
                 guess_mode: bool = False, sampler: str = "unipc",
                 seed: int = 0, encoder_interval: int = 1,
                 generator: Optional[torch.Generator] = None,
                 noise=None, return_latents: bool = False) -> np.ndarray:
        """Returns (num_samples, H, W, 3) uint8 images, H x W the condition
        map resized to `image_resolution` (sam2image.py:146-156), or with
        return_latents the final (num_samples, H/8, W/8, 4) fp32 latents. The
        initial latents are `noise` when given ((num_samples, H/8, W/8, 4)),
        else drawn from `generator` (default: seeded with `seed`).
        `scale_map` (Hm, Wm) scales the ControlNet per pixel; DDIM runs with
        eta 0, as the JAX pipeline's. `encoder_interval` k > 1 runs the
        encoder half of the model every k-th step only (UniPC and DDIM;
        approximate)."""
        b = self.bundle
        sized = resize_image(HWC3(condition_image.astype(np.uint8)),
                             image_resolution)
        h, w = sized.shape[:2]
        dcfg = DenoiseConfig(
            unet=b.unet_cfg, controlnets=b.controlnet_cfgs((self.controlnet,)),
            num_steps=num_steps, sampler=sampler, guess_mode=guess_mode,
            encoder_interval=encoder_interval)
        denoise = build_denoiser(
            dcfg, b.noise_schedule(),
            make_timesteps(num_steps, spacing=dcfg.timestep_spacing))
        context = self.embed_prompts(prompt, negative_prompt, num_samples)
        inputs = {
            "controlnet_conds": [self.prepare_condition(condition_image, h, w,
                                                        num_samples)],
            "controlnet_scales": [float(control_scale)],
            "guidance_scale": float(guidance_scale),
        }
        if scale_map is not None:
            inputs["controlnet_scale_maps"] = [
                self.prepare_scale_map(scale_map, h, w, num_samples)]
        latents = self.initial_latents((num_samples, 4, h // 8, w // 8),
                                       noise=noise, generator=generator,
                                       seed=seed)
        params = {"unet": b.unet,
                  "controlnets": b.controlnet_modules((self.controlnet,))}
        out = self.run_denoise(denoise, params, latents.to(b.dtype), context,
                               inputs)
        return self.finish(out, return_latents)
