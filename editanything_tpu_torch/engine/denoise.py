"""The denoise loop: classifier-free guidance (CFG) by batch doubling, the
summed residuals of several ControlNets (with per-pixel scale maps and
guess mode), UniPC or DDIM, and the inpaint modes.

Counterpart of ``editanything_tpu/engine/denoise.py`` for the samplers
"unipc" and "ddim" and the inpaint modes "none", "unet9", "blend" and
"mix": ``precompute_hints`` (the hint stacks and every cross-attention K/V
once per edit), ``model_output``, ``blend_outside_mask``/``final_paste``
and the two loops. There each loop is one ``lax.scan`` and the per-step
noises of "mix" and of DDIM's eta are drawn inside it from folded keys;
here the loop is Python over the same steps and those noises come in as
inputs, one slice per step. Reference-only control and encoder caching
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from editanything_tpu_torch.models import controlnet as CN
from editanything_tpu_torch.samplers import ddim as ddim_mod
from editanything_tpu_torch.samplers import schedule as sched
from editanything_tpu_torch.samplers import unipc as unipc_mod

INPAINT_MODES = ("none", "unet9", "blend", "mix")


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Static structure of a denoise loop: the JAX package's fields but
    ``guidance`` (CFG always runs, by batch doubling) and
    ``prediction_type`` (the loop reads the schedule's)."""
    unet: Any                            # UNetConfig
    controlnets: tuple = ()              # tuple of ControlNetConfig
    num_steps: int = 30
    sampler: str = "unipc"               # "unipc" | "ddim"
    # DDIM's stochasticity; > 0 needs inputs["eta_noise"] (UniPC ignores it)
    eta: float = 0.0
    guess_mode: bool = False
    inpaint_mode: str = "none"           # one of INPAINT_MODES
    alignment_ratio: Optional[float] = None   # "blend"/"mix": paste while < ratio
    alpha_weight: float = 0.5            # "mix": weight of the re-noised original
    timestep_spacing: str = "linspace"
    ref: Any = None                      # reference-only control config
    encoder_interval: int = 1


def _unsupported(cfg: DenoiseConfig):
    if cfg.sampler not in ("unipc", "ddim"):
        return (f"sampler {cfg.sampler!r} (ROADMAP Queue 1 item 4: PLMS, "
                "DPM-Solver)")
    if cfg.ref is not None:
        return "reference-only control (ROADMAP Queue 1 item 4)"
    if cfg.encoder_interval != 1:
        return "encoder_interval > 1 (ROADMAP Queue 1 item 4)"
    return None


def _check(cfg: DenoiseConfig, ts):
    """The JAX package's assertions (denoise.py:112-118), and what its
    traced program would reject."""
    if len(ts) != cfg.num_steps:
        raise ValueError(f"{len(ts)} timesteps for {cfg.num_steps} steps")
    if cfg.ref is not None and cfg.guess_mode:
        raise ValueError("reference-only control is incompatible with "
                         "guess_mode")
    if cfg.encoder_interval != 1 and (cfg.ref is not None or cfg.guess_mode):
        raise ValueError("encoder caching is incompatible with ref mode / "
                         "guess mode")
    if cfg.inpaint_mode not in INPAINT_MODES:
        raise ValueError(f"unknown inpaint_mode {cfg.inpaint_mode!r}")


def _cat2(x):
    return torch.cat([x, x], dim=0)


def build_denoiser(cfg: DenoiseConfig, schedule: sched.NoiseSchedule,
                   timesteps):
    """Returns run(params, latents, context, inputs) -> final latents.

      params  = {"unet": UNet2DConditionModel, "controlnets": [ControlNetModel]}
      latents = (B, 4, h, w) initial latents in the working dtype
      context = {"cond": (B, N, D), "uncond": (B, N, D)}
      inputs  = {"controlnet_conds": [(B, 3, 8h, 8w)], "controlnet_scales":
                 [float], "controlnet_scale_maps": [(B, 8h, 8w) or None]
                 (optional), "guidance_scale": float, and by mode:
                 "mask" (B, 1, h, w) 1 = edit region [unet9, blend, mix];
                 "image_latents" (B, 4, h, w) [blend, mix];
                 "masked_image_latents" (B, 4, h, w) [unet9];
                 "noise" (B, 4, h, w), the initial noise [blend];
                 "step_noise" (n, B, 4, h, w), fresh noise per step [mix];
                 "eta_noise" (n, B, 4, h, w) [ddim with eta > 0]}
    """
    ts = [int(t) for t in timesteps]
    _check(cfg, ts)
    problem = _unsupported(cfg)
    if problem is not None:
        raise NotImplementedError(f"not ported yet: {problem}")
    n = cfg.num_steps

    def cfg_context(context):
        return torch.cat([context["uncond"], context["cond"]], dim=0)

    def precompute_hints(params, inputs, dtype, context):
        """Loop-invariant work, once per edit: each ControlNet's hint stack
        and every cross-attention (k, v) projection of the text context."""
        ctx = cfg_context(context)
        hoisted = {"kv_unet": params["unet"].context_kv(ctx)}
        if cfg.controlnets:
            # guess mode: the ControlNets see the cond half only
            cn_ctx = context["cond"] if cfg.guess_mode else ctx
            hoisted["kv_cns"] = [cn.context_kv(cn_ctx)
                                 for cn in params["controlnets"]]
            hoisted["main"] = [
                cn.hint_embedding((c if cfg.guess_mode else _cat2(c)).to(dtype))
                for cn, c in zip(params["controlnets"],
                                 inputs["controlnet_conds"])]
        return hoisted

    def model_output(params, latents, t, context, inputs, hoisted):
        """ControlNet(s) + UNet + CFG at one timestep."""
        guidance_scale = inputs.get("guidance_scale", 7.5)
        lat_in = _cat2(latents)
        ctx = cfg_context(context)
        unet_in = lat_in
        if cfg.inpaint_mode == "unet9":
            extra = _cat2(torch.cat([inputs["mask"],
                                     inputs["masked_image_latents"]], dim=1))
            unet_in = torch.cat([lat_in, extra.to(lat_in.dtype)], dim=1)
        tb = torch.full((unet_in.shape[0],), t, dtype=torch.int32,
                        device=lat_in.device)
        down_res = mid_res = None
        if cfg.controlnets:
            nets = params["controlnets"]
            scales = inputs["controlnet_scales"]
            smaps = (inputs.get("controlnet_scale_maps")
                     or [None] * len(nets))
            if cfg.guess_mode:
                tb_h = torch.full((latents.shape[0],), t, dtype=torch.int32,
                                  device=latents.device)
                down_c, mid_c = CN.multi_controlnet_apply(
                    nets, latents, tb_h, context["cond"], None, scales, smaps,
                    guess_mode=True, hint_embeddings=hoisted["main"],
                    ctx_kvs=hoisted["kv_cns"])
                # the uncond half gets no residuals
                down_res = tuple(torch.cat([torch.zeros_like(r), r], dim=0)
                                 for r in down_c)
                mid_res = torch.cat([torch.zeros_like(mid_c), mid_c], dim=0)
            else:
                smaps_in = [(_cat2(m) if m is not None else m)
                            for m in smaps]
                down_res, mid_res = CN.multi_controlnet_apply(
                    nets, lat_in, tb, ctx, None, scales, smaps_in,
                    hint_embeddings=hoisted["main"],
                    ctx_kvs=hoisted["kv_cns"])
        out = params["unet"](unet_in, tb, ctx,
                             down_block_residuals=down_res,
                             mid_block_residual=mid_res,
                             ctx_kv=hoisted["kv_unet"])
        uncond, cond = out.chunk(2, dim=0)
        return uncond + guidance_scale * (cond - uncond)

    # the paste window as the JAX package computes it: float32 ratio * n
    ratio = cfg.alignment_ratio
    if cfg.inpaint_mode == "mix" and ratio is None:
        ratio = 1.0
    paste_until = (float(np.float32(ratio) * np.float32(n))
                   if ratio is not None else None)

    def blend_outside_mask(latents, i, inputs):
        """Per-step blending with the original latents re-noised to
        t_{i+1}, never at the last step.

        "blend" (alignment_ratio set): outside the edit mask, paste the
        original re-noised with the initial noise while i < n * ratio.
        "mix": with fresh noise each step, inside the mask
        (1 - alpha) * latents + alpha * re-noised; outside it a hard paste
        while i < n * ratio (ratio None: every step)."""
        if cfg.inpaint_mode not in ("blend", "mix") or paste_until is None:
            return latents
        if i + 1 >= n:
            return latents
        mask = inputs["mask"].float()
        img = inputs["image_latents"].float()
        noise = (inputs["step_noise"][i] if cfg.inpaint_mode == "mix"
                 else inputs["noise"]).float()
        renoised = sched.add_noise(schedule, img, noise, ts[i + 1])
        outside = renoised if i < paste_until else latents
        inside = latents
        if cfg.inpaint_mode == "mix":
            a = cfg.alpha_weight
            inside = (1.0 - a) * latents + a * renoised
        return mask * inside + (1.0 - mask) * outside

    def final_paste(latents, inputs):
        """"blend" with alignment_ratio None or >= 1: one clean paste of the
        original latents outside the mask at the end ("mix" never pastes)."""
        if cfg.inpaint_mode != "blend":
            return latents
        if cfg.alignment_ratio is not None and cfg.alignment_ratio < 1.0:
            return latents
        mask = inputs["mask"].float()
        return mask * latents + (1.0 - mask) * inputs["image_latents"].float()

    def run_unipc(params, latents, context, inputs, hoisted):
        state = unipc_mod.unipc_init(latents)
        for i in range(n):
            out = model_output(params, state.sample.to(latents.dtype), ts[i],
                               context, inputs, hoisted)
            state, prev = unipc_mod.unipc_step(schedule, state, out, ts,
                                               step=i)
            state = state._replace(sample=blend_outside_mask(prev, i, inputs))
        return state.sample

    def run_ddim(params, latents, context, inputs, hoisted):
        x = latents.float()
        for i in range(n):
            t_prev = ts[i + 1] if i + 1 < n else -1
            out = model_output(params, x.to(latents.dtype), ts[i], context,
                               inputs, hoisted)
            x, _ = ddim_mod.ddim_step(
                schedule, x, out, ts[i], t_prev, eta=cfg.eta,
                noise=inputs["eta_noise"][i] if cfg.eta > 0.0 else None)
            x = blend_outside_mask(x, i, inputs)
        return x

    loop = run_ddim if cfg.sampler == "ddim" else run_unipc

    def run(params, latents, context, inputs):
        hoisted = precompute_hints(params, inputs, latents.dtype, context)
        final = loop(params, latents, context, inputs, hoisted)
        return final_paste(final, inputs).to(latents.dtype)

    return run
