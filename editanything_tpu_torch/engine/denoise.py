"""The denoise loop: classifier-free guidance (CFG) by batch doubling, the
summed residuals of several ControlNets (with per-pixel scale maps and
guess mode), the samplers, the inpaint modes, reference-only control and
encoder caching.

Counterpart of ``editanything_tpu/engine/denoise.py`` for every sampler
("unipc", "ddim", "plms", "dpm", "dpm3", "dpms1"-"dpms3") and inpaint mode
("none", "unet9", "blend", "mix"): ``precompute_hints`` (the hint stacks
and every cross-attention K/V once per edit), ``model_output`` (with the
reference write pass), the encoder cache, ``blend_outside_mask`` /
``final_paste`` and the loops. There each loop is one ``lax.scan``, the
PLMS warm-up's second evaluation and the cache's key steps are
``lax.cond``s, and the per-step noises of "mix" and of DDIM's eta are drawn
inside it from folded keys; here the loop is Python over the same steps,
the conditions are Python ``if``s, and those noises come in as inputs, one
slice per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from editanything_tpu_torch.engine import refctrl
from editanything_tpu_torch.models import controlnet as CN
from editanything_tpu_torch.samplers import ddim as ddim_mod
from editanything_tpu_torch.samplers import dpm as dpm_mod
from editanything_tpu_torch.samplers import plms as plms_mod
from editanything_tpu_torch.samplers import schedule as sched
from editanything_tpu_torch.samplers import unipc as unipc_mod
from editanything_tpu_torch.utils import trace

INPAINT_MODES = ("none", "unet9", "blend", "mix")
SAMPLERS = ("unipc", "ddim", "plms", "dpm", "dpm3", "dpms1", "dpms2", "dpms3")
# the samplers whose loops cache the encoder (the others run every step in
# full, whatever encoder_interval says, as in the JAX package)
CACHED_SAMPLERS = ("unipc", "ddim")


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Static structure of a denoise loop: the JAX package's fields but
    ``guidance`` (CFG always runs, by batch doubling) and
    ``prediction_type`` (the loop reads the schedule's)."""
    unet: Any                            # UNetConfig
    controlnets: tuple = ()              # tuple of ControlNetConfig
    num_steps: int = 30
    sampler: str = "unipc"               # one of SAMPLERS
    # DDIM's stochasticity; > 0 needs inputs["eta_noise"] (UniPC ignores it)
    eta: float = 0.0
    guess_mode: bool = False
    inpaint_mode: str = "none"           # one of INPAINT_MODES
    alignment_ratio: Optional[float] = None   # "blend"/"mix": paste while < ratio
    alpha_weight: float = 0.5            # "mix": weight of the re-noised original
    timestep_spacing: str = "linspace"
    # reference-only control (refctrl.RefConfig); needs inputs
    # "ref_image_latents", "ref_mask", "ref_context", "ref_controlnet_conds"
    # and "noise"
    ref: Optional[refctrl.RefConfig] = None
    # encoder caching (Faster-Diffusion, arXiv:2312.09608): the ControlNets
    # and the UNet encoder and middle run every k-th step only, the decoder
    # every step; 1 = off. Approximate.
    encoder_interval: int = 1


def _check(cfg: DenoiseConfig, ts):
    """The JAX package's assertions (denoise.py:112-118), and what its
    traced program would reject."""
    if len(ts) != cfg.num_steps:
        raise ValueError(f"{len(ts)} timesteps for {cfg.num_steps} steps")
    if cfg.ref is not None and cfg.guess_mode:
        raise ValueError("reference-only control is incompatible with "
                         "guess_mode")
    if cfg.ref is not None and cfg.inpaint_mode == "unet9":
        # the write pass feeds the UNet the 4-channel reference latents
        raise ValueError("reference-only control needs a 4-channel UNet, "
                         "not inpaint_mode 'unet9'")
    if cfg.encoder_interval != 1 and (cfg.ref is not None or cfg.guess_mode):
        raise ValueError("encoder caching is incompatible with ref mode / "
                         "guess mode")
    if cfg.inpaint_mode not in INPAINT_MODES:
        raise ValueError(f"unknown inpaint_mode {cfg.inpaint_mode!r}")
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {cfg.sampler!r}; one of {SAMPLERS}")
    if cfg.encoder_interval < 1:
        raise ValueError(f"encoder_interval {cfg.encoder_interval} < 1")


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
                 "mask" (B, 1, h, w) 1 = edit region [unet9, blend, mix, ref];
                 "image_latents" (B, 4, h, w) [blend, mix];
                 "masked_image_latents" (B, 4, h, w) [unet9];
                 "noise" (B, 4, h, w), the initial noise [blend, ref];
                 "step_noise" (n, B, 4, h, w), fresh noise per step [mix];
                 "eta_noise" (n, B, 4, h, w) [ddim with eta > 0];
                 "ref_image_latents" (B, 4, h, w), "ref_mask" (1, 1, h, w)
                 1 = the reference region, "ref_context" (B, N, D) (cond
                 only), "ref_controlnet_conds" [(B, 3, 8h, 8w)] and
                 optionally "ref_controlnet_scales" [float] (default: the
                 main scales) [ref]}

    The singlestep DPM samplers ("dpms1"-"dpms3") evaluate the model at
    their own plan's timesteps (``dpm.singlestep_plan``), which replace
    `timesteps`; PLMS evaluates twice at step 0 (num_steps + 1 in all).
    """
    ts = [int(t) for t in timesteps]
    _check(cfg, ts)
    n = cfg.num_steps
    if cfg.sampler.startswith("dpms"):
        plan = dpm_mod.singlestep_plan(schedule, n, int(cfg.sampler[-1]))
        ts = [int(t) for t in plan.ts]
    k_enc = cfg.encoder_interval if cfg.sampler in CACHED_SAMPLERS else 1

    def cfg_context(context):
        return torch.cat([context["uncond"], context["cond"]], dim=0)

    def precompute_hints(params, inputs, dtype, context):
        """Loop-invariant work, once per edit: each ControlNet's hint stack
        (and under ref its stack of the reference conditions), every
        cross-attention (k, v) projection of the text context, and under
        ref the masks at each block size."""
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
            if cfg.ref is not None:
                hoisted["ref"] = [
                    cn.hint_embedding(c.to(dtype))
                    for cn, c in zip(params["controlnets"],
                                     inputs["ref_controlnet_conds"])]
        if cfg.ref is not None:
            hoisted["ref_masks"] = refctrl.RefMasks(inputs["ref_mask"],
                                                    inputs["mask"])
        return hoisted

    def reference_pass(params, latents, t, inputs, hoisted):
        """The write pass of one step: the ControlNets (at the reference
        scales, over the reference conditions) and the UNet over the
        reference latents re-noised to t with the initial noise, under the
        reference prompt. Returns the banks' readers (UNet, last
        ControlNet)."""
        ref_xt = sched.add_noise(schedule, inputs["ref_image_latents"].float(),
                                 inputs["noise"].float(), t).to(latents.dtype)
        masks = hoisted["ref_masks"]
        w_cn = refctrl.RefState(cfg.ref, "write", masks)
        w_un = refctrl.RefState(cfg.ref, "write", masks)
        tb = torch.full((ref_xt.shape[0],), t, dtype=torch.int32,
                        device=ref_xt.device)
        ref_ctx = inputs["ref_context"].to(latents.dtype)
        rdown = rmid = None
        if cfg.controlnets:
            scales = (inputs.get("ref_controlnet_scales")
                      or inputs["controlnet_scales"])
            rdown, rmid = CN.multi_controlnet_apply(
                params["controlnets"], ref_xt, tb, ref_ctx, None, scales,
                hint_embeddings=hoisted["ref"], ref=w_cn)
        params["unet"](ref_xt, tb, ref_ctx, down_block_residuals=rdown,
                       mid_block_residual=rmid, ref=w_un)
        return w_un.reader(), w_cn.reader()

    def model_inputs(latents, t, context, inputs):
        """(ControlNet input, UNet input, context, timesteps) of the CFG
        batch; the 9-channel UNet takes the mask and masked latents too."""
        lat_in = _cat2(latents)
        unet_in = lat_in
        if cfg.inpaint_mode == "unet9":
            extra = _cat2(torch.cat([inputs["mask"],
                                     inputs["masked_image_latents"]], dim=1))
            unet_in = torch.cat([lat_in, extra.to(lat_in.dtype)], dim=1)
        tb = torch.full((unet_in.shape[0],), t, dtype=torch.int32,
                        device=lat_in.device)
        return lat_in, unet_in, cfg_context(context), tb

    def controlnet_residuals(params, latents, lat_in, t, tb, ctx, context,
                             inputs, hoisted, ref=None):
        """The summed residual stacks of the ControlNets on the CFG batch
        (guess mode: on the cond half, the uncond half's residuals zero)."""
        nets = params["controlnets"]
        scales = inputs["controlnet_scales"]
        smaps = inputs.get("controlnet_scale_maps") or [None] * len(nets)
        if cfg.guess_mode:
            tb_h = torch.full((latents.shape[0],), t, dtype=torch.int32,
                              device=latents.device)
            down_c, mid_c = CN.multi_controlnet_apply(
                nets, latents, tb_h, context["cond"], None, scales, smaps,
                guess_mode=True, hint_embeddings=hoisted["main"],
                ctx_kvs=hoisted["kv_cns"])
            return (tuple(torch.cat([torch.zeros_like(r), r], dim=0)
                          for r in down_c),
                    torch.cat([torch.zeros_like(mid_c), mid_c], dim=0))
        smaps_in = [(_cat2(m) if m is not None else m) for m in smaps]
        return CN.multi_controlnet_apply(
            nets, lat_in, tb, ctx, None, scales, smaps_in,
            hint_embeddings=hoisted["main"], ctx_kvs=hoisted["kv_cns"],
            ref=ref)

    def guided(out, inputs):
        uncond, cond = out.chunk(2, dim=0)
        return uncond + inputs.get("guidance_scale", 7.5) * (cond - uncond)

    def model_output(params, latents, t, context, inputs, hoisted):
        """(Reference write pass,) ControlNet(s) + UNet + CFG at one
        timestep."""
        ref_unet = ref_cn = None
        if cfg.ref is not None:
            ref_unet, ref_cn = reference_pass(params, latents, t, inputs,
                                              hoisted)
        lat_in, unet_in, ctx, tb = model_inputs(latents, t, context, inputs)
        down_res = mid_res = None
        if cfg.controlnets:
            with trace.span("denoise.controlnets"):
                down_res, mid_res = controlnet_residuals(
                    params, latents, lat_in, t, tb, ctx, context, inputs,
                    hoisted, ref=ref_cn)
        with trace.span("denoise.unet"):
            out = params["unet"](unet_in, tb, ctx,
                                 down_block_residuals=down_res,
                                 mid_block_residual=mid_res,
                                 ctx_kv=hoisted["kv_unet"], ref=ref_unet)
        return guided(out, inputs)

    def encoder_pass(params, latents, t, context, inputs, hoisted):
        """The cacheable half of a step: the UNet encoder and middle with
        the ControlNet residuals added. Returns (residuals, hidden)."""
        unet = params["unet"]
        lat_in, unet_in, ctx, tb = model_inputs(latents, t, context, inputs)
        with trace.span("denoise.unet"):
            temb = unet.time_embed(tb, unet_in.dtype)
            h, residuals = unet.encode(unet_in, temb, ctx,
                                       ctx_kv=hoisted["kv_unet"])
            h = unet.middle(h, temb, ctx, ctx_kv=hoisted["kv_unet"])
        if cfg.controlnets:
            with trace.span("denoise.controlnets"):
                down, mid = controlnet_residuals(params, latents, lat_in, t,
                                                 tb, ctx, context, inputs,
                                                 hoisted)
            residuals = [r + c.to(r.dtype) for r, c in zip(residuals, down)]
            h = h + mid.to(h.dtype)
        return residuals, h

    def model_output_cached(params, latents, t, context, inputs, hoisted,
                            cache, is_key):
        """A step with encoder caching: the encoder half runs on key steps
        only; the decoder runs every step with this step's timestep
        embedding. Returns (guided output, cache)."""
        if is_key:
            cache = encoder_pass(params, latents, t, context, inputs, hoisted)
        residuals, h = cache
        unet = params["unet"]
        tb = torch.full((2 * latents.shape[0],), t, dtype=torch.int32,
                        device=latents.device)
        with trace.span("denoise.unet"):
            temb = unet.time_embed(tb, latents.dtype)
            out = unet.decode(h, residuals, temb, cfg_context(context),
                              ctx_kv=hoisted["kv_unet"])
        return guided(out, inputs), cache

    # the paste window as the JAX package computes it: float32 ratio * n
    ratio = cfg.alignment_ratio
    if cfg.inpaint_mode == "mix" and ratio is None:
        ratio = 1.0
    paste_until = (float(np.float32(ratio) * np.float32(n))
                   if ratio is not None else None)

    def blend_outside_mask(latents, i, inputs):
        """Per-step blending with the original latents re-noised to the next
        evaluation's timestep, never at the last step.

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

    # the loops: evaluate(x, i, t) is the guided model output at step i

    def run_unipc(evaluate, latents, inputs):
        state = unipc_mod.unipc_init(latents)
        for i in range(n):
            with trace.span("denoise.step"):
                out = evaluate(state.sample, i, ts[i])
                with trace.span("denoise.sampler"):
                    state, prev = unipc_mod.unipc_step(schedule, state, out,
                                                       ts, step=i)
                    state = state._replace(
                        sample=blend_outside_mask(prev, i, inputs))
        return state.sample

    def run_ddim(evaluate, latents, inputs):
        x = latents.float()
        for i in range(n):
            t_prev = ts[i + 1] if i + 1 < n else -1
            with trace.span("denoise.step"):
                out = evaluate(x, i, ts[i])
                with trace.span("denoise.sampler"):
                    x, _ = ddim_mod.ddim_step(
                        schedule, x, out, ts[i], t_prev, eta=cfg.eta,
                        noise=(inputs["eta_noise"][i] if cfg.eta > 0.0
                               else None))
                    x = blend_outside_mask(x, i, inputs)
        return x

    def run_dpm(evaluate, latents, inputs):
        order = 3 if cfg.sampler == "dpm3" else 2
        state = dpm_mod.dpm_init(latents)
        for i in range(n):
            with trace.span("denoise.step"):
                out = evaluate(state.sample, i, ts[i])
                with trace.span("denoise.sampler"):
                    state, prev = dpm_mod.dpm_step(schedule, state, out, ts,
                                                   i, order=order)
                    state = state._replace(
                        sample=blend_outside_mask(prev, i, inputs))
        return state.sample

    def run_singlestep(evaluate, latents, inputs):
        state = dpm_mod.singlestep_init(latents)
        for i in range(n):
            with trace.span("denoise.step"):
                out = evaluate(state.sample, i, ts[i])
                with trace.span("denoise.sampler"):
                    state, prev = dpm_mod.singlestep_step(schedule, state,
                                                          out, plan, i)
                    state = state._replace(
                        sample=blend_outside_mask(prev, i, inputs))
        return state.sample

    def run_plms(evaluate, latents, inputs):
        state = plms_mod.plms_init(latents)
        for i in range(n):
            t = ts[i]
            t_prev = ts[i + 1] if i + 1 < n else -1
            with trace.span("denoise.step"):
                out = evaluate(state.sample, i, t)
                out_next = out
                if i == 0:
                    # the midpoint warm-up's second evaluation, after a
                    # first-order step to t_prev
                    eps = plms_mod._to_eps(schedule, state.sample, out, t)
                    x1 = plms_mod._x_prev(schedule, state.sample, eps, t,
                                          t_prev)
                    out_next = evaluate(x1, i, max(t_prev, 0))
                with trace.span("denoise.sampler"):
                    state, prev = plms_mod.plms_step(
                        schedule, state, out, out_next, t, t_prev, i)
                    state = state._replace(
                        sample=blend_outside_mask(prev, i, inputs))
        return state.sample

    loop = {"unipc": run_unipc, "ddim": run_ddim, "plms": run_plms,
            "dpm": run_dpm, "dpm3": run_dpm}.get(cfg.sampler, run_singlestep)

    def run(params, latents, context, inputs):
        with trace.span("denoise.hints"):
            hoisted = precompute_hints(params, inputs, latents.dtype,
                                       context)
        cache = None

        def evaluate(x, i, t):
            nonlocal cache
            x = x.to(latents.dtype)
            if k_enc == 1:
                return model_output(params, x, t, context, inputs, hoisted)
            out, cache = model_output_cached(params, x, t, context, inputs,
                                             hoisted, cache, i % k_enc == 0)
            return out

        final = loop(evaluate, latents, inputs)
        return final_paste(final, inputs).to(latents.dtype)

    return run
