"""ControlNet training entry point: the reference's sam_train_sd21.py.

Counterpart of ``editanything_tpu/train/train_controlnet.py`` (the
reference's sam_train_sd21.py:11-39: batch 4, lr 1e-5, SAMDataset, sample
grids every 300 steps; cldm/cldm.py:416-423: the control branch trained,
the base frozen). The VAE and CLIP encodes run in the preprocessor under
``torch.no_grad`` (the reference does them in ``get_input``,
cldm/cldm.py:318-326); torch checkpoints (train/checkpointing.py), JSONL
metrics and PNG grids replace Lightning's. Data parallelism is the
reference's DDP (parallel/sharding.py): given a process group, or under
an initialised ``torch.distributed`` (a ``torchrun`` launch), every rank
draws the crops and flips of the same global batch and decodes only its
slice, the ControlNet trains in a DDP wrap, the noise and timesteps are
drawn for the global batch and sliced, and rank 0 alone writes metrics,
grids, checkpoints and the export. Where JAX lays the ControlNet out by TP/FSDP on a mesh
(train_controlnet.py:124-131), every rank here holds all of it.

Everything runs outside the pipelines' ``torch.inference_mode``: tensors
made there cannot enter autograd, so the trainer builds its own.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from editanything_tpu_torch.parallel.sharding import (
    data_parallel, default_group, init_from_env, is_main, mean_over,
    rank_and_size, shard_batch, unwrap)
from editanything_tpu_torch.samplers.schedule import (make_schedule,
                                                      make_timesteps)
from editanything_tpu_torch.train.checkpointing import CheckpointManager
from editanything_tpu_torch.train.controlnet_train import (draw_t_noise,
                                                           init_train_state,
                                                           make_optimizer,
                                                           make_train_step)
from editanything_tpu_torch.train.logging import ImageLogger, MetricLogger


def nchw(x, device, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, C) numpy images -> (B, C, H, W) on `device` in `dtype`."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).cpu().numpy()


def global_t_noise(schedule, latents, generator, group, blocks: int = 1):
    """A step's timesteps and noise drawn for the global batch (t first,
    then the noise, as the step itself draws them) and sliced to this
    rank's shard of `latents`."""
    size = rank_and_size(group)[1]
    whole = latents.new_empty((latents.shape[0] * size,) + latents.shape[1:])
    t, noise = draw_t_noise(schedule, whole, generator)
    return (shard_batch(t, group, blocks=blocks),
            shard_batch(noise, group, blocks=blocks))


def make_preprocessor():
    """Returns fn(vae, text, jpg, ids) -> (latents, context): the scaled
    latents (posterior mode) of `jpg` (B, 3, H, W) in [-1, 1] and the text
    states of `ids` (B, L), without autograd; the hint passes through."""
    @torch.no_grad()
    def fn(vae, text, jpg, ids):
        return vae.encode_to_latents(jpg), text(ids)
    return fn


def make_sample_program(unet_cfg, cn_cfg, schedule, *, num_steps: int = 20,
                        guidance_scale: float = 9.0):
    """In-training sampling previews (the reference's ``log_images`` DDIM
    grids, cldm/logger.py:27-76, cldm/cldm.py:348-406): DDIM with CFG over
    the training hints with the given (current or EMA) ControlNet, through
    ``engine/denoise.py``.

    Returns fn(unet, controlnet, vae, latents, context, hint) -> images
    (B, 3, 8h, 8w) in [-1, 1]; context = {"cond": (B, N, D), "uncond":
    (B, N, D)}, latents the initial noise."""
    from editanything_tpu_torch.engine.denoise import (DenoiseConfig,
                                                       build_denoiser)
    dcfg = DenoiseConfig(unet=unet_cfg, controlnets=(cn_cfg,),
                         num_steps=num_steps, sampler="ddim")
    denoise = build_denoiser(dcfg, schedule, make_timesteps(num_steps))

    @torch.no_grad()
    def program(unet, controlnet, vae, latents, context, hint):
        inputs = {"controlnet_conds": [hint], "controlnet_scales": [1.0],
                  "guidance_scale": float(guidance_scale)}
        final = denoise({"unet": unet, "controlnets": [controlnet]}, latents,
                        context, inputs)
        return vae.decode_from_latents(final.to(latents.dtype))

    return program


def export_controlnet(controlnet, path: str) -> None:
    """A ControlNet's weights as a diffusers-layout ``.safetensors`` in fp32
    (its ``state_dict`` keys are diffusers', as JAX's ``tree_to_diffusers``
    lays them out)."""
    from editanything_tpu_torch.checkpoints.safetensors_io import save_file
    save_file({k: v.detach().float().contiguous()
               for k, v in controlnet.state_dict().items()}, path)


def train(*, data_path: str, txt_path: str, out_dir: str, bundle=None,
          batch_size: int = 4, lr: float = 1e-5, max_steps: int = 10000,
          resolution: int = 512, log_every: int = 10, image_every: int = 300,
          ckpt_every: int = 1000, seed: int = 0, remat=True,
          use_ema: bool = True, config_yaml=None, sample_steps: int = 20,
          sample_guidance: float = 9.0, export_path: Optional[str] = None,
          device="cuda", group=None):
    """Train the bundle's "sam" ControlNet on an SA-1B-layout folder.
    `bundle` supplies the frozen UNet, VAE and text tower and the
    ControlNet's initial weights (default: ``random_bundle`` at the
    published SD1.5 widths, fp32, drawn on `device` from `seed`). Returns
    the ``TrainState``.

    - use_ema: LitEma shadow weights (on by default, as the reference's
      ldm/models/diffusion/ddpm.py:57,94-95), checkpointed with the state,
      exported and sampled;
    - config_yaml: a cldm YAML (a path or the parsed dict) whose noise
      schedule and prediction type (v for SD2.1) replace SD1.5's eps
      schedule;
    - every `image_every` steps, DDIM previews (`sample_steps` steps, CFG
      `sample_guidance`) of a fixed batch, the first one trained on, with
      the current and the EMA ControlNet: input / hint / reconstruction /
      samples / samples_ema grids;
    - a checkpoint every `ckpt_every` steps and at the end; a run finds the
      latest in ``out_dir/ckpt`` and resumes from it;
    - export_path: the final ControlNet (EMA weights with EMA) as a
      diffusers-layout ``.safetensors``;
    - group: the ``torch.distributed`` group of data parallelism (default:
      the default group when one is initialised, else none): each rank
      takes its slice of every global batch of `batch_size`, which must
      divide by the ranks, and the ControlNet trains in a DDP wrap. N
      ranks train as one process on the whole batch does."""
    from editanything_tpu_torch.data import SAMDataset, make_batcher

    if bundle is None:
        from editanything_tpu_torch.pipelines.bundle import random_bundle
        bundle = random_bundle(
            tiny=False, device=device, dtype=torch.float32,
            generator=torch.Generator(device).manual_seed(seed),
            controlnet_names=("sam",))
    dev, dtype = bundle.device, bundle.dtype
    cn_cfg, controlnet = bundle.controlnets["sam"]
    if config_yaml is not None:
        from editanything_tpu_torch.checkpoints.legacy import \
            configs_from_cldm_yaml
        schedule = configs_from_cldm_yaml(config_yaml)["schedule"]
    else:
        schedule = make_schedule()
    bundle.unet.requires_grad_(False)
    train_step = make_train_step(schedule, remat=remat)
    state = init_train_state(controlnet, make_optimizer(lr), use_ema=use_ema)
    pre = make_preprocessor()
    sample = make_sample_program(bundle.unet_cfg, cn_cfg, schedule,
                                 num_steps=sample_steps,
                                 guidance_scale=sample_guidance)

    dataset = SAMDataset(data_path, txt_path, resolution=resolution, seed=seed)
    group = default_group(group)
    main = is_main(group)
    metrics_log = MetricLogger(out_dir, every=log_every, is_main=main)
    image_log = ImageLogger(out_dir, every=image_every, is_main=main)
    ckpt = CheckpointManager(out_dir + "/ckpt", save_interval_steps=ckpt_every,
                             is_main=main)
    ckpt.restore(state)
    if group is not None:
        state.controlnet = data_parallel(state.controlnet, group)

    generator = torch.Generator(dev).manual_seed(seed)
    ctx_len = bundle.text_cfg.max_position_embeddings
    val = None     # the fixed batch of the sampling previews

    def token_ids(texts):
        return torch.from_numpy(bundle.tokenizer(
            texts, pad_to=ctx_len, truncate=True)).to(dev, torch.long)

    @torch.no_grad()
    def sample_grids(batch, latents, context_cond):
        """input / hint / reconstruction / samples (/ samples_ema) grids,
        cldm log_images' set."""
        uncond = bundle.text(token_ids([""] * latents.shape[0]))
        ctx = {"cond": context_cond.to(dtype), "uncond": uncond.to(dtype)}
        noise = torch.randn(latents.shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(seed + 7)
                            ).to(dtype)
        hint = nchw(batch["hint"], dev, dtype)
        grids = {"input": batch["jpg"], "hint": batch["hint"],
                 "reconstruction": nhwc(bundle.vae.decode_from_latents(
                     latents.to(dtype))),
                 "samples": nhwc(sample(bundle.unet, unwrap(state.controlnet),
                                        bundle.vae, noise, ctx, hint))}
        if state.ema is not None:
            grids["samples_ema"] = nhwc(sample(bundle.unet, state.ema,
                                               bundle.vae, noise, ctx, hint))
        return grids

    step = state.step
    while step < max_steps:
        for batch in make_batcher(dataset, batch_size=batch_size,
                                  seed=seed + step,
                                  part=rank_and_size(group)):
            latents, context = pre(bundle.vae, bundle.text,
                                   nchw(batch["jpg"], dev, dtype),
                                   token_ids(batch["txt"]))
            if val is None:
                val = (batch, latents, context)
            latents = latents.to(dtype)
            t, noise = global_t_noise(schedule, latents, generator, group)
            state, m = train_step(
                state, bundle.unet,
                {"latents": latents, "context": context.to(dtype),
                 "hint": nchw(batch["hint"], dev, dtype)}, t=t, noise=noise)
            m["loss"] = mean_over(m["loss"], group)
            step = state.step
            metrics_log.log(step, m)
            if image_log.is_main and step % image_log.every == 0:
                image_log.maybe_log(step, sample_grids(*val))
            ckpt.maybe_save(step, state)
            if step >= max_steps:
                break
    ckpt.save(step, state)
    ckpt.close()
    state.controlnet = unwrap(state.controlnet)
    if export_path and main:
        export_controlnet(state.ema if state.ema is not None
                          else state.controlnet, export_path)
    return state


def main(argv=None):
    p = argparse.ArgumentParser("train-controlnet")
    p.add_argument("--data-path", required=True)
    p.add_argument("--txt-path", required=True)
    p.add_argument("--out-dir", default="./runs/controlnet")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--config-yaml", default=None,
                   help="cldm YAML for schedule/v-pred (cldm_v21.yaml)")
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--export-path", default=None,
                   help="final (EMA) ControlNet as diffusers safetensors")
    p.add_argument("--device", default="cuda",
                   help="under torchrun: cuda:<LOCAL_RANK> of each rank")
    args = p.parse_args(argv)
    device = init_from_env(args.device)
    train(data_path=args.data_path, txt_path=args.txt_path,
          out_dir=args.out_dir, batch_size=args.batch_size, lr=args.lr,
          max_steps=args.max_steps, resolution=args.resolution,
          config_yaml=args.config_yaml, use_ema=not args.no_ema,
          export_path=args.export_path, device=device)


if __name__ == "__main__":
    main()
