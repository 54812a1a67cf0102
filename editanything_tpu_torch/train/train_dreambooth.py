"""The DreamBooth-inpaint training program (full finetune and LoRA).

Counterpart of ``editanything_tpu/train/train_dreambooth.py`` (the
reference's tools/train_dreambooth_inpaint.py main :405): with prior
preservation, the class folder is first filled up to `num_class_images`
by the inference engine (:431-470, a full-image mask over a blank image
through the 9-channel UNet, which is txt2img); training batches are
[instance; class] halves with a random rectangle or ellipse mask per
sample (collate_fn :546-587); the loss is the instance eps-MSE plus
`prior_loss_weight` times the class eps-MSE (:604-630); AdamW with a
constant schedule after an optional linear warm-up; checkpoints and resume
(:655-680). The LoRA variant (utils/train_dreambooth_lora_inpaint.py)
trains rank-r deltas of the attention projections instead.

The step is train/dreambooth_inpaint.py's; class images come from the same
denoise engine as inference (engine/denoise.py, no ControlNet); the
preprocessor runs the two VAE encodes (the image and the masked image)
and takes the mask to latent resolution by JAX's nearest rule
(``jax.image.resize(..., "nearest")``: source pixel 8i + 4). Checkpoints
are train/checkpointing.py's torch files; the finetuned UNet or the LoRA
deltas are written with ``save_params`` as ``unet.pt`` or
``lora_deltas.pt`` in the output directory, where JAX writes orbax
directories. Data parallelism follows train/train_controlnet.py: each rank
takes its slice of every [instance; class] half, so it holds whole pairs.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from editanything_tpu_torch.data.image_folder import ImageFolder, list_images
from editanything_tpu_torch.parallel.sharding import (
    data_parallel, default_group, init_from_env, is_main, mean_over,
    rank_and_size, shard_batch, unwrap)
from editanything_tpu_torch.samplers.schedule import (make_schedule,
                                                      make_timesteps)
from editanything_tpu_torch.train.checkpointing import (CheckpointManager,
                                                        save_params)
from editanything_tpu_torch.train.dreambooth_inpaint import (
    AdamW, DBState, LoRADeltas, LoRAState, init_lora_deltas,
    make_db_lora_train_step, make_db_train_step, random_mask)
from editanything_tpu_torch.train.logging import MetricLogger
from editanything_tpu_torch.train.train_controlnet import global_t_noise, nchw
from editanything_tpu_torch.utils.image import resize_nearest


def host_shard(x: np.ndarray, group, blocks: int = 1) -> np.ndarray:
    """This rank's slice of a host batch, as ``shard_batch`` slices a
    tensor."""
    if rank_and_size(group)[1] == 1:
        return x
    return x[shard_batch(torch.arange(len(x)), group, blocks=blocks).numpy()]


@torch.inference_mode()
def generate_class_images(bundle, *, class_dir: str, class_prompt: str,
                          num_class_images: int, resolution: int = 512,
                          num_steps: int = 30, guidance_scale: float = 7.5,
                          batch_size: int = 2, seed: int = 0,
                          noise: Optional[Sequence] = None) -> int:
    """Fill `class_dir` up to `num_class_images` JPEGs of `class_prompt`
    (reference :431-470), txt2img through the bundle's UNet: a 9-channel
    one sees a full-image mask over a blank image. Returns how many were
    generated. Each batch's initial latents are ``noise[i]`` when given
    ((n, h/8, w/8, 4), the JAX package's layout), else drawn from a
    generator on the bundle's device seeded with `seed`. The JPEGs are
    written with PIL, imported here."""
    from PIL import Image

    from editanything_tpu_torch.engine import prompts as P
    from editanything_tpu_torch.engine.denoise import (DenoiseConfig,
                                                       build_denoiser)
    from editanything_tpu_torch.pipelines.generate import to_uint8

    os.makedirs(class_dir, exist_ok=True)
    existing = len(list_images(class_dir))
    need = num_class_images - existing
    if need <= 0:
        return 0
    b = bundle
    dev, dtype = b.device, b.dtype
    nine_ch = b.unet_cfg.in_channels == 9
    dcfg = DenoiseConfig(unet=b.unet_cfg, controlnets=(), num_steps=num_steps,
                         inpaint_mode="unet9" if nine_ch else "none")
    denoise = build_denoiser(dcfg, b.noise_schedule(),
                             make_timesteps(num_steps))
    cond, uncond = P.get_pipeline_embeds(b.text, b.tokenizer, class_prompt, "",
                                         layer_skip=b.text_cfg.layer_skip)
    h = w = resolution
    generator = torch.Generator(dev).manual_seed(seed)
    done = 0
    while done < need:
        n = min(batch_size, need - done)
        if noise is None:
            latents = torch.randn((n, 4, h // 8, w // 8), generator=generator,
                                  device=dev, dtype=torch.float32)
        else:
            latents = torch.from_numpy(np.array(
                noise[done // batch_size], np.float32)).permute(0, 3, 1, 2)
        context = {"cond": cond.expand(n, -1, -1).to(dtype),
                   "uncond": uncond.expand(n, -1, -1).to(dtype)}
        inputs = {"controlnet_conds": [], "controlnet_scales": [],
                  "guidance_scale": float(guidance_scale)}
        if nine_ch:
            # a full-image mask: the masked image is all zero in [-1, 1]
            blank = torch.zeros((n, 3, h, w), device=dev, dtype=dtype)
            inputs["mask"] = torch.ones((n, 1, h // 8, w // 8), device=dev)
            inputs["masked_image_latents"] = b.vae.encode_to_latents(
                blank).float()
        final = denoise({"unet": b.unet, "controlnets": []},
                        latents.to(dev, dtype), context, inputs)
        imgs = to_uint8(b.vae.decode_from_latents(final.to(dtype)).float()
                        .permute(0, 2, 3, 1).cpu().numpy())
        for i in range(n):
            Image.fromarray(imgs[i]).save(
                os.path.join(class_dir, f"class_{existing + done + i}.jpg"))
        done += n
    return done


class DreamBoothBatcher:
    """Host batches as the reference's collate_fn gives them (:546-587):
    images in [-1, 1], a random mask per sample, the masked image =
    image * (mask < 0.5); [instance; class] halves with a class folder."""

    def __init__(self, instance_dir: str, *, class_dir: Optional[str] = None,
                 resolution: int = 512, center_crop: bool = False,
                 seed: int = 0):
        self.instance = ImageFolder(instance_dir, resolution=resolution,
                                    center_crop=center_crop, flip_p=0.0,
                                    seed=seed)
        self.cls = ImageFolder(class_dir, resolution=resolution,
                               center_crop=center_crop, flip_p=0.0,
                               seed=seed + 1) if class_dir else None
        self.resolution = resolution
        self._rng = np.random.RandomState(seed + 2)

    def next(self, batch_size: int):
        """(images, masks (B, R, R, 1), masked images), float32 NHWC."""
        imgs = self.instance.sample_batch(batch_size)
        if self.cls is not None:
            imgs = np.concatenate([imgs, self.cls.sample_batch(batch_size)])
        r = self.resolution
        masks = np.stack([random_mask(self._rng, (r, r))
                          for _ in range(imgs.shape[0])])[..., None]
        masked = imgs * (masks < 0.5)
        return (imgs.astype(np.float32), masks.astype(np.float32),
                masked.astype(np.float32))


def make_preprocessor():
    """Returns fn(vae, imgs, masks, masked) -> (latents, latent mask,
    masked latents), fp32, without autograd: (B, 3, H, W) images in
    [-1, 1] in the VAE's dtype, (B, 1, H, W) masks taken to H/8 x W/8 by
    JAX's nearest rule."""
    @torch.no_grad()
    def fn(vae, imgs, masks, masked):
        lat = vae.encode_to_latents(imgs).float()
        mlat = vae.encode_to_latents(masked).float()
        h, w = masks.shape[-2:]
        return lat, resize_nearest(masks, (h // 8, w // 8)).float(), mlat
    return fn


def _inpaint_bundle(device, seed: int):
    """The published SD1.5 widths with the 9-channel inpaint UNet, fp32,
    drawn on `device` from `seed` (JAX's default, train_dreambooth.py:181)."""
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    return random_bundle(tiny=False, device=device, dtype=torch.float32,
                         generator=torch.Generator(device).manual_seed(seed),
                         family="sd15_inpaint", controlnet_names=())


def train(*, instance_data_dir: str, instance_prompt: str, output_dir: str,
          bundle=None, class_data_dir: Optional[str] = None,
          class_prompt: Optional[str] = None,
          with_prior_preservation: bool = False,
          prior_loss_weight: float = 1.0, num_class_images: int = 100,
          class_gen_steps: int = 30, use_lora: bool = False,
          lora_rank: int = 4, batch_size: int = 1, lr: float = 5e-6,
          lr_warmup_steps: int = 0, max_steps: int = 400,
          resolution: int = 512, center_crop: bool = False,
          ckpt_every: int = 100, log_every: int = 10, seed: int = 0,
          device="cuda", group=None):
    """Run DreamBooth-inpaint finetuning; returns the final ``DBState`` (a
    copy of the bundle's UNet, trained; the bundle's own stays as it was)
    or, with `use_lora`, the ``LoRAState`` (the bundle's UNet frozen). The
    trained copy and the LoRA deltas are fp32 whatever the bundle's dtype
    (the JAX package trains them in it): AdamW's steps of about `lr` are
    far below a bf16 weight's spacing and would round away.
    `bundle` defaults to the published SD1.5 widths with the 9-channel
    UNet, fp32, drawn on `device` from `seed`. Metrics and checkpoints go
    to `output_dir`, and a run resumes from the latest checkpoint there; at
    the end the UNet's or the deltas' parameters are written to
    ``output_dir/unet.pt`` or ``output_dir/lora_deltas.pt``. `group`: data
    parallelism as train/train_controlnet.py's (default: the default
    group when ``torch.distributed`` is initialised); `batch_size` (per
    half) must divide by the ranks; rank 0 alone generates class images
    and writes files."""
    if bundle is None:
        bundle = _inpaint_bundle(device, seed)
    dev, dtype = bundle.device, bundle.dtype
    group = default_group(group)
    main = is_main(group)

    if with_prior_preservation:
        if not (class_data_dir and class_prompt):
            raise ValueError("prior preservation needs --class-data-dir and "
                             "--class-prompt")
        if main:
            n = generate_class_images(
                bundle, class_dir=class_data_dir, class_prompt=class_prompt,
                num_class_images=num_class_images, resolution=resolution,
                num_steps=class_gen_steps, seed=seed)
            if n:
                print(f"generated {n} class images in {class_data_dir}")
        if group is not None:
            dist.barrier(group)

    batcher = DreamBoothBatcher(
        instance_data_dir,
        class_dir=class_data_dir if with_prior_preservation else None,
        resolution=resolution, center_crop=center_crop, seed=seed)
    halves = 2 if with_prior_preservation else 1

    # the frozen text contexts, once: the prompts are constant
    ctx_len = bundle.text_cfg.max_position_embeddings
    prompts = [instance_prompt] + ([class_prompt] if halves == 2 else [])
    with torch.no_grad():
        contexts = bundle.text(torch.from_numpy(bundle.tokenizer(
            prompts, pad_to=ctx_len, truncate=True)).to(dev, torch.long))
    context = torch.cat([c[None].expand(batch_size, -1, -1)
                         for c in contexts]).to(dtype)
    context = shard_batch(context, group, blocks=halves)

    schedule = make_schedule()
    optimizer = AdamW(lr, warmup_steps=lr_warmup_steps)
    plw = prior_loss_weight if with_prior_preservation else 0.0
    pre = make_preprocessor()
    bundle.unet.requires_grad_(False)
    if use_lora:
        init = init_lora_deltas(
            bundle.unet, rank=lora_rank,
            generator=torch.Generator(dev).manual_seed(seed + 1))
        deltas = LoRADeltas({p: {k: v.float() for k, v in d.items()}
                             for p, d in init.items()})
        step_fn = make_db_lora_train_step(bundle.unet_cfg, schedule, optimizer,
                                          prior_loss_weight=plw)
        state = LoRAState(deltas, optimizer(deltas.parameters()))
    else:
        unet = copy.deepcopy(bundle.unet).float().requires_grad_(True)
        step_fn = make_db_train_step(bundle.unet_cfg, schedule, optimizer,
                                     prior_loss_weight=plw)
        state = DBState(unet, optimizer(unet.parameters()))

    metrics = MetricLogger(output_dir, every=log_every, is_main=main)
    ckpt = CheckpointManager(os.path.join(output_dir, "ckpt"),
                             save_interval_steps=ckpt_every, is_main=main)
    ckpt.restore(state)
    if group is not None:
        if use_lora:
            state.deltas = data_parallel(state.deltas, group)
        else:
            state.unet = data_parallel(state.unet, group)

    generator = torch.Generator(dev).manual_seed(seed)
    step = state.step
    while step < max_steps:
        imgs, masks, masked = (host_shard(x, group, blocks=halves)
                               for x in batcher.next(batch_size))
        latents, mask_lat, masked_lat = pre(bundle.vae, nchw(imgs, dev, dtype),
                                            nchw(masks, dev),
                                            nchw(masked, dev, dtype))
        t, noise = global_t_noise(schedule, latents, generator, group,
                                  blocks=halves)
        batch = {"latents": latents, "mask": mask_lat,
                 "masked_latents": masked_lat, "context": context}
        if use_lora:
            state, m = step_fn(state, bundle.unet, batch, t=t, noise=noise)
        else:
            state, m = step_fn(state, batch, t=t, noise=noise)
        m["loss"] = mean_over(m["loss"], group)
        step = state.step
        metrics.log(step, m)
        ckpt.maybe_save(step, state)

    ckpt.save(step, state)
    ckpt.close()
    if use_lora:
        state.deltas = unwrap(state.deltas)
    else:
        state.unet = unwrap(state.unet)
    if main:
        name = "lora_deltas.pt" if use_lora else "unet.pt"
        out = os.path.join(output_dir, name)
        save_params(out, state.deltas if use_lora else state.unet)
        print(f"saved {'LoRA deltas' if use_lora else 'UNet params'} to {out}")
    return state


def main(argv=None):
    p = argparse.ArgumentParser("train-dreambooth")
    p.add_argument("--instance-data-dir", required=True)
    p.add_argument("--instance-prompt", required=True)
    p.add_argument("--output-dir", default="./runs/dreambooth")
    p.add_argument("--bundle-spec", help="json naming the checkpoints "
                   "(apps/cli.py format); random weights when omitted")
    p.add_argument("--class-data-dir")
    p.add_argument("--class-prompt")
    p.add_argument("--with-prior-preservation", action="store_true")
    p.add_argument("--prior-loss-weight", type=float, default=1.0)
    p.add_argument("--num-class-images", type=int, default=100)
    p.add_argument("--use-lora", action="store_true")
    p.add_argument("--lora-rank", type=int, default=4)
    p.add_argument("--train-batch-size", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=5e-6)
    p.add_argument("--lr-warmup-steps", type=int, default=0)
    p.add_argument("--max-train-steps", type=int, default=400)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center-crop", action="store_true")
    p.add_argument("--checkpointing-steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="under torchrun each rank takes cuda:<LOCAL_RANK>")
    args = p.parse_args(argv)

    device = init_from_env(args.device)
    bundle = None
    if args.bundle_spec:
        from editanything_tpu_torch.apps.cli import _build_bundle
        bundle, _ = _build_bundle(args.bundle_spec, device=device)
    return train(instance_data_dir=args.instance_data_dir,
                 instance_prompt=args.instance_prompt,
                 output_dir=args.output_dir, bundle=bundle,
                 class_data_dir=args.class_data_dir,
                 class_prompt=args.class_prompt,
                 with_prior_preservation=args.with_prior_preservation,
                 prior_loss_weight=args.prior_loss_weight,
                 num_class_images=args.num_class_images,
                 use_lora=args.use_lora, lora_rank=args.lora_rank,
                 batch_size=args.train_batch_size, lr=args.learning_rate,
                 lr_warmup_steps=args.lr_warmup_steps,
                 max_steps=args.max_train_steps, resolution=args.resolution,
                 center_crop=args.center_crop,
                 ckpt_every=args.checkpointing_steps, seed=args.seed,
                 device=device)


if __name__ == "__main__":
    main()
