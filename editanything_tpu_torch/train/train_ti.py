"""The textual-inversion training program.

Counterpart of ``editanything_tpu/train/train_ti.py`` (the reference's
utils/texutal_inversion.py main :563, as utils/run_texutal_inversion.sh
runs it: SD1.5, placeholder "<new-obj>", initializer "mark", 10 vectors,
batch 4, 3000 steps, lr 5e-4 scaled by the batch, constant schedule) and of
the cross-image-drag flow (editany_lora.py:732-745): the editor stages the
masked reference crop, this program learns the placeholder's rows from
that folder, and the embedding file feeds ``process(ref_textinv_path=...)``.
Around the step of train/textual_inversion.py it adds the image folder with
template prompts, the VAE encode (a posterior sample, its noise drawn from
the program's generator and passed in), lr scaling, checkpoint and resume,
progress saves (the learned rows as ``.npy``), and the CLI's main.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Optional

import numpy as np
import torch

from editanything_tpu_torch.data.image_folder import ImageFolder
from editanything_tpu_torch.samplers.schedule import make_schedule
from editanything_tpu_torch.train.checkpointing import CheckpointManager
from editanything_tpu_torch.train.logging import MetricLogger
from editanything_tpu_torch.train.textual_inversion import (
    IMAGENET_TEMPLATES_SMALL, add_placeholder_tokens, init_ti_state,
    learned_embeddings, make_ti_train_step, placeholder_prompt_ids)
from editanything_tpu_torch.train.train_controlnet import nchw

# the reference's :456-474 (learnable_property="style")
IMAGENET_STYLE_TEMPLATES_SMALL = [
    "a painting in the style of {}", "a rendering in the style of {}",
    "a cropped painting in the style of {}",
    "the painting in the style of {}",
    "a clean painting in the style of {}",
    "a dirty painting in the style of {}",
    "a dark painting in the style of {}", "a picture in the style of {}",
    "a cool painting in the style of {}",
    "a close-up painting in the style of {}",
    "a bright painting in the style of {}",
    "a good painting in the style of {}",
]


def save_embedding(path: str, embeds) -> None:
    """The learned rows (num_vectors, D) as a float32 ``.npy`` at exactly
    `path` (``checkpoints/lora.py::load_ti_file`` reads it back)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.save(f, np.asarray(torch.as_tensor(embeds).float().cpu()))


def train_textual_inversion(
        *, data_dir: str, output_path: str, bundle=None,
        placeholder_token: str = "<new-obj>",
        initializer_token: str = "mark",
        num_vectors: int = 10, learnable_property: str = "object",
        max_steps: int = 3000, lr: float = 5e-4, scale_lr: bool = True,
        batch_size: int = 4, resolution: int = 512,
        center_crop: bool = False, flip_p: float = 0.5,
        save_steps: int = 500, out_dir: Optional[str] = None,
        ckpt_every: int = 500, log_every: int = 50, seed: int = 0,
        device="cuda"):
    """Learn the placeholder's rows from a folder of images. Returns
    (TIState, placeholder ids); writes the rows to `output_path`, registers
    the placeholder with the bundle's tokenizer and leaves the learned rows
    in the bundle's text tower, so prompts with the placeholder use them.
    `bundle` defaults to ``random_bundle`` at the published SD1.5 widths,
    fp32, drawn on `device` from `seed`. With `out_dir`, metrics and
    checkpoints go there and a run resumes from the latest."""
    if bundle is None:
        from editanything_tpu_torch.pipelines.bundle import random_bundle
        bundle = random_bundle(
            tiny=False, device=device, dtype=torch.float32,
            generator=torch.Generator(device).manual_seed(seed),
            controlnet_names=())
    dev, dtype = bundle.device, bundle.dtype
    tok, text = bundle.tokenizer, bundle.text
    placeholder_ids = add_placeholder_tokens(
        text, tok, num_vectors=num_vectors, initializer_token=initializer_token)
    tok.add_placeholder(placeholder_token, placeholder_ids)

    templates = IMAGENET_STYLE_TEMPLATES_SMALL \
        if learnable_property == "style" else IMAGENET_TEMPLATES_SMALL
    ctx_len = bundle.text_cfg.max_position_embeddings
    prompt_rows = np.asarray([
        placeholder_prompt_ids(tok, t, placeholder_ids, ctx_len)
        for t in templates], np.int64)

    dataset = ImageFolder(data_dir, resolution=resolution,
                          center_crop=center_crop, flip_p=flip_p, seed=seed)
    if scale_lr:
        lr = lr * batch_size    # the reference's --scale_lr, one process
    text.requires_grad_(False)
    bundle.unet.requires_grad_(False)
    step_fn = make_ti_train_step(make_schedule(), placeholder_ids)
    state = init_ti_state(text, functools.partial(torch.optim.Adam, lr=lr))

    metrics = ckpt = None
    if out_dir:
        metrics = MetricLogger(out_dir, every=log_every)
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"),
                                 save_interval_steps=ckpt_every)
        ckpt.restore(state)

    rng = np.random.RandomState(seed)
    generator = torch.Generator(dev).manual_seed(seed)
    step = state.step
    while step < max_steps:
        imgs = dataset.sample_batch(batch_size)
        ids = prompt_rows[rng.randint(0, len(prompt_rows), size=batch_size)]
        with torch.no_grad():
            post = bundle.vae.encode(nchw(imgs, dev, dtype))
            vae_noise = torch.randn(post.mean.shape, generator=generator,
                                    device=dev)
            latents = post.sample(vae_noise) * bundle.vae_cfg.scaling_factor
        state, m = step_fn(state, text, bundle.unet,
                           {"latents": latents.float(), "input_ids": ids},
                           generator=generator)
        step = state.step
        if metrics is not None:
            metrics.log(step, m)
        if ckpt is not None:
            ckpt.maybe_save(step, state)
        if step % save_steps == 0 or step >= max_steps:
            save_embedding(output_path,
                           learned_embeddings(state, placeholder_ids))

    save_embedding(output_path, learned_embeddings(state, placeholder_ids))
    if ckpt is not None:
        ckpt.save(step, state)
        ckpt.close()
    # the learned rows into the live bundle, so a later
    # process(ref_textinv_path=...) or a prompt with the placeholder uses
    # them without a reload (editany_lora.py:734)
    with torch.no_grad():
        text.embeddings.token_embedding.weight.copy_(state.embeddings)
    return state, placeholder_ids


def main(argv=None):
    p = argparse.ArgumentParser("train-ti")
    p.add_argument("--train-data-dir", required=True,
                   help="folder of images (the editor stages the ref crop "
                        "under ./utils/tmp/textinv/img)")
    p.add_argument("--output", default="./utils/tmp/textinv/model/"
                   "learned_embeds.npy")
    p.add_argument("--placeholder-token", default="<new-obj>")
    p.add_argument("--initializer-token", default="mark")
    p.add_argument("--num-vectors", type=int, default=10)
    p.add_argument("--learnable-property", default="object",
                   choices=("object", "style"))
    p.add_argument("--max-train-steps", type=int, default=3000)
    p.add_argument("--learning-rate", type=float, default=5e-4)
    p.add_argument("--no-scale-lr", action="store_true")
    p.add_argument("--train-batch-size", type=int, default=4)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center-crop", action="store_true")
    p.add_argument("--save-steps", type=int, default=500)
    p.add_argument("--out-dir", default="./runs/ti")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    train_textual_inversion(
        data_dir=args.train_data_dir, output_path=args.output,
        placeholder_token=args.placeholder_token,
        initializer_token=args.initializer_token,
        num_vectors=args.num_vectors,
        learnable_property=args.learnable_property,
        max_steps=args.max_train_steps, lr=args.learning_rate,
        scale_lr=not args.no_scale_lr, batch_size=args.train_batch_size,
        resolution=args.resolution, center_crop=args.center_crop,
        save_steps=args.save_steps, out_dir=args.out_dir, seed=args.seed,
        device=args.device)
    print("saved embedding:", args.output)


if __name__ == "__main__":
    main()
