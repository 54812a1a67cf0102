"""Model FLOPs of one unit of each driver's cells, counted from shapes
(each driver's ``unit_flops`` names its function here):
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the meta device (matmuls and convolutions, forward and, for training, the
backward that autograd runs; normalisations and pointwise work are not
counted, as MFU conventionally leaves them out).

- An edit request: SAM's encoder at its input size, the mask decoder over
  every grid point, CLIP over the prompt pair, the VAE encode of the
  masked image, each step's two ControlNets (their hint stacks counted
  once a request, as the port hoists them) and UNet on the CFG batch, the
  VAE decode of the samples.
- A segment-everything request: the encoder and the decoder over every
  grid point.
- A training iteration: the preprocessor (VAE encode and CLIP) and the
  step's forward and backward (the ControlNet's weight and input
  gradients, the frozen UNet's input gradients). Recomputation under
  remat is not model work and is left out.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import weights as W


def _meta(part: str, fields: dict):
    return W.meta(*W.reference_parts(part, fields))


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def _rand(*shape):
    return torch.empty(shape, device="meta")


def sam_flops(models: dict, amg: dict, img: int = 1024) -> float:
    """The encoder at `img`^2 and the decoder over every grid point."""
    sam = _meta("sam", models["sam"])
    e = sam.cfg.embedding_size
    points = amg["points_per_side"] ** 2
    batch = amg["points_per_batch"]
    enc = _count(lambda: sam.image_encoder(_rand(1, 3, img, img)))

    def decode():
        emb, pe = _rand(1, 256, e, e), _rand(1, 256, e, e)
        for _ in range(points // batch):
            sam.mask_decoder(emb, pe, _rand(batch, 1, 256), _rand(256))
    return enc + _count(decode)


def edit_request_flops(config: dict, traffic: dict) -> float:
    m = config["models"]
    s, steps = traffic["num_samples"], traffic["steps"]
    h, w = traffic["image_hw"]
    unet, cn = _meta("unet", m["unet"]), _meta("controlnet", m["controlnet"])
    vae, text = _meta("vae", m["vae"]), _meta("text", m["text"])
    ctx_len = m["text"]["max_position_embeddings"]
    ctx_dim = m["unet"]["cross_attention_dim"]
    lat = _rand(2 * s, 4, h // 8, w // 8)
    ctx = _rand(2 * s, ctx_len, ctx_dim)
    t = torch.zeros(2 * s, dtype=torch.long, device="meta")
    hint_img = _rand(2 * s, 3, h, w)
    hint = _count(lambda: cn.controlnet_cond_embedding(hint_img))
    n_cn = len(config["controlnets"])
    step = (_count(lambda: unet(lat, t, ctx))
            + n_cn * (_count(lambda: cn(lat, t, ctx, hint_img)) - hint))
    ids = torch.zeros(2, ctx_len, dtype=torch.long, device="meta")
    once = (_count(lambda: text(ids))
            + _count(lambda: vae.encode(_rand(1, 3, h, w)))
            + _count(lambda: vae.decode(_rand(s, 4, h // 8, w // 8)))
            + n_cn * hint)
    return (sam_flops(m, config["amg"], m["sam"].get("img_size", 1024))
            + once + steps * step)


def sam_request_flops(config: dict, traffic: dict) -> float:
    m = config["models"]
    return sam_flops(m, config["amg"], m["sam"].get("img_size", 1024))


def train_iteration_flops(config: dict, traffic: dict) -> float:
    m = config["models"]
    b = config["train"]["batch_size"]
    r = config["train"]["resolution"]
    unet, cn = _meta("unet", m["unet"]), _meta("controlnet", m["controlnet"])
    vae, text = _meta("vae", m["vae"]), _meta("text", m["text"])
    unet.requires_grad_(False)
    ctx_len = m["text"]["max_position_embeddings"]
    ctx = _rand(b, ctx_len, m["unet"]["cross_attention_dim"])
    t = torch.zeros(b, dtype=torch.long, device="meta")

    def step():
        down, mid = cn(_rand(b, 4, r // 8, r // 8), t, ctx, _rand(b, 3, r, r))
        pred = unet(_rand(b, 4, r // 8, r // 8), t, ctx, down, mid)
        torch.autograd.grad(pred.square().mean(), list(cn.parameters()))
    ids = torch.zeros(b, ctx_len, dtype=torch.long, device="meta")
    return (_count(lambda: vae.encode(_rand(b, 3, r, r)))
            + _count(lambda: text(ids)) + _count(step))

