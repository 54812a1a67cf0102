"""The plain reference of SAM-ControlNet training steps (the reference
application's ``sam_train_sd21.py`` on cldm_v15: the control branch
trained, the SD1.5 UNet, the VAE and CLIP frozen): the preprocessor (the
VAE posterior's mode, scaled, and the text states), the epsilon-MSE loss
on latents noised at per-sample timesteps, Adam at lr 1e-5 (torch's
defaults otherwise, no weight decay) and LitEma (decay min(0.9999,
(1 + n) / (10 + n)) at update n, counted from 0).

Each step runs one sample at a time and sums the gradients, each weighted
1 / B, so that its memory is that of one sample. Imports nothing of the
port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference.edit import schedule


def adam(params, grads, state, step, lr=1e-5, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update in place; `state` holds m and v per parameter."""
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / math.sqrt(1.0 - b2 ** step)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** step))


def ema_decay(n: int):
    """LitEma's decay at update n, and one minus it, rounded to float32 as
    the port's specification (the JAX package) computes them; the update
    is e d + (1 - d) p, which LitEma writes e - (1 - d)(e - p). The change
    of an EMA over three steps is ~1e-4 of its weights, so the rounding of
    the two forms alone would part them by ~1e-4 of that change."""
    d = np.minimum(np.float32(0.9999),
                   np.float32(1.0 + n) / np.float32(10.0 + n))
    return float(d), float(np.float32(1.0) - d)


def steps(models, batches, *, lr: float = 1e-5):
    """Train ``models["controlnet"]`` over `batches`, each {"jpg" (B, 3, H,
    W) in [-1, 1], "hint" (B, 3, H, W) in [0, 1], "ids" (B, 77), "t" (B,),
    "noise" (B, 4, h, w)}. Returns per step its loss, and for the first the
    preprocessor's latents and context and the gradient, and after the last
    the parameters and the EMA, each a name -> tensor dict."""
    unet, cn, vae, text = (models[k] for k in ("unet", "controlnet", "vae",
                                               "text"))
    ac = torch.tensor(schedule(), dtype=torch.float64)
    params = dict(cn.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()}
    state, out = {}, {"loss": []}
    for n, batch in enumerate(batches):
        with torch.no_grad():
            lat = vae.encode(batch["jpg"].float())
            ctx = text(batch["ids"].long())
        if n == 0:
            out["latents"], out["context"] = lat, ctx
        b = lat.shape[0]
        t = batch["t"].long()
        a = ac[t.cpu()].sqrt().float().to(lat.device)[:, None, None, None]
        s = (1.0 - ac[t.cpu()]).sqrt().float().to(lat.device)[:, None, None, None]
        noise = batch["noise"].float()
        noisy = a * lat + s * noise
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = 0.0
        for i in range(b):
            sl = slice(i, i + 1)
            down, mid = cn(noisy[sl], t[sl], ctx[sl], batch["hint"][sl].float())
            pred = unet(noisy[sl], t[sl], ctx[sl], down, mid)
            li = torch.mean(torch.square(pred - noise[sl]))
            g = torch.autograd.grad(li, list(params.values()),
                                    allow_unused=True)
            for (k, p), gk in zip(params.items(), g):
                if gk is not None:
                    grads[k].add_(gk, alpha=1.0 / b)
            loss += float(li.detach()) / b
        out["loss"].append(loss)
        if n == 0:
            out["grad"] = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            adam(params, grads, state, n + 1, lr=lr)
            d, one_minus = ema_decay(n)
            for k, p in params.items():
                ema[k].copy_(ema[k] * d + one_minus * p)
    out["params"] = {k: p.detach() for k, p in params.items()}
    out["ema"] = ema
    return out
