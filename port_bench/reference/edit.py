"""The plain reference of one EditAnything edit request: SAM's ID map of
the image, then the 512^2 inpaint edit with the SAM and inpaint
ControlNets under classifier-free guidance, UniPC (bh2, order 2, data
prediction, as diffusers' UniPCMultistepScheduler with its defaults) and
the blend of the original latents outside the mask, then the VAE decode
to uint8.

From the reference application (EditAnything's ``editany_lora.py``
``process``, its ``StableDiffusionControlNetInpaintMixingPipeline``) at
the UI's default operating point. Departures, each the port's
specification (the JAX package's) and noted in PERF.md: the condition map
and the scale of the masks are resized with an antialiased bilinear
resize (``jax.image.resize``) where the reference uses OpenCV's; the VAE
encoder's downsamplers pad one pixel on every side (see ``sd.py``).
Imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import image as I
from port_bench.reference import sam as S


def schedule(num_train: int = 1000, beta_start: float = 0.00085,
             beta_end: float = 0.012) -> np.ndarray:
    """SD's scaled-linear alphas_cumprod (float64 math, kept as float32)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)


def timesteps(steps: int, num_train: int = 1000) -> list:
    """UniPC's "linspace" grid, descending."""
    return [int(t) for t in np.linspace(0, num_train - 1, steps + 1)
            .round()[::-1][:-1]]


def _alpha_sigma(ac, t):
    abar = ac[t] if t >= 0 else 1.0
    return math.sqrt(abar), math.sqrt(1.0 - abar)


def _lam(ac, t):
    a, s = _alpha_sigma(ac, t)
    return math.log(a) - math.log(s)


def unipc(evaluate, x, ts, ac, order: int = 2):
    """UniPC multistep (bh2, data prediction) over the grid `ts`, the
    predictor's order lowered at warm-up and at the last step, and the
    corrector applied to every step but the first. `evaluate(x, t)` is the
    guided noise prediction."""
    n = len(ts)
    m_hist, t_hist, last = [None, None], [0, 0], None
    for i, t in enumerate(ts):
        a, s = _alpha_sigma(ac, t)
        m_t = (x - s * evaluate(x, t)) / a
        s0, s1 = t_hist
        m0, m1 = m_hist
        if i > 0:
            # corrector of the previous step, from the sample it started at
            c_order = min(order, i, n - i + 1)
            at, st = _alpha_sigma(ac, t)
            _, ss0 = _alpha_sigma(ac, s0)
            h = _lam(ac, t) - _lam(ac, s0)
            phi = math.expm1(-h)
            x = st / ss0 * last - at * phi * m0
            if c_order < 2:
                x = x - at * phi * 0.5 * (m_t - m0)
            else:
                r0 = (_lam(ac, s1) - _lam(ac, s0)) / h
                b1 = (phi / -h - 1.0) / phi
                b2 = 2.0 * ((phi / -h - 1.0) / -h - 0.5) / phi
                rho0 = (b1 - b2) / (1.0 if r0 == 1.0 else 1.0 - r0)
                rho1 = b1 - rho0
                d10 = (m1 - m0) / (r0 if r0 != 0 else 1.0)
                x = x - at * phi * (rho0 * d10 + rho1 * (m_t - m0))
        p_order = min(i + 1, order, n - i)
        if i + 1 == n:
            # to the clean state (sigma 0): the data prediction itself
            x = m_t
            break
        t_next = ts[i + 1]
        at, st = _alpha_sigma(ac, t_next)
        h = _lam(ac, t_next) - _lam(ac, t)
        phi = math.expm1(-h)
        prev = st / s * x - at * phi * m_t
        if p_order >= 2:
            r0 = (_lam(ac, s0) - _lam(ac, t)) / h
            rho_p = (phi / -h - 1.0) / phi
            prev = prev - at * phi * rho_p * (m0 - m_t) / (r0 if r0 != 0
                                                           else 1.0)
        last, m_hist, t_hist = x, [m_t, m0], [t, s0]
        x = prev
    return x


@torch.no_grad()
def sam_condition(sam, amg, image: np.ndarray, device, rows=None):
    """The SAM phase of a request on a uint8 image: the embedding, the
    candidates' IoUs (all) and logits (`rows`, or all), and the ID map at
    the image's size."""
    x, (nh, nw) = S.preprocess(image, sam.cfg, device)
    emb = sam.image_encoder(x)
    pts = torch.from_numpy(S.grid_points(amg, nh, nw)).to(device)
    logits, iou = S.candidates(sam, amg, emb, pts)
    chosen = S.select(logits, iou, amg)
    cond = S.id_map(logits, chosen, image.shape[:2], amg.mask_threshold)
    picked = logits if rows is None else logits[torch.as_tensor(
        rows, device=logits.device)]
    return {"embedding": emb, "iou": iou, "logits": picked, "id_map": cond}


def bilinear(x, size):
    """Antialiased bilinear with half-pixel centres (``jax.image.resize``)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


@torch.no_grad()
def edit(models, req: dict, device, *, steps: int, guidance: float,
         control_scale: float):
    """One ``process`` request with no condition map given. `models`:
    {"unet", "controlnets": [sam, inpaint], "vae", "text", "sam", "amg"};
    `req`: image (H, W, 3) uint8, mask (H, W) uint8, cond_ids and
    uncond_ids (W, 77) int, noise (S, 4, h, w) fp32, resolution,
    detect_resolution. Returns the SAM phase's outputs, the final latents
    and the uint8 images."""
    sam_out = sam_condition(models["sam"], models["amg"],
                            I.resize_image(req["image"],
                                           req["detect_resolution"]),
                            device, rows=req.get("rows"))
    img = I.resize_image(req["image"], req["resolution"])
    h, w = img.shape[:2]
    m = req["mask"].astype(np.float32)
    if m.max() > 1.5:
        m = m / 255.0
    m = (I.resize_nearest(m, (h, w)) >= 0.5).astype(np.float32)
    noise = req["noise"].to(device).float()
    n = noise.shape[0]

    text = models["text"]
    ids = torch.from_numpy(np.concatenate([req["cond_ids"],
                                           req["uncond_ids"]])).to(device)
    hid = text(ids.long())
    wn = req["cond_ids"].shape[0]
    cond = hid[:wn].reshape(1, -1, hid.shape[-1]).expand(n, -1, -1)
    uncond = hid[wn:].reshape(1, -1, hid.shape[-1]).expand(n, -1, -1)
    ctx = torch.cat([uncond, cond])

    id_map = torch.from_numpy(sam_out["id_map"].astype(np.float32) / 255.0)
    sam_hint = bilinear(id_map.permute(2, 0, 1)[None], (h, w)).to(device)
    img01 = img.astype(np.float32) / 255.0
    inp = img01.copy()
    inp[m > 0.5] = -1.0
    inp_hint = torch.from_numpy(inp).permute(2, 0, 1)[None].to(device)
    hints = [sam_hint.expand(2 * n, -1, -1, -1),
             inp_hint.expand(2 * n, -1, -1, -1)]
    scales = [control_scale, 1.0]

    masked = img01 * (m[..., None] < 0.5) * 2.0 - 1.0
    x_in = torch.from_numpy(masked).permute(2, 0, 1)[None].to(device)
    image_lat = models["vae"].encode(x_in).expand(n, -1, -1, -1)
    mask_lat = torch.from_numpy(I.resize_nearest(m, (h // 8, w // 8))).to(
        device)[None, None]

    def evaluate(x, t):
        lat = torch.cat([x, x])
        tb = torch.full((2 * n,), t, device=device, dtype=torch.long)
        down = mid = None
        for net, hint, s in zip(models["controlnets"], hints, scales):
            d, md = net(lat, tb, ctx, hint, s)
            down = d if down is None else [a + b for a, b in zip(down, d)]
            mid = md if mid is None else mid + md
        out = models["unet"](lat, tb, ctx, down, mid)
        u, c = out.chunk(2)
        return u + guidance * (c - u)

    final = unipc(evaluate, noise, timesteps(steps), schedule())
    final = mask_lat * final + (1.0 - mask_lat) * image_lat
    imgs = models["vae"].decode(final).permute(0, 2, 3, 1)
    images = ((imgs + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return sam_out, final, images.cpu().numpy()
