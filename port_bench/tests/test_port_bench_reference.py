"""The plain reference held against the port's plain paths at tiny widths
on the CPU, in fp32: one state dict drawn by the benchmark loads strictly
into both, and each model, the AMG's candidates, UniPC and the training
step agree. The VAE encoder's published padding is shown to differ from
the port's (the departure PERF.md names), and the resizes against PIL.
This file imports both; the reference imports nothing of the port
(test_port_bench_harness.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import build
from port_bench import weights as W
from port_bench.reference import image as RI
from port_bench.reference import nn as P
from port_bench.reference import sam as RS
from port_bench.reference import sd as RD

CLASSES = {"unet": RD.UNet, "controlnet": RD.ControlNet, "vae": RD.VAE,
           "text": RD.CLIPText, "sam": RS.Sam}


def pair(tiny, part, cell="edit_ui", seed=5):
    """(port module, reference module) holding one drawn state dict."""
    _, _, config = tiny.cell(cell)
    fields = config["models"][part]
    state = W.model_weights(part, fields, seed, part, "cpu", torch.float32)
    _, port = build.port_module(part, fields, state)
    ref = W.reference_module(CLASSES[part], W.reference_config(part, fields),
                             state, "cpu")
    return port, ref


def close(a, b, rel):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max()) <= rel


@torch.no_grad()
def test_unet_and_controlnet(tiny):
    unet, runet = pair(tiny, "unet")
    cn, rcn = pair(tiny, "controlnet")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 16, 16, generator=g)
    t = torch.tensor([17, 803])
    ctx = torch.randn(2, 77, 32, generator=g)
    hint = torch.rand(2, 3, 128, 128, generator=g)
    down, mid = cn(x, t, ctx, hint, conditioning_scale=0.5)
    rdown, rmid = rcn(x, t, ctx, hint, 0.5)
    assert all(close(a, b, 1e-5) for a, b in zip(down, rdown))
    assert close(mid, rmid, 1e-5)
    assert close(unet(x, t, ctx, down_block_residuals=down,
                      mid_block_residual=mid),
                 runet(x, t, ctx, rdown, rmid), 1e-5)


@torch.no_grad()
def test_vae_and_text(tiny):
    vae, rvae = pair(tiny, "vae")
    img = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    img = img * 2 - 1
    assert close(vae.encode_to_latents(img), rvae.encode(img), 1e-5)
    z = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(2))
    assert close(vae.decode_from_latents(z), rvae.decode(z), 1e-5)
    text, rtext = pair(tiny, "text")
    ids = torch.randint(0, 49408, (2, 77),
                        generator=torch.Generator().manual_seed(3))
    assert close(text(ids), rtext(ids), 1e-5)


@torch.no_grad()
def test_vae_encoder_published_padding_differs(tiny):
    """The departure: the published encoder pads right and bottom before
    its stride-2 convs, the port (as the JAX package) on every side."""
    _, _, config = tiny.cell("edit_ui")
    fields = config["models"]["vae"]
    state = W.model_weights("vae", fields, 5, "vae", "cpu", torch.float32)
    cfg = W.reference_config("vae", {**fields, "published_encoder_pad": True})
    published = W.reference_module(RD.VAE, cfg, state, "cpu")
    _, port = build.port_module("vae", fields, state)
    img = torch.rand(1, 3, 64, 64) * 2 - 1
    assert not close(port.encode_to_latents(img), published.encode(img), 1e-2)


@torch.no_grad()
def test_sam_encoder_and_candidates(tiny):
    from editanything_tpu_torch.perception import amg as PA
    sam, rsam = pair(tiny, "sam")
    x = torch.randn(1, 3, 128, 128, generator=torch.Generator().manual_seed(4))
    emb, remb = sam.image_encoder(x), rsam.image_encoder(x)
    assert close(emb, remb, 1e-5)
    _, _, config = tiny.cell("sam_amg")
    cfg = build.amg_config(type("R", (), {"config": config})())
    pts = torch.from_numpy(PA._grid_points(cfg, 128, 128))
    logits, iou = PA.decode_candidates(sam, cfg, emb, pts)
    ramg = RS.AMGConfig(points_per_side=8, points_per_batch=16)
    rlogits, riou = RS.candidates(rsam, ramg, remb, pts)
    assert close(logits, rlogits, 1e-4)
    assert close(iou, riou, 1e-4)
    rows = torch.tensor([0, 5, 7, 100])
    picked, _ = RS.candidates(rsam, ramg, remb, pts, rows=rows)
    assert close(picked, rlogits[rows], 1e-5)


def test_unipc_matches_the_port():
    """The reference's UniPC against the port's loop on a linear model."""
    from editanything_tpu_torch.samplers import schedule as S
    from editanything_tpu_torch.samplers import unipc as U
    from port_bench.reference import edit as RE
    sched = S.make_schedule()
    ts = [int(t) for t in S.make_timesteps(30)]
    assert ts == RE.timesteps(30)
    x0 = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(6))

    def model(x, t):
        return 0.3 * x + 0.01 * t / 1000.0
    state = U.unipc_init(x0)
    for i in range(30):
        state, prev = U.unipc_step(sched, state, model(state.sample, ts[i]),
                                   ts, step=i)
    want = RE.unipc(model, x0.double(), ts, RE.schedule())
    assert close(state.sample, want, 1e-5)


def test_fp8_rounding():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(7))
    err = float((P.fp8(x) - x).abs().max() / x.abs().max())
    assert 1e-3 < err < 2 ** -4


@pytest.mark.parametrize("size,out", [((37, 53), (64, 96)),
                                      ((300, 200), (64, 48)),
                                      ((512, 512), (1024, 1024))])
def test_resizes_against_pil(size, out):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    for filt, code in (("bilinear", pil.BILINEAR), ("lanczos", pil.LANCZOS),
                       ("box", pil.BOX)):
        want = np.asarray(pil.fromarray(img).resize(out[::-1], code))
        got = RI.resize_pil(img, out, filt)
        assert np.abs(got.astype(int) - want).max() <= 1, filt


def test_resize_image_and_nearest():
    img = np.zeros((512, 512, 3), np.uint8)
    assert RI.resize_image(img, 1024).shape == (1024, 1024, 3)
    assert RI.resize_image(img, 512) is img
    m = np.arange(16).reshape(4, 4)
    assert RI.resize_nearest(m, (2, 2)).tolist() == [[5, 7], [13, 15]]
