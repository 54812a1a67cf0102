"""The program's spans and counters (``utils/trace.py``): off unless enabled
or profiled, on the profiler's clock, never a profiler range, nested and
bounded as documented, and placed where the edit and the training step
run."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from editanything_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def names(evs, kind=4):
    return [ev[0] for ev in evs if len(ev) == kind]


def test_off_records_nothing():
    with trace.span("a"):
        trace.count("c", 3)
        assert trace.host_read(torch.ones(2), "x", torch.Tensor.sum) == 2
    assert trace.events() == []
    assert trace.snapshot()["spans"] == {} and \
        trace.snapshot()["counters"] == {}


def test_clock_matches_the_profiler_and_opens_no_range():
    """An op issued inside a span starts, by the profiler's clock, inside
    the span's interval (within 0.5 ms); the profile holds no event named
    after a program span (a ``record_function`` range would)."""
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with trace.span("probe.outer"):
                with trace.span("probe.inner"):
                    torch.mm(x, x)
                trace.count("probe.count")
    spans = [ev for ev in trace.events() if ev[0] == "probe.inner"]
    assert len(spans) == 5
    ops = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(ops) == 5
    offsets = []
    for (_, s, e, _), t in zip(sorted(spans, key=lambda ev: ev[1]), ops):
        offsets.append((t - s) / 1e3)
        assert s - 500_000 <= t <= e + 500_000
    print(f"aten::mm start after its span's start (us): {offsets}")
    profiled = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not profiled & {"probe.outer", "probe.inner", "probe.count"}
    assert not any(n.startswith("probe.") for n in profiled)


def test_nesting_order_depth_and_the_ring():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            trace.count("k", 2)
        with trace.span("inner"):
            pass
    evs = trace.events()
    assert [(ev[0], ev[-1]) for ev in evs] == [
        ("k", 2), ("inner", 1), ("inner", 1), ("outer", 0)]
    outer, inner = evs[3], evs[1]
    assert outer[1] <= inner[1] <= inner[2] <= evs[2][1] <= outer[2]
    snap = trace.snapshot()
    assert snap["spans"]["inner"]["count"] == 2 and snap["counters"] == {
        "k": 2}
    assert set(snap["launches"]) >= {"flash_attention", "group_norm_silu"}
    for _ in range(trace.CAPACITY + 10):
        trace.count("wrap")
    evs = trace.events()
    assert len(evs) == trace.CAPACITY and set(names(evs, 3)) == {"wrap"}


@pytest.mark.parametrize("read", [torch.Tensor.cpu, int, float, bool,
                                  torch.Tensor.item, torch.Tensor.tolist])
def test_host_read_returns_the_raw_read_and_counts_its_site(read):
    x = torch.tensor([3.0]) if read is not torch.Tensor.tolist else \
        torch.arange(4.0)
    x = x.sum() if read in (int, float, bool, torch.Tensor.item) else x
    trace.enable()
    got = trace.host_read(x, "test.site", read)
    want = read(x)
    assert type(got) is type(want)
    assert (torch.equal(got, want) if isinstance(got, torch.Tensor)
            else got == want)
    assert trace.snapshot()["counters"] == {"sync.test.site": 1}
    assert names(trace.events()) == ["sync.test.site"]
    # an empty tensor copies nothing and waits on nothing
    trace.host_read(torch.zeros(0), "test.empty")
    assert "sync.test.empty" not in trace.snapshot()["counters"]


def _tiny_editor():
    from editanything_tpu_torch.models.sam import SAMConfig
    from editanything_tpu_torch.perception import AMGConfig
    from editanything_tpu_torch.pipelines.bundle import (random_bundle,
                                                         random_sam)
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    cfg = SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,
                    num_heads=2, global_attn_indexes=(1,), window_size=4,
                    out_chans=16, prompt_embed_dim=16, decoder_mlp_dim=32)
    return EditAnythingEditor(
        random_bundle(tiny=True, device="cpu"),
        sam=(cfg, random_sam(cfg, device="cpu")),
        amg_config=AMGConfig(points_per_side=4, points_per_batch=16))


def test_edit_spans_and_syncs(one_torch_thread):
    steps = 2
    ed = _tiny_editor()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    trace.enable()
    ed.process(image=img, mask=mask, prompt="a cat", image_resolution=64,
               detect_resolution=64, ddim_steps=steps)
    evs = trace.events()
    snap = trace.snapshot()
    count = {k: v["count"] for k, v in snap["spans"].items()}
    assert count["editor.process"] == count["editor.sam"] == 1
    for name in ("sam.encode", "amg.decode", "amg.select", "amg.id_map",
                 "edit.text", "edit.prepare", "denoise.hints", "vae.decode",
                 "edit.to_host"):
        assert count[name] == 1, name
    assert count["denoise.step"] == steps
    for name in ("denoise.unet", "denoise.controlnets", "denoise.sampler"):
        assert count[name] == steps, name
    step_spans = [ev for ev in evs if ev[0] == "denoise.step"]
    for name in ("denoise.unet", "denoise.controlnets", "denoise.sampler"):
        for _, s, e, depth in (ev for ev in evs if ev[0] == name):
            assert any(s0 <= s and e <= e0 and depth > d0
                       for _, s0, e0, d0 in step_spans), name
    # the edit's host waits, each site once (the slots' index twice); the
    # random AMG keeps no candidate, so the NMS reads no IoU matrix
    assert snap["counters"] == {
        "sync.sam.image": 1, "sync.sam.pixel_stats": 2, "sync.amg.points": 1,
        "sync.amg.valid_count": 1, "amg.candidates_valid": 0, "amg.kept": 0,
        "sync.amg.slots": 2, "sync.editor.id_map": 1, "sync.text.ids": 1,
        "sync.edit.condition": 1, "sync.edit.inpaint_condition": 1,
        "sync.edit.latent_inputs": 2, "sync.vae.nonfinite": 1,
        "sync.edit.images": 1}


def test_train_step_phases_and_syncs(one_torch_thread):
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.samplers.schedule import make_schedule
    from editanything_tpu_torch.train import controlnet_train as T
    b = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",))
    _, cn = b.controlnets["sam"]
    state = T.init_train_state(cn, T.make_optimizer(1e-5), use_ema=True)
    step = T.make_train_step(make_schedule())
    g = torch.Generator().manual_seed(0)
    ctx_dim = b.unet_cfg.cross_attention_dim
    batch = {"latents": torch.randn(1, 4, 8, 8, generator=g),
             "hint": torch.rand(1, 3, 64, 64, generator=g),
             "context": torch.randn(1, 77, ctx_dim, generator=g)}
    trace.enable()
    step(state, b.unet, batch, generator=g)
    snap = trace.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        "train.step": 1, "train.forward": 1, "train.backward": 1,
        "train.optimizer": 1, "train.ema": 1, "sync.train.timesteps": 1}
    assert snap["counters"] == {"sync.train.timesteps": 1,
                                "sync.train.coeffs": 2}
    step_ev = [ev for ev in trace.events() if ev[0] == "train.step"][0]
    for ev in trace.events():
        if len(ev) == 4 and ev[0] != "train.step":
            assert step_ev[1] <= ev[1] <= ev[2] <= step_ev[2]
            assert ev[3] > step_ev[3]


def test_the_port_opens_no_profiler_range():
    """No module of the port calls ``record_function``: a program span
    would otherwise be copied onto the device's timeline as work."""
    import pathlib
    import re
    import editanything_tpu_torch
    root = pathlib.Path(editanything_tpu_torch.__file__).parent
    call = re.compile(r"record_function\s*\(|RecordFunction")
    hits = [str(p.relative_to(root)) for p in root.rglob("*.py")
            if call.search(p.read_text())]
    assert hits == [], hits


def test_snapshot_lists_kernel_a_nhwc_launches(monkeypatch):
    """``group_norm_silu_nhwc``, the launches that took kernel A's NHWC
    path, beside ``group_norm_silu``; a wrapper put in the kernel's place
    that copies only ``launches`` (as a benchmark harness does) reads 0
    until the NHWC path counts on it."""
    from editanything_tpu_torch.core import kernels as K
    launches = trace.snapshot()["launches"]
    assert launches["group_norm_silu_nhwc"] == K.group_norm_silu.launches_nhwc
    assert launches["group_norm_silu_nhwc"] <= launches["group_norm_silu"]

    def wrapped(*args, **kwargs):
        return K.group_norm_silu(*args, **kwargs)
    wrapped.launches = K.group_norm_silu.launches
    monkeypatch.setattr(K, "group_norm_silu", wrapped)
    assert trace.snapshot()["launches"]["group_norm_silu_nhwc"] == 0
