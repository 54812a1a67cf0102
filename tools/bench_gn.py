#!/usr/bin/env python3
"""Kernel A (GroupNorm+SiLU, csrc/group_norm.cu) at every GroupNorm shape of
a composed edit request on one GPU, and beside it another tree's Triton
GroupNorm, timed in turns.

    python3 tools/bench_gn.py                    # this checkout's kernel A
    python3 tools/bench_gn.py --baseline DIR     # and DIR's Triton kernel

DIR is the root of another tree whose
``editanything_tpu_torch/core/kernels.py`` holds the Triton GroupNorm (say
2cdd2d8's, unpacked with ``git archive`` into a git-ignored directory of the
repo); that file is loaded as a module of its own, its Triton cache in
build/triton.

The shapes are those of one composed 512^2 edit request (2 samples under
CFG, 30 UniPC steps), traced by building the full-width SD1.5 UNet, a
ControlNet and the VAE on the meta device with the GroupNorm wrapper
recording its calls (``trace_group_norms``; tests/test_torch_kernels.py
checks the trace on the CPU): per step the UNet and two ControlNets at
batch 4, then the VAE decoder at batch 2 and the encoder at batch 1. For
each shape, in bf16 with per-channel offsets and scales: the plan, the
launches per request, both kernels' distance from the plain twin, and in
turns (baseline, checkout, checkout, baseline):
  - ms per call over back-to-back calls (CUDA events; where the host is
    slower than the device this is the host's time);
  - ms per call with the L2 flushed (a 256 MiB write) before each call;
  - device ms per call: the kernels' own durations under torch.profiler;
  - host microseconds per call (the launch path, the device synchronised
    before and after);
and the bound (one read and one write at 3.35 TB/s) and, where there is no
SiLU, F.group_norm's times, a yardstick the port never calls. Last, the
device time per request (sum over shapes of launches x device ms) and a
JSON summary. The card's name and power limit come first. Imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from editanything_tpu_torch.core import build  # noqa: E402
from editanything_tpu_torch.core import flash_attention as FA  # noqa: E402
from editanything_tpu_torch.core import kernels as K  # noqa: E402

STEPS = 30
PEAK_BYTES = 3.35e12
BF16_TOL = 6.25e-2          # one bf16 ulp at outputs below 16 (chip_smoke.py)
FLUSH_BYTES = 256 * 2 ** 20


def trace_group_norms():
    """{model: Counter((shape, groups, eps, silu) -> calls per forward)} of
    the full-width SD1.5 UNet and ControlNet at batch 4 (64x64 latents),
    the VAE decoder at batch 2 and the encoder at batch 1 (512^2), built on
    the meta device in bf16 with the GroupNorm and attention wrappers
    recording their calls."""
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.controlnet import ControlNetModel
    from editanything_tpu_torch.models.unet import UNet2DConditionModel
    from editanything_tpu_torch.models.vae import AutoencoderKL
    calls = collections.defaultdict(collections.Counter)
    model = [None]

    def group_norm(x, weight, bias, *, num_groups=32, eps=1e-5,
                   apply_silu=True):
        calls[model[0]][tuple(x.shape), num_groups, eps, apply_silu] += 1
        return torch.empty_like(x)

    def attention(q, k, v, *, scale=None):
        return q.new_empty(q.shape[:-1] + (v.shape[-1],))

    def meta(*shape):
        return torch.empty(*shape, device="meta", dtype=torch.bfloat16)

    saved = K.group_norm_silu, FA.flash_attention
    K.group_norm_silu, FA.flash_attention = group_norm, attention
    try:
        ucfg = C.sd15_unet()
        with torch.device("meta"):
            unet = UNet2DConditionModel(ucfg).to(torch.bfloat16)
            cn = ControlNetModel(C.ControlNetConfig(unet=ucfg)).to(torch.bfloat16)
            vae = AutoencoderKL(C.VAEConfig()).to(torch.bfloat16)
        t = torch.full((4,), 500, device="meta")
        with torch.no_grad():
            model[0] = "controlnet"
            down, mid = cn(meta(4, 4, 64, 64), t, meta(4, 77, 768),
                           hint_embedding=meta(4, 320, 64, 64))
            model[0] = "unet"
            unet(meta(4, 4, 64, 64), t, meta(4, 77, 768),
                 down_block_residuals=down, mid_block_residual=mid)
            model[0] = "vae decoder"
            vae.decode(meta(2, 4, 64, 64))
            model[0] = "vae encoder"
            vae.encode(meta(1, 3, 512, 512))
    finally:
        K.group_norm_silu, FA.flash_attention = saved
    return dict(calls)


def request_calls():
    """[(shape, groups, eps, silu, launches per request)] of one composed
    edit request, the denoise loop's shapes first."""
    per_forward = {"unet": STEPS, "controlnet": 2 * STEPS,
                   "vae decoder": 1, "vae encoder": 1}
    total = collections.Counter()
    for model, counter in trace_group_norms().items():
        for key, n in counter.items():
            total[key] += n * per_forward[model]
    return sorted(((*key, n) for key, n in total.items()),
                  key=lambda r: (r[0][0] != 4, r[0][1], r[0][2], r[2]))


def load_baseline(root: str):
    """The group_norm_silu of DIR/editanything_tpu_torch/core/kernels.py
    (Triton), loaded as a module of its own."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(build.BUILD_DIR / "triton"))
    if not hasattr(build, "use_triton_cache"):   # the older tree asks for it
        build.use_triton_cache = lambda: None
    path = os.path.join(root, "editanything_tpu_torch", "core", "kernels.py")
    spec = importlib.util.spec_from_file_location("baseline_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.group_norm_silu


def cuda_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int, flush) -> float:
    """ms per call with the L2 flushed before each call."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, calls: int, tries: int = 3) -> tuple[float, int]:
    """(device ms per call, device kernels per call) under torch.profiler;
    a trace that recorded no device kernel is taken again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device kernel")
    us = sum(e.time_range.end - e.time_range.start for e in kernels)
    return us / 1e3 / calls, len(kernels) // calls


def host_us(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * host / calls


def inputs(g, shape):
    c = shape[1]
    x = (torch.randn(shape, generator=g, device="cuda")
         * (0.5 + 2 * torch.rand(1, c, 1, 1, generator=g, device="cuda"))
         + 2 * torch.randn(1, c, 1, 1, generator=g, device="cuda")).bfloat16()
    w = (1 + 0.3 * torch.randn(c, generator=g, device="cuda")).bfloat16()
    b = (0.3 * torch.randn(c, generator=g, device="cuda")).bfloat16()
    return x, w, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="root of another tree (Triton GroupNorm)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_gn: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    t0 = time.perf_counter()
    build.build_libraries(["group_norm"])
    impls = {"checkout": K.group_norm_silu}
    if args.baseline:
        impls["baseline"] = load_baseline(args.baseline)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_LOG["group_norm"]["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[ptxas] {line.strip()}")

    g = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    order = (["baseline", "checkout", "checkout", "baseline"]
             if "baseline" in impls else ["checkout", "checkout"])
    rows = []
    for shape, groups, eps, silu, launches in request_calls():
        x, w, b = inputs(g, shape)
        plan = K.group_norm_plan(*shape, groups, 2)
        want = K.group_norm_silu_reference(x, w, b, num_groups=groups,
                                           eps=eps, apply_silu=silu)
        run = {name: (lambda fn=fn: fn(x, w, b, num_groups=groups, eps=eps,
                                        apply_silu=silu))
               for name, fn in impls.items()}
        nbytes = 2.0 * x.numel() * x.element_size()
        row = {"shape": shape, "eps": eps, "silu": silu,
               "launches_per_request": launches, "plan": plan._asdict(),
               "bound_ms": 1e3 * nbytes / PEAK_BYTES}
        for name, fn in run.items():
            err = (fn().float() - want.float()).abs().max().item()
            if err > BF16_TOL:
                raise AssertionError(f"{name} at {shape}: {err} > {BF16_TOL}")
            row[f"{name} err"] = err
        reps = args.reps if nbytes < 1e8 else max(4, args.reps // 4)
        times = collections.defaultdict(lambda: collections.defaultdict(list))
        for name in order:
            fn = run[name]
            times[name]["ms"].append(cuda_ms(fn, reps))
            times[name]["cold_ms"].append(cold_ms(fn, max(4, reps // 2), flush))
            dev, kernels = device_ms(fn, max(4, reps // 2))
            times[name]["device_ms"].append(dev)
            times[name]["host_us"].append(host_us(fn, 50))
            row[f"{name} kernels per call"] = kernels
        for name, t in times.items():
            row[name] = dict(t)
        if not silu:
            lib = lambda: F.group_norm(x, groups, w, b, eps)
            row["F.group_norm ms"] = cuda_ms(lib, reps)
            row["F.group_norm cold_ms"] = cold_ms(lib, max(4, reps // 2), flush)
            row["F.group_norm device_ms"] = device_ms(lib, max(4, reps // 2))[0]
        rows.append(row)
        parts = []
        for name in times:
            t = row[name]
            parts.append(
                f"{name}: ms {' / '.join(f'{v:.4f}' for v in t['ms'])}, cold "
                f"{' / '.join(f'{v:.4f}' for v in t['cold_ms'])}, device "
                f"{' / '.join(f'{v:.4f}' for v in t['device_ms'])} "
                f"({row[name + ' kernels per call']} kernels), host us "
                f"{' / '.join(f'{v:.1f}' for v in t['host_us'])}")
        lib = ("" if silu else
               f"; F.group_norm ms {row['F.group_norm ms']:.4f}, cold "
               f"{row['F.group_norm cold_ms']:.4f}, device "
               f"{row['F.group_norm device_ms']:.4f}")
        print(f"[gn] {shape} eps={eps:g} silu={silu}: {launches} per request, "
              f"plan {plan.path} k={plan.k} ctas={plan.ctas}, bound "
              f"{row['bound_ms']:.4f} ms; " + "; ".join(parts) + lib)
        del x, w, b, want
    per_request = {}
    for name in order:
        per_request[name] = {
            what: sum(r["launches_per_request"] * min(r[name][what])
                      for r in rows)
            for what in ("device_ms", "ms", "cold_ms")}
        per_request[name]["kernels"] = sum(
            r["launches_per_request"] * r[f"{name} kernels per call"] for r in rows)
    per_request["bound_ms"] = sum(r["launches_per_request"] * r["bound_ms"]
                                  for r in rows)
    per_request["calls"] = sum(r["launches_per_request"] for r in rows)
    for name in dict.fromkeys(order):
        p = per_request[name]
        print(f"[gn] per request, {name}: device {p['device_ms']:.2f} ms, "
              f"back-to-back {p['ms']:.2f} ms, L2 flushed {p['cold_ms']:.2f} ms, "
              f"{p['kernels']} device kernels")
    print(f"[gn] per request: {per_request['calls']} calls, bound "
          f"{per_request['bound_ms']:.2f} ms")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi,
                      "per_request": per_request, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
