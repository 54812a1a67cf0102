#!/usr/bin/env python3
"""Kernel B's fp32 path (csrc/flash_attention.cu, the trainers' dtype) on one
GPU at the shapes of a ControlNet training step, and beside it the same
kernel built from another source, timed in turns.

    python3 tools/bench_flash_f32.py                     # this checkout's B
    python3 tools/bench_flash_f32.py --baseline DIR      # and DIR's

DIR is a ``csrc`` directory of another tree (say an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory of the repo);
its ``flash_attention.cu`` is compiled with its own ``common.cuh`` into
build/ and called through its own C interface: ``ea_flash_attention_f32``
with this checkout's plan (core/flash_attention.py::flash_f32_plan) where
it has that entry, else ``ea_flash_attention`` with dtype 0 (the fp32
kernel of trees before the plan). The shapes are chip_smoke.py's
``TRAIN_ATTN_SHAPES`` (the UNet's and ControlNet's attention at 512^2,
batch 2, and the VAE encoder's 512-deep mid attention), q, k and v drawn
from a seed, TF32 off. For each it prints:
  - the plan (path, block, key chunks, blocks, shared memory);
  - both kernels' max abs error against the plain twin (bound 1e-4);
  - their times in turns, baseline, checkout, checkout, baseline (CUDA
    events over --reps calls after a warm-up each; the checkout through its
    wrapper, scratch allocation included), the twin's and SDPA fp32's;
  - the device time of each kernel of one checkout call (torch.profiler);
  - where the plan splits the keys, the same kernel with one chunk (the
    plan's block, fewer blocks), in turns with the plan, with --one-chunk;
  - the bound: the products at 165 TFLOP/s (495 TF32 over 3 passes) and,
    beside it, at 67 TFLOP/s fp32, or the bytes at 3.35 TB/s.
First the card's name and power limit and what ptxas said of each fp32
kernel; last a JSON summary. Imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from editanything_tpu_torch.core import build  # noqa: E402
from editanything_tpu_torch.core import flash_attention as FA  # noqa: E402


def build_baseline(csrc: str) -> tuple[ctypes.CDLL, str]:
    """nvcc csrc/flash_attention.cu (with its own headers) into build/."""
    src = os.path.join(os.path.abspath(csrc), "flash_attention.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libflash_attention_baseline.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return FA.bind(ctypes.CDLL(str(out))), proc.stdout + proc.stderr


def baseline_call(lib, q, k, v, scale):
    """One fp32 launch of the baseline's kernel into a fresh output."""
    if hasattr(lib, "ea_flash_attention_f32"):
        return FA._launch(q, k, v, scale, lib)
    b, h, n, dqk = q.shape
    m, dv = v.shape[2], v.shape[3]
    out = torch.empty((b, n, h, dv), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    err = lib.ea_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, n, m, dqk, dv, float(scale), 0,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("baseline flash_attention fp32 failed: "
                           + lib.ea_cuda_error_string(err).decode())
    return out


def ptxas_lines(log: str):
    keep, lines = False, []
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = "f32" in line
        if keep and ("registers" in line or "spill" in line
                     or "Compiling entry" in line):
            lines.append(line.strip())
    return lines


def kernel_device_ms(fn, calls: int) -> dict:
    """Device ms per call of each kernel of fn(), by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            by[name] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    return dict(by)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="csrc directory of another tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", type=int, default=len(C.TRAIN_ATTN_SHAPES),
                    help="the first N of TRAIN_ATTN_SHAPES")
    ap.add_argument("--one-chunk", action="store_true",
                    help="also time the plan with its keys in one chunk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_f32: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_libraries(["flash_attention"])
    FA.build()
    logs = {"checkout": build.BUILD_LOG["flash_attention"]["log"]}
    baseline = None
    if args.baseline:
        baseline, logs["baseline"] = build_baseline(args.baseline)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        if log == "(cached)":
            print(f"[ptxas] {name}: built before this run")
        for line in ptxas_lines(log):
            print(f"[ptxas] {name}: {line}")

    g = torch.Generator("cuda").manual_seed(22)
    summary = {"device": torch.cuda.get_device_name(0), "power": smi,
               "runs": []}
    for label, b, h, n, m, dqk, dv in C.TRAIN_ATTN_SHAPES[:args.shapes]:
        q, k, v = (torch.randn(b, h, x, d, generator=g, device="cuda")
                   for x, d in ((n, dqk), (m, dqk), (m, dv)))
        scale = dqk ** -0.5
        plan = FA.flash_f32_plan(b, h, n, m, dqk, dv)
        run = {"checkout": lambda: FA.flash_attention(q, k, v)}
        if baseline is not None:
            run["baseline"] = lambda: baseline_call(baseline, q, k, v, scale)
        want = FA.flash_attention_reference(q, k, v)
        rec = {"shape": [b, h, n, m, dqk, dv], "label": label,
               "plan": plan._asdict()}
        for name, fn in run.items():
            rec[f"{name} max_abs_err"] = C.max_err(fn(), want)
        del want
        order = (["baseline", "checkout", "checkout", "baseline"]
                 if baseline is not None else ["checkout", "checkout"])
        reps = {name: args.reps for name in run}
        if baseline is not None:
            # the old kernel takes up to ~0.25 s a call at D = 512
            reps["baseline"] = max(1, args.reps // 5)
        times = collections.defaultdict(list)
        for name in order:
            times[name].append(C.cuda_ms(run[name], reps[name], warmup=1))
        for name, ts in times.items():
            rec[f"{name} ms"] = ts
        if args.one_chunk and plan.splits > 1:
            whole = plan._replace(chunk=m, splits=1,
                                  grid=(plan.grid[0], plan.grid[1], 1))
            one = lambda: FA._launch(q, k, v, scale, plan=whole)
            rec["one chunk max_abs_err"] = C.max_err(
                one(), FA.flash_attention_reference(q, k, v))
            rec["one chunk blocks"] = whole.blocks
            rec["one chunk ms"] = [C.cuda_ms(f, args.reps, warmup=1)
                                   for f in (one, run["checkout"],
                                             run["checkout"], one)]
        rec["plain ms"] = C.cuda_ms(
            lambda: FA.flash_attention_reference(q, k, v), args.reps, warmup=1)
        rec["sdpa ms"] = C.cuda_ms(lambda: C.sdpa_call(q, k, v, scale),
                                   args.reps, warmup=1)
        rec["checkout device ms"] = kernel_device_ms(run["checkout"], 3)
        work = C.attention_work(b, h, n, m, dqk, dv, 4)
        rec["bound ms"], rec["bound by"] = C.bound_ms(*work, C.PEAK_FP32_3XTF32)
        rec["bound ms at 67 TFLOP/s"] = C.bound_ms(*work, C.PEAK_FP32)[0]
        print(f"[flash_f32] {label} {(b, h, n, m, dqk, dv)}: plan {plan.path} "
              f"{plan.warps} warps x {plan.rows} rows, kb {plan.kb}, "
              f"{plan.splits} chunk(s) of {plan.chunk} keys, {plan.blocks} "
              f"blocks, {plan.smem} B shared")
        print(f"[flash_f32]   " + "; ".join(
            f"{name} max_abs_err {rec[name + ' max_abs_err']:.3e}, ms "
            + " / ".join(f"{x:.4f}" for x in times[name]) for name in times)
            + f"; twin {rec['plain ms']:.4f} ms; SDPA fp32 {rec['sdpa ms']:.4f}"
            f" ms; bound {rec['bound ms']:.4f} ms ({rec['bound by']}, 165 "
            f"TFLOP/s; {rec['bound ms at 67 TFLOP/s']:.4f} at 67)")
        for kname, ms in sorted(rec["checkout device ms"].items()):
            print(f"[flash_f32]   checkout device {kname}: {ms:.4f} ms a call")
        if "one chunk ms" in rec:
            print(f"[flash_f32]   one chunk ({rec['one chunk blocks']} blocks) "
                  f"against the plan's {plan.splits}, in turns (one, plan, "
                  f"plan, one): "
                  + " / ".join(f"{x:.4f}" for x in rec["one chunk ms"])
                  + f" ms; max_abs_err {rec['one chunk max_abs_err']:.3e}")
        ok = all(rec[f"{name} max_abs_err"] <= C.ATTN_F32_BOUND for name in run)
        rec["ok"] = ok
        summary["runs"].append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0 if all(r["ok"] for r in summary["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
