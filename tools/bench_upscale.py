#!/usr/bin/env python3
"""Kernel C (SAM's upscale + hypernetwork products, csrc/sam_upscale.cu) on
one GPU, and beside it the same kernel built from another source, timed in
turns.

    python3 tools/bench_upscale.py                    # this checkout's C
    python3 tools/bench_upscale.py --baseline DIR     # and DIR/sam_upscale.cu

DIR is a ``csrc`` directory of another tree (say 2cdd2d8's, unpacked with
``git archive`` into a git-ignored directory of the repo); its
``sam_upscale.cu`` is compiled with its own ``common.cuh`` into build/ and
called through the same C interface (``ea_sam_upscale``) with the same
packed weights. The inputs are chip_smoke.py phase 2's: a random SAM
decoder at the published widths, a 64x64 image embedding, random keys and
hypernetwork vectors, at the AMG's batch (256 prompts) and the click's (1),
in bf16 and fp32. For each it prints both kernels' distance from the plain
twin, their times in turns (baseline, checkout, checkout, baseline; CUDA
events over --reps calls after a warm-up, which include the wrapper's
weight packing), their device time per call under torch.profiler (the
kernel alone and every device kernel of the call), and the bound. First
the card's name and power limit, what ptxas said of each kernel and the
blocks per SM of this checkout's kernels; last a JSON summary. Imports no
jax.
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

from editanything_tpu_torch.core import build  # noqa: E402
from editanything_tpu_torch.core import kernels as K  # noqa: E402

SHAPES = [("amg batch", 256), ("click", 1)]
E = 64
PEAK = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
SMALL_SAM = dict(img_size=128, patch_size=16, embed_dim=64, depth=2,
                 num_heads=2, global_attn_indexes=(1,), window_size=4)


def build_baseline(csrc: str):
    """nvcc csrc/sam_upscale.cu (with its own headers) into build/."""
    src = os.path.join(os.path.abspath(csrc), "sam_upscale.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libsam_upscale_baseline.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return K.bind_upscale(ctypes.CDLL(str(out))), proc.stdout + proc.stderr


def ptxas_lines(log: str):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


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


def device_ms(fn, calls: int) -> tuple[float, float]:
    """(the upscale kernel's device ms per call, every device kernel's)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    own = every = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            every += us
            if "upscale" in e.name:
                own += us
    return own / 1e3 / calls, every / 1e3 / calls


def work(b: int, itemsize: int):
    """(FLOPs, bytes) of kernel C at b prompts of E x E keys (chip_smoke.py's
    upscale_work)."""
    macs = b * E * E * (4 * 256 * 64 + 16 * 64 * 32 + 16 * 4 * 32)
    return 2.0 * macs, float(itemsize * b * (E * E * 256 + 4 * 16 * E * E))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="csrc directory of another tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtypes", default="bf16,fp32",
                    help="comma-separated, of bf16 and fp32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_upscale: no CUDA device", file=sys.stderr)
        return 1
    from editanything_tpu_torch.models.sam import SAMConfig
    from editanything_tpu_torch.pipelines.bundle import random_sam
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_libraries(["sam_upscale"])
    libs = {"checkout": K.bind_upscale(build.load_library("sam_upscale"))}
    logs = {"checkout": build.BUILD_LOG["sam_upscale"]["log"]}
    if args.baseline:
        libs["baseline"], logs["baseline"] = build_baseline(args.baseline)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in ptxas_lines(log):
            print(f"[ptxas] {name}: {line}")
    occ = (ctypes.c_int * 2)()
    err = libs["checkout"].ea_sam_upscale_occupancy(occ)
    if err:
        raise RuntimeError(f"ea_sam_upscale_occupancy failed ({err})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[upscale] checkout blocks per SM: bf16 persistent {occ[0]} (grid "
          f"{occ[0] * sms} on {sms} SMs), fp32 {occ[1]}")

    g = torch.Generator("cuda").manual_seed(5)
    summary = {"device": torch.cuda.get_device_name(0), "power": smi,
               "blocks_per_sm": {"bf16": occ[0], "fp32": occ[1]}, "runs": []}
    for tag in args.dtypes.split(","):
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[tag]
        reps = args.reps if dtype == torch.bfloat16 else max(1, args.reps // 5)
        up = random_sam(SAMConfig(**SMALL_SAM), device="cuda", dtype=dtype,
                        generator=g).mask_decoder.output_upscaling
        weights = (up[0].weight, up[0].bias, up[1].weight, up[1].bias,
                   up[3].weight, up[3].bias)
        for label, b in SHAPES:
            keys = torch.randn(b, E * E, 256, generator=g, device="cuda").to(dtype)
            hyper = torch.randn(b, 4, 32, generator=g, device="cuda").to(dtype)
            want = K.sam_upscale_hyper_reference(keys, hyper, *weights)
            run = {name: (lambda lib=lib: K._upscale_launch(
                lib, keys, hyper, *weights, 1e-6)) for name, lib in libs.items()}
            least = max(work(b, keys.element_size())[0] / PEAK[tag],
                        work(b, keys.element_size())[1] / PEAK_BYTES) * 1e3
            rec = {"dtype": tag, "shape": label, "B": b, "e": E, "bound_ms": least}
            for name, fn in run.items():
                got = fn()
                torch.cuda.synchronize()
                rec[f"{name} err"] = (got.float() - want.float()).abs().max().item()
            rec["max|out|"] = want.float().abs().max().item()
            order = (["baseline", "checkout", "checkout", "baseline"]
                     if "baseline" in run else ["checkout", "checkout"])
            times = collections.defaultdict(lambda: collections.defaultdict(list))
            for name in order:
                times[name]["ms"].append(cuda_ms(run[name], reps))
                own, every = device_ms(run[name], max(2, reps // 4))
                times[name]["kernel_device_ms"].append(own)
                times[name]["call_device_ms"].append(every)
            for name, t in times.items():
                rec[name] = dict(t)
            print(f"[upscale] {tag} {label} (B={b}, {E}x{E} -> {4 * E}x{4 * E}): "
                  f"bound {least:.4f} ms, max|out| {rec['max|out|']:.3e}; "
                  + "; ".join(
                      f"{name} max_abs_err {rec[name + ' err']:.3e}, ms "
                      f"{' / '.join(f'{x:.4f}' for x in t['ms'])}, kernel device "
                      f"{' / '.join(f'{x:.4f}' for x in t['kernel_device_ms'])}, "
                      f"call device "
                      f"{' / '.join(f'{x:.4f}' for x in t['call_device_ms'])}"
                      for name, t in times.items()))
            summary["runs"].append(rec)
            del keys, hyper, want
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
