#!/usr/bin/env python3
"""Kernel D (SAM's two-way transformer, csrc/sam_twoway.cu) on one GPU, and
beside it the same kernel built from another source, timed in turns.

    python3 tools/bench_twoway.py                       # this checkout's D
    python3 tools/bench_twoway.py --baseline DIR        # and DIR/sam_twoway.cu

DIR is a ``csrc`` directory of another tree (say an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory of the repo);
its ``sam_twoway.cu`` is compiled with its own ``common.cuh`` into build/
and called through the same C interface (``ea_sam_twoway``). The inputs are
chip_smoke.py phase 2's: a random SAM decoder at the published widths (q/k
projections drawn at twice the range), a 64x64 image embedding (M 4096),
random pe and tokens, at the AMG's shape (256 prompts, 6 tokens) and the
click's (1 prompt, 21 tokens), in bf16 and fp32. For each it prints:
  - both kernels' distance from the plain twin (max abs, relative RMS);
  - their times in turns, baseline, checkout, checkout, baseline (CUDA
    events over --reps calls after a warm-up each);
  - the device time of each launch kind of this checkout's kernel (and the
    baseline's) under torch.profiler, per call.
First the card's name and power limit and what ptxas said of each kernel;
last a JSON summary. Imports no jax.
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

SHAPES = [("amg batch", 256, 6), ("click", 1, 21)]
M = 4096
SHARPEN = 2.0
SMALL_SAM = dict(img_size=128, patch_size=16, embed_dim=64, depth=2,
                 num_heads=2, global_attn_indexes=(1,), window_size=4)


def build_baseline(csrc: str) -> tuple[ctypes.CDLL, str]:
    """nvcc csrc/sam_twoway.cu (with its own headers) into build/."""
    src = os.path.join(os.path.abspath(csrc), "sam_twoway.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libsam_twoway_baseline.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return K.bind_twoway(ctypes.CDLL(str(out))), proc.stdout + proc.stderr


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


def launch_times(fn, calls: int) -> dict:
    """Device ms per call of each kernel of fn(), by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            by[name][0] += (e.time_range.end - e.time_range.start) / 1e3
            by[name][1] += 1
    return {name: {"ms_per_call": ms / calls, "launches_per_call": n / calls}
            for name, (ms, n) in by.items()}


def errors(got, want):
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    rms = max(((g.float() - w.float()).norm() / w.float().norm()).item()
              for g, w in zip(got, want))
    return err, rms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="csrc directory of another tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtypes", default="bf16,fp32",
                    help="comma-separated, of bf16 and fp32")
    ap.add_argument("--shapes", default="amg batch,click",
                    help="comma-separated, of 'amg batch' and 'click'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_twoway: no CUDA device", file=sys.stderr)
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
    build.build_libraries(["sam_twoway"])
    libs = {"checkout": K.bind_twoway(build.load_library("sam_twoway"))}
    logs = {"checkout": build.BUILD_LOG["sam_twoway"]["log"]}
    if args.baseline:
        libs["baseline"], logs["baseline"] = build_baseline(args.baseline)
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        if log == "(cached)":
            print(f"[ptxas] {name}: built before this run (chip_smoke.py "
                  f"phase 1 prints its ptxas lines)")
        for line in ptxas_lines(log):
            print(f"[ptxas] {name}: {line}")

    g = torch.Generator("cuda").manual_seed(5)
    summary = {"device": torch.cuda.get_device_name(0), "power": smi, "runs": []}
    for tag in args.dtypes.split(","):
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[tag]
        reps = args.reps if dtype == torch.bfloat16 else max(1, args.reps // 5)
        dec = random_sam(SAMConfig(**SMALL_SAM), device="cuda", dtype=dtype,
                         generator=g).mask_decoder
        with torch.no_grad():
            for mod in dec.transformer.modules():
                if hasattr(mod, "q_proj"):
                    mod.q_proj.weight.mul_(SHARPEN)
                    mod.k_proj.weight.mul_(SHARPEN)
        packed = K.pack_twoway(dec.transformer)
        src = torch.randn(1, M, 256, generator=g, device="cuda").to(dtype)
        pe = torch.randn(M, 256, generator=g, device="cuda")
        for label, b, t in SHAPES:
            if label not in args.shapes.split(","):
                continue
            tokens = torch.randn(b, t, 256, generator=g, device="cuda")
            want = K.sam_twoway_reference(packed, src, pe, tokens)
            # the partials of a baseline sized for its finest tiles (32 rows)
            run = {name: (lambda lib=lib, rows=(None if name == "checkout" else 32):
                          K._twoway_launch(lib, packed, src, pe, tokens,
                                           part_rows=rows))
                   for name, lib in libs.items()}
            rec = {"dtype": tag, "shape": label, "B": b, "T": t, "M": M}
            for name, fn in run.items():
                got = fn()
                torch.cuda.synchronize()
                rec[f"{name} err"], rec[f"{name} rel_rms"] = errors(got, want)
                if hasattr(libs[name], "ea_sam_twoway_occupancy"):
                    blocks = (ctypes.c_int * 4)()
                    libs[name].ea_sam_twoway_occupancy(
                        1 if dtype == torch.bfloat16 else 0,
                        K.twoway_row_tile(b, M, dtype), blocks)
                    rec[f"{name} blocks per SM"] = dict(zip(
                        ("shared_kv", "shared_partials", "rows", "tokens"), blocks))
                    print(f"[twoway] {name} {tag} blocks per SM: "
                          f"{rec[name + ' blocks per SM']}")
            order = (["baseline", "checkout", "checkout", "baseline"]
                     if "baseline" in run else ["checkout", "checkout"])
            times = collections.defaultdict(list)
            for name in order:
                times[name].append(cuda_ms(run[name], reps))
            for name, ts in times.items():
                rec[f"{name} ms"] = ts
                rec[f"{name} launches"] = launch_times(run[name], 2)
            print(f"[twoway] {tag} {label} (B={b}, T={t}, M={M}): " + "; ".join(
                f"{name} max_abs_err {rec[name + ' err']:.3e} rel_rms "
                f"{rec[name + ' rel_rms']:.3e}, ms {' / '.join(f'{x:.4f}' for x in rec[name + ' ms'])}"
                for name in times))
            for name in times:
                for kname, v in sorted(rec[f"{name} launches"].items()):
                    print(f"[twoway]   {name} {kname}: {v['ms_per_call']:.4f} ms, "
                          f"{v['launches_per_call']:g} launches per call")
            summary["runs"].append(rec)
            del tokens, want
        del dec, packed, src, pe
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
