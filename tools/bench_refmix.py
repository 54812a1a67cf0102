#!/usr/bin/env python3
"""First-call and steady cost of reference control's FFT magnitude mix on
one CUDA GPU, in fresh processes.

    python3 tools/bench_refmix.py        # from the repository root

The mix (``engine/refctrl.py::add_freq_feature``) runs at every hooked
block of a reference-mode request. Two formulations of the same function:
"complex", the port's, which is the JAX package's op for op (abs of the
spectra, angle, polar), and "real", with no elementwise complex op (the
spectra as real pairs: hypot, and the target's phase as the unit vector
re/|f|, im/|f|). Each runs in a process of its own
on the read attention's 64x64 grid (4, 64, 64, 320) bf16 over axes (1, 2):
the seconds of its first call (library loads, FFT plans and any runtime
kernel compilation included) and the device ms per call after it (CUDA
events, 20 calls). A third process times the first call of each op of the
"complex" form in turn, to say which one pays. Prints the card's name and
power limit first and one JSON line last. Imports no jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 64, 64, 320)
DIMS = (1, 2)
RATIO = 0.4


def mix_real(ref, target, ratio, dims):
    import torch
    f1 = torch.view_as_real(torch.fft.fftn(ref.float(), dim=dims))
    f2 = torch.view_as_real(torch.fft.fftn(target.float(), dim=dims))
    re, im = f2.unbind(-1)
    mag2 = torch.hypot(re, im)
    mag = mag2 * (1.0 - ratio) + torch.hypot(*f1.unbind(-1)) * ratio
    nonzero = mag2 > 0
    scale = mag / torch.where(nonzero, mag2, 1.0)
    mixed = torch.stack([torch.where(nonzero, re * scale, mag),
                         torch.where(nonzero, im * scale, 0.0)], dim=-1)
    return torch.fft.ifftn(torch.view_as_complex(mixed),
                           dim=dims).real.to(target.dtype)


def inputs():
    import torch
    g = torch.Generator("cuda").manual_seed(0)
    return [torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2)]


def child(variant: str) -> dict:
    import torch
    sys.path.insert(0, REPO)
    from editanything_tpu_torch.engine.refctrl import add_freq_feature
    ref, tgt = inputs()
    torch.cuda.synchronize()
    if variant == "ops":
        # the first call of each op of the complex form, in order
        out = {}
        steps = [
            ("fftn (cuFFT load, plan)", lambda s: {
                "f1": torch.fft.fftn(ref.float(), dim=DIMS),
                "f2": torch.fft.fftn(tgt.float(), dim=DIMS)}),
            ("abs of complex64", lambda s: {
                "m": torch.abs(s["f2"]) * (1 - RATIO)
                + torch.abs(s["f1"]) * RATIO}),
            ("angle of complex64", lambda s: {"a": torch.angle(s["f2"])}),
            ("polar", lambda s: {"p": torch.polar(s["m"], s["a"])}),
            ("ifftn + real + cast", lambda s: {
                "y": torch.fft.ifftn(s["p"], dim=DIMS).real.to(tgt.dtype)}),
        ]
        state = {}
        for name, fn in steps:
            t = time.perf_counter()
            state.update(fn(state))
            torch.cuda.synchronize()
            out[name] = time.perf_counter() - t
        return {"first_call_s_by_op": out}
    fn = {"complex": lambda: add_freq_feature(ref, tgt, RATIO, dims=DIMS),
          "real": lambda: mix_real(ref, tgt, RATIO, DIMS)}[variant]
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"first_call_s": first, "ms_per_call": start.elapsed_time(end) / 20}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_refmix: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    result = {"device": smi, "shape": SHAPE}
    for variant in ("complex", "real", "ops"):
        proc = subprocess.run([sys.executable, __file__, "--child", variant],
                              capture_output=True, text=True, check=True)
        result[variant] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[refmix] {variant}: {result[variant]}")
    # the two forms agree (bf16 output, an ulp of it)
    sys.path.insert(0, REPO)
    from editanything_tpu_torch.engine.refctrl import add_freq_feature
    ref, tgt = inputs()
    a = add_freq_feature(ref, tgt, RATIO, dims=DIMS).float()
    b = mix_real(ref, tgt, RATIO, DIMS).float()
    result["max_abs_diff"] = (a - b).abs().max().item()
    result["max_abs"] = a.abs().max().item()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
