#!/usr/bin/env python3
"""Kernel E (the fused resnet block, csrc/resnet_fused.cu) at every resnet
shape of a fused edit request on one GPU, and beside it the same kernel
built from another source, timed in turns.

    python3 tools/bench_resnet.py                       # this checkout's E
    python3 tools/bench_resnet.py --baseline DIR        # and DIR/resnet_fused.cu

DIR is a ``csrc`` directory of another tree (say an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory of the repo);
its ``resnet_fused.cu`` is compiled with its own ``common.cuh`` into build/
and called through the C interface it had before the channels-last
redesign (``ea_resnet_fused`` with an fp32 h and one scratch buffer, the
weights in the torch layout).

The shapes are those of one 512^2 edit request with every resnet fused
(EA_RESNET_FUSED=1; 2 samples under CFG, 30 UniPC steps), traced by
building the full-width SD1.5 UNet, a ControlNet and the VAE on the meta
device with the resnet wrapper recording its calls: per step the UNet and
two ControlNets at batch 4, then the VAE decoder at batch 2 and the encoder
at batch 1. For each shape, in bf16 with chip_smoke.py's inputs: the plan,
the launches per request, the distance of each kernel from the plain twin,
and in turns (baseline, checkout, checkout, baseline):
  - ms per call over back-to-back calls (CUDA events);
  - device ms per call: the kernels' own durations under torch.profiler,
    and the device kernels per call;
  - host microseconds per call (the launch path, the device synchronised
    before and after);
then the composed block's (cuDNN convs + the GroupNorm kernel) device ms,
the block's convs alone through cuDNN (conv1, conv2 and the 1x1 shortcut,
NCHW and channels-last; a yardstick the port never calls), the bound (bf16
operations at 989 TFLOP/s or bytes at 3.35 TB/s, the larger) and E's device
time per kernel of one call. Last, E's time per request (sum over shapes of
launches x ms), the composed block's and the cuDNN convs', and a JSON
summary. The card's name and
power limit come first. Imports no jax.
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
from editanything_tpu_torch.core import flash_attention as FA  # noqa: E402
from editanything_tpu_torch.core import kernels as K  # noqa: E402

STEPS = 30
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16_REL = 2.0 ** -6        # chip_smoke.py RESNET_BF16_REL_BOUND
BF16_RMS = 2e-3             # chip_smoke.py RESNET_BF16_RMS_BOUND


def trace_resnets():
    """{model: Counter((n, cin, cout, h, w, temb, eps) -> calls per
    forward)} of the full-width SD1.5 UNet and ControlNet at batch 4 (64x64
    latents), the VAE decoder at batch 2 and the encoder at batch 1 (512^2),
    built on the meta device in bf16 with every resnet fused and the resnet,
    GroupNorm and attention wrappers recording or stubbed."""
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.controlnet import ControlNetModel
    from editanything_tpu_torch.models.unet import UNet2DConditionModel
    from editanything_tpu_torch.models.vae import AutoencoderKL
    calls = collections.defaultdict(collections.Counter)
    model = [None]

    def resnet(x, norm1_w, norm1_b, w1, b1, trow, *rest, num_groups=32,
               eps=1e-5):
        n, cin, h, w = x.shape
        calls[model[0]][n, cin, w1.shape[0], h, w, trow is not None, eps] += 1
        return x.new_empty((n, w1.shape[0], h, w))

    def group_norm(x, weight, bias, *, num_groups=32, eps=1e-5,
                   apply_silu=True):
        return torch.empty_like(x)

    def attention(q, k, v, *, scale=None):
        return q.new_empty(q.shape[:-1] + (v.shape[-1],))

    def meta(*shape):
        return torch.empty(*shape, device="meta", dtype=torch.bfloat16)

    saved = (K.resnet_fused, K.group_norm_silu, FA.flash_attention,
             os.environ.get("EA_RESNET_FUSED"))
    K.resnet_fused, K.group_norm_silu, FA.flash_attention = (
        resnet, group_norm, attention)
    os.environ["EA_RESNET_FUSED"] = "1"
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
        K.resnet_fused, K.group_norm_silu, FA.flash_attention = saved[:3]
        if saved[3] is None:
            os.environ.pop("EA_RESNET_FUSED", None)
        else:
            os.environ["EA_RESNET_FUSED"] = saved[3]
    return dict(calls)


def request_calls():
    """[(shape key, launches per request)] of one fused edit request, the
    denoise loop's shapes first."""
    per_forward = {"unet": STEPS, "controlnet": 2 * STEPS,
                   "vae decoder": 1, "vae encoder": 1}
    total = collections.Counter()
    for model, counter in trace_resnets().items():
        for key, n in counter.items():
            total[key] += n * per_forward[model]
    return sorted(total.items(), key=lambda r: (r[0][0] != 4, -r[0][3], r[0][1],
                                                r[0][2]))


def build_baseline(csrc: str) -> tuple[ctypes.CDLL, str]:
    """nvcc csrc/resnet_fused.cu (with its own headers) into build/, bound
    with the interface it had before the channels-last redesign."""
    src = os.path.join(os.path.abspath(csrc), "resnet_fused.cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libresnet_fused_baseline.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ea_resnet_fused.argtypes = ([ptr] * 15 + [i32] * 6
                                    + [ctypes.c_float, i32, ptr])
    lib.ea_resnet_fused.restype = i32
    lib.ea_resnet_scratch_floats.argtypes = [i32] * 7
    lib.ea_resnet_scratch_floats.restype = ctypes.c_longlong
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib, proc.stdout + proc.stderr


def baseline_call(lib, x, args, eps, groups=32):
    """One call of the baseline library (its own wrapper's steps: an fp32
    h and a scratch buffer allocated per call)."""
    n, cin, hgt, wid = x.shape
    cout = args[2].shape[0]
    ptrs = [None if t is None else t.data_ptr() for t in args]
    out = torch.empty((n, cout, hgt, wid), dtype=x.dtype, device=x.device)
    h = torch.empty((n, cout, hgt, wid), dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.ea_resnet_scratch_floats(
        n, cin, cout, hgt, wid, groups, int(args[9] is not None)),
        dtype=torch.float32, device=x.device)
    err = lib.ea_resnet_fused(
        x.data_ptr(), *ptrs, out.data_ptr(), h.data_ptr(), scratch.data_ptr(),
        n, cin, cout, hgt, wid, groups, float(eps), 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(lib.ea_cuda_error_string(err).decode())
    return out


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


KERNEL_NAMES = ("stats_x", "norm_x", "tile_stats", "fin2", "norm_h",
                "store_out")


def short_name(name: str) -> str:
    """conv1 / conv2 / the pass's name for kernel E's kernels, else the name."""
    if "conv_kernel" in name:
        return "conv1" if ("ELb1E" in name or "true>" in name) else "conv2"
    for k in KERNEL_NAMES:
        if k + "_kernel" in name:
            return k
    return "memset" if "emset" in name else name[:40]


def device_ms(fn, calls: int, tries: int = 3, by_name=None):
    """(device ms per call, device kernels and memsets per call) under
    torch.profiler; a trace that recorded no device work is taken again.
    by_name (a dict) gets device ms per call of each kernel."""
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
    if by_name is not None:
        for e in kernels:
            key = short_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / calls
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


def block_inputs(g, n, cin, cout, temb, side_h, side_w):
    """chip_smoke.py's resnet inputs (bf16, on the card)."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                + shift).bfloat16()
    x = (torch.randn(n, cin, side_h, side_w, generator=g, device="cuda")
         * (1 + torch.rand(1, cin, 1, 1, generator=g, device="cuda"))
         + torch.randn(1, cin, 1, 1, generator=g, device="cuda")).bfloat16()
    sc = cin != cout
    args = (rnd(cin, scale=0.2, shift=1.0), rnd(cin, scale=0.5),
            rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(cout, scale=0.5),
            rnd(n, cout) if temb else None,
            rnd(cout, scale=0.2, shift=1.0), rnd(cout, scale=0.5),
            rnd(cout, cout, 3, 3, scale=(9 * cout) ** -0.5), rnd(cout, scale=0.5),
            rnd(cout, cin, 1, 1, scale=cin ** -0.5) if sc else None,
            rnd(cout, scale=0.5) if sc else None)
    return x, args


def composed_block(args, temb: bool):
    """A ResnetBlock2D on the card holding `args`, run with the switch off."""
    from editanything_tpu_torch.models.blocks import ResnetBlock2D
    cout, cin = args[2].shape[:2]
    blk = ResnetBlock2D(cin, cout, 1280 if temb else None).to("cuda",
                                                             torch.bfloat16)
    names = ("norm1.weight", "norm1.bias", "conv1.weight", "conv1.bias", None,
             "norm2.weight", "norm2.bias", "conv2.weight", "conv2.bias",
             "conv_shortcut.weight", "conv_shortcut.bias")
    params = dict(blk.named_parameters())
    with torch.no_grad():
        for name, value in zip(names, args):
            if name is not None and value is not None:
                params[name].copy_(value)
    return blk


def cudnn_convs(x, args, channels_last: bool):
    """The block's convs alone through cuDNN, as chip_smoke.py times them."""
    import torch.nn.functional as F
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    xc = x.contiguous(memory_format=fmt)
    w1, w2, wsc = (None if w is None else w.contiguous(memory_format=fmt)
                   for w in (args[2], args[7], args[9]))
    h = torch.empty((x.shape[0], w1.shape[0]) + x.shape[2:], dtype=x.dtype,
                    device=x.device).normal_().contiguous(memory_format=fmt)

    def run():
        F.conv2d(xc, w1, padding=1)
        F.conv2d(h, w2, padding=1)
        if wsc is not None:
            F.conv2d(xc, wsc)
    return run


def work(n, cin, cout, hw, temb):
    """(FLOPs, bytes) of one block, as chip_smoke.py::resnet_work."""
    sc = cin != cout
    macs = n * hw * cout * (9 * cin + 9 * cout + (cin if sc else 0))
    nbytes = 2 * (n * hw * (cin + cout) + 9 * cin * cout + 9 * cout * cout
                  + (cin * cout if sc else 0) + (n * cout if temb else 0))
    return 2.0 * macs, float(nbytes)


def errors(got, want):
    d = got.float() - want.float()
    return d.abs().max().item(), (d.norm() / want.float().norm()).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="csrc directory of another tree")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--shapes", type=int, default=0,
                    help="only the first N shapes (0: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_resnet: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    t0 = time.perf_counter()
    build.build_libraries(["resnet_fused", "group_norm"])
    impls = {"checkout": lambda x, a, eps: K.resnet_fused(x, *a, eps=eps)}
    if args.baseline:
        base, log = build_baseline(args.baseline)
        impls["baseline"] = lambda x, a, eps: baseline_call(base, x, a, eps)
        for line in ptxas_lines(log):
            print(f"[ptxas baseline] {line}")
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in ptxas_lines(build.BUILD_LOG["resnet_fused"]["log"]):
        print(f"[ptxas] {line}")

    # the profiler's first trace can miss events: take one to warm it up
    device_ms(lambda: torch.ones(1, device="cuda").add_(1), 1)
    g = torch.Generator("cuda").manual_seed(0)
    order = (["baseline", "checkout", "checkout", "baseline"]
             if "baseline" in impls else ["checkout", "checkout"])
    rows = []
    calls = request_calls()
    shapes = calls[:args.shapes] if args.shapes else calls
    print(f"[resnet] {len(calls)} shapes, {sum(n for _, n in calls)} calls a "
          f"fused request")
    for (n, cin, cout, hgt, wid, temb, eps), launches in shapes:
        x, bargs = block_inputs(g, n, cin, cout, temb, hgt, wid)
        plan = K.resnet_plan(n, cin, cout, hgt, wid, 32, cin != cout,
                             K._sm_count(0))
        want = K.resnet_fused_reference(x, *bargs, eps=eps)
        ops, nbytes = work(n, cin, cout, hgt * wid, temb)
        row = {"shape": [n, cin, cout, hgt, wid], "temb": temb, "eps": eps,
               "launches_per_request": launches, "plan": plan._asdict(),
               "bound_ms": 1e3 * max(ops / PEAK_BF16, nbytes / PEAK_BYTES)}
        run = {name: (lambda fn=fn: fn(x, bargs, eps))
               for name, fn in impls.items()}
        for name, fn in run.items():
            err, rms = errors(fn(), want)
            top = want.float().abs().max().item()
            if err > BF16_REL * top or rms > BF16_RMS:
                raise AssertionError(f"{name} at {row['shape']}: {err} / {rms}")
            row[f"{name} err"] = [err, rms]
        del want
        reps = args.reps if ops < 1e11 else max(3, args.reps // 3)
        times = collections.defaultdict(lambda: collections.defaultdict(list))
        split = {}
        for name in order:
            fn = run[name]
            times[name]["ms"].append(cuda_ms(fn, reps))
            dev, kernels = device_ms(fn, reps, by_name=split if (
                name == "checkout" and not split) else None)
            times[name]["device_ms"].append(dev)
            times[name]["host_us"].append(host_us(fn, 20))
            row[f"{name} kernels per call"] = kernels
        for name, t in times.items():
            row[name] = dict(t)
        row["checkout by kernel"] = split
        blk = composed_block(bargs, temb)
        tin = (torch.randn(n, 1280, generator=g, device="cuda").bfloat16()
               if temb else None)
        os.environ["EA_RESNET_FUSED"] = "0"
        with torch.no_grad():
            row["composed device_ms"], row["composed kernels"] = device_ms(
                lambda: blk(x, tin), reps)
            for cl in (False, True):
                key = "cudnn convs " + ("channels-last" if cl else "NCHW")
                row[key + " device_ms"] = device_ms(cudnn_convs(x, bargs, cl),
                                                    reps)[0]
        rows.append(row)
        parts = [f"{name}: ms {' / '.join(f'{v:.4f}' for v in t['ms'])}, "
                 f"device {' / '.join(f'{v:.4f}' for v in t['device_ms'])} "
                 f"({row[name + ' kernels per call']} kernels), host us "
                 f"{' / '.join(f'{v:.1f}' for v in t['host_us'])}"
                 for name, t in times.items()]
        print(f"[resnet] {row['shape']} temb={temb} eps={eps:g}: {launches} "
              f"per request, plan bn {plan.bn} tiles {plan.mtiles}x"
              f"{plan.ntiles} splits {plan.split1}/{plan.split2}, bound "
              f"{row['bound_ms']:.4f} ms; " + "; ".join(parts)
              + f"; composed device {row['composed device_ms']:.4f} ms "
              f"({row['composed kernels']} kernels); cuDNN convs device "
              f"{row['cudnn convs NCHW device_ms']:.4f} ms NCHW, "
              f"{row['cudnn convs channels-last device_ms']:.4f} ms "
              f"channels-last; checkout by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
        del x, bargs, blk
        torch.cuda.empty_cache()
    per_request = {}
    for name in dict.fromkeys(order):
        per_request[name] = {
            what: sum(r["launches_per_request"] * min(r[name][what])
                      for r in rows)
            for what in ("device_ms", "ms")}
        per_request[name]["host_ms"] = sum(
            r["launches_per_request"] * min(r[name]["host_us"]) for r in rows) / 1e3
        per_request[name]["kernels"] = sum(
            r["launches_per_request"] * r[f"{name} kernels per call"] for r in rows)
        p = per_request[name]
        print(f"[resnet] per request, {name}: device {p['device_ms']:.2f} ms, "
              f"back-to-back {p['ms']:.2f} ms, host {p['host_ms']:.2f} ms, "
              f"{p['kernels']} device kernels")
    for key in ("composed device_ms", "cudnn convs NCHW device_ms",
                "cudnn convs channels-last device_ms"):
        per_request[key] = sum(r["launches_per_request"] * r[key] for r in rows)
    per_request["bound_ms"] = sum(r["launches_per_request"] * r["bound_ms"]
                                  for r in rows)
    per_request["calls"] = sum(r["launches_per_request"] for r in rows)
    print(f"[resnet] per request: {per_request['calls']} calls, composed "
          f"device {per_request['composed device_ms']:.2f} ms, cuDNN convs "
          f"alone {per_request['cudnn convs NCHW device_ms']:.2f} ms NCHW, "
          f"{per_request['cudnn convs channels-last device_ms']:.2f} ms "
          f"channels-last, bound "
          f"{per_request['bound_ms']:.2f} ms")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi,
                      "per_request": per_request, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
