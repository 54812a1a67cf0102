#!/usr/bin/env python3
"""Where the time of one full-width edit request of the PyTorch port goes.

    python3 tools/profile_torch_edit.py        # from the repository root; one CUDA GPU
    python3 tools/profile_torch_edit.py --sam  # the SAM phase of the main path
    python3 tools/profile_torch_edit.py --fused  # the edit, every resnet fused
    python3 tools/profile_torch_edit.py --reference  # a reference-mode edit

The configuration is chip_smoke.py's phase 4: SD1.5 UNet + two ControlNets +
VAE + CLIP-L at published widths, random bf16 weights from seed 0, a 512^2
edit at the reference UI's default point (2 samples, 30 UniPC steps, CFG 9)
through ``EditPipeline``. After one warm-up request (its host ops traced:
the ops with the most self time, which is where first-use costs show) it
runs:
  1. five untraced requests on the host clock (the spread within a process);
  2. one request with every call of the text encoder, the ControlNets, the
     UNet and the VAE encoder and decoder bracketed by
     torch.cuda.synchronize(): each one's seconds per request, its host
     launch work included (the brackets add a little of their own);
  3. one request under torch.profiler: device time by kernel category and
     for the top kernels, the kernel count, the device's busy time (union
     of kernel intervals) and its idle share of the traced span. Tracing
     slows the host, so that idle share is an upper bound; the line after
     it sets the busy time against the untraced requests.
With ``--fused`` the edit runs with EA_RESNET_FUSED=1, so that every resnet
block goes through the fused resnet kernel. With ``--reference`` it is
chip_smoke.py's phase-4c reference request (``reference_args``: attention
and AdaIN hooks, the FFT mix, the ragged reference mask), whose write pass
calls the UNet and the ControlNets once more a step. With ``--sam`` it profiles the SAM phase instead, as chip_smoke.py's phase
5 runs it: SAM ViT-H with random bf16 weights (seed 7) in
``EditAnythingEditor.get_sam_control`` on a 512^2 image (encoder at 1024^2,
the 32x32-point AMG in 4 batches of 256, selection and NMS, the ID map):
five untraced calls, then one call under torch.profiler, as step 3 above.
Prints the card's name and power limit first and a JSON summary last.
Imports no jax.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNTRACED_REQUESTS = 5

# (category, substrings of the kernel name), first match wins
CATEGORIES = [
    ("flash attention (csrc/flash_attention.cu)", ("flash_bf16", "flash_f32")),
    ("SAM two-way, row tiles (csrc/sam_twoway.cu)", ("twoway_rows",)),
    ("SAM two-way, tokens (csrc/sam_twoway.cu)", ("twoway_tokens",)),
    ("SAM two-way, layer 0's shared K/V (csrc/sam_twoway.cu)",
     ("twoway_shared_kv",)),
    ("SAM two-way, layer 0's partials (csrc/sam_twoway.cu)",
     ("twoway_shared_partials",)),
    ("SAM upscale + hypernetwork (csrc/sam_upscale.cu)",
     ("upscale_kernel", "upscale_persistent_kernel")),
    ("fused resnet, convs (csrc/resnet_fused.cu)", ("::conv_kernel<",)),
    ("fused resnet, statistics and normalise passes (csrc/resnet_fused.cu)",
     ("::stats_x_kernel<", "::norm_x_kernel<", "::tile_stats_kernel<",
      "::fin2_kernel<", "::norm_h_kernel<", "::store_out_kernel<")),
    ("GroupNorm+SiLU (csrc/group_norm.cu)", ("::gn_kernel<",)),
    ("FFT (reference control's magnitude mix)", ("fft",)),
    ("cuDNN layout NCHW->NHWC", ("nchwToNhwc",)),
    ("cuDNN layout NHWC->NCHW", ("nhwcToNchw",)),
    ("convolution", ("fprop", "convolve", "conv2d", "implicit_gemm")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass")),
    ("layer_norm", ("layer_norm",)),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat_", "CatArray")),
    ("elementwise", ("elementwise",)),
]


def _category(name: str) -> str:
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def component_seconds(pipe, request, bundle, seed):
    """Synchronised seconds per request of each model's forward calls."""
    totals, calls, start = (collections.defaultdict(float),
                            collections.Counter(), {})
    modules = [("text encoder", bundle.text), ("unet", bundle.unet),
               ("vae encoder", bundle.vae.encoder),
               ("vae decoder", bundle.vae.decoder)] + [
        (f"controlnet {name}", net)
        for name, (_, net) in bundle.controlnets.items()]
    handles = []
    for label, module in modules:
        def pre(_m, _a, label=label):
            torch.cuda.synchronize()
            start[label] = time.perf_counter()

        def post(_m, _a, _o, label=label):
            torch.cuda.synchronize()
            totals[label] += time.perf_counter() - start[label]
            calls[label] += 1
        handles += [module.register_forward_pre_hook(pre),
                    module.register_forward_hook(post)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe(**request, generator=torch.Generator("cuda").manual_seed(seed))
    wall = time.perf_counter() - t0
    for h in handles:
        h.remove()
    return wall, dict(totals), dict(calls)


def traced(fn):
    """fn() once under torch.profiler: (seconds, kernels, busy us, span us,
    device time and count by category, by kernel name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_cat, by_name = collections.defaultdict(lambda: [0.0, 0]), \
        collections.defaultdict(lambda: [0.0, 0])
    for e, (s, t) in zip(kernels, intervals):
        for table, key in ((by_cat, _category(e.name)), (by_name, e.name)):
            table[key][0] += t - s
            table[key][1] += 1
    span = (max(t for _, t in intervals) - min(s for s, _ in intervals)
            if intervals else 0.0)
    return wall, len(kernels), _busy_us(intervals), span, by_cat, by_name


def print_trace(wall, n, busy, span, by_cat, by_name, untraced):
    print(f"[profile] traced run {wall:.3f} s: {n} device kernels, busy "
          f"{busy / 1e3:.1f} ms, idle share of the traced span "
          f"{1 - busy / span if span else float('nan'):.3f}")
    print(f"[profile] busy time against the fastest untraced run: "
          f"{busy / 1e6:.3f} s of {min(untraced):.3f} s "
          f"(device idle about {1 - busy / 1e6 / min(untraced):.3f} of it)")
    print("[profile] device time by category (ms, share of busy, kernels):")
    for label, (us, k) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {label}: {us / 1e3:.2f} ms, "
              f"{us / busy:.3f}, {k}")
    print("[profile] top kernels (ms, count):")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, k) in top:
        print(f"[profile]   {us / 1e3:.2f} ms, {k}: {name[:110]}")


def profile_sam_phase(bundle, smi) -> int:
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    from editanything_tpu_torch.models import sam as SAM
    from editanything_tpu_torch.perception.amg import AMGConfig
    from editanything_tpu_torch.pipelines.bundle import random_sam
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    import chip_smoke

    cfg = SAM.sam_vit_h()
    sam = random_sam(cfg, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator("cuda").manual_seed(7)).eval()
    editor = EditAnythingEditor(bundle, sam=(cfg, sam), amg_config=AMGConfig())
    image = chip_smoke._checker_image(512, 512)

    def one():
        torch.cuda.synchronize()
        t = time.perf_counter()
        editor.get_sam_control(image)
        return time.perf_counter() - t

    print(f"[profile] warm-up SAM phase: {one():.3f} s")
    counters = (FA.flash_attention, K.sam_twoway, K.sam_upscale_hyper)
    for fn in counters:
        fn.launches = 0
    untraced = [one() for _ in range(UNTRACED_REQUESTS)]
    launches = {fn.__name__: fn.launches // UNTRACED_REQUESTS for fn in counters}
    print("[profile] untraced SAM phases (s): "
          + " ".join(f"{s:.4f}" for s in untraced)
          + f"; kernel wrapper launches per call {launches}")
    trace = traced(lambda: editor.get_sam_control(image))
    print_trace(*trace, untraced)
    wall, n, busy, _, by_cat, _ = trace
    print(json.dumps({
        "device": smi, "phase": "sam", "untraced_s": untraced,
        "launches": launches, "traced_s": wall, "kernels": n,
        "busy_ms": busy / 1e3,
        "categories_ms": {k: v[0] / 1e3 for k, v in by_cat.items()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_edit: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from editanything_tpu_torch.core import flash_attention as FA
    from editanything_tpu_torch.core import kernels as K
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.pipelines.edit import EditPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    bundle = random_bundle(tiny=False, dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    if sys.argv[1:] not in ([], ["--sam"], ["--fused"], ["--reference"]):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--sam"]:
        return profile_sam_phase(bundle, smi)
    fused = sys.argv[1:] == ["--fused"]
    os.environ["EA_RESNET_FUSED"] = "1" if fused else "0"
    pipe = EditPipeline(bundle, controls=("sam", "inpaint"),
                        inpaint_mode="blend")
    request = chip_smoke.full_width_request()
    if sys.argv[1:] == ["--reference"]:
        request.update(chip_smoke.reference_args())

    def one(seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe(**request, generator=torch.Generator("cuda").manual_seed(seed))
        return time.perf_counter() - t

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        warm = one(100)
    print(f"[profile] warm-up request: {warm:.3f} s (host ops traced); the "
          f"host ops with the most self time:")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"[profile]   {e.self_cpu_time_total / 1e6:.3f} s in {e.count} "
              f"calls: {e.key}")
    counters = (FA.flash_attention, K.group_norm_silu, K.resnet_fused)
    for fn in counters:
        fn.launches = 0
    untraced = [one(101 + r) for r in range(UNTRACED_REQUESTS)]
    launches = {fn.__name__: fn.launches // UNTRACED_REQUESTS for fn in counters}
    print("[profile] untraced requests (s): "
          + " ".join(f"{s:.3f}" for s in untraced)
          + f"; kernel wrapper launches per request {launches}")

    wall, seconds, calls = component_seconds(pipe, request, bundle, 110)
    print(f"[profile] synchronised request {wall:.3f} s:")
    for label, s in sorted(seconds.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {label}: {s:.3f} s in {calls[label]} calls "
              f"({1e3 * s / calls[label]:.2f} ms per call)")
    rest = wall - sum(seconds.values())
    print(f"[profile]   everything else (host prep, hints, sampler, "
          f"blend, uint8): {rest:.3f} s")

    trace = traced(lambda: pipe(
        **request, generator=torch.Generator("cuda").manual_seed(120)))
    print_trace(*trace, untraced)
    twall, n, busy, _, by_cat, _ = trace
    print(json.dumps({
        "device": smi, "resnets": "fused" if fused else "composed",
        "reference": sys.argv[1:] == ["--reference"],
        "untraced_s": untraced, "launches": launches,
        "components_s": seconds, "component_calls": calls,
        "synchronised_request_s": wall, "traced_request_s": twall,
        "kernels": n, "busy_ms": busy / 1e3,
        "categories_ms": {k: v[0] / 1e3 for k, v in by_cat.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
