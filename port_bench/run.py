"""One run of one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It builds or loads the port's kernels (into the checkout's build/),
makes the cell's inputs and weights from the seed, warms up the cell's
shapes, measures for the given seconds, then checks the timed path's
outputs against the plain reference (port_bench/reference/) and prints,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device (and with --trace 1 breakdown) and, last, the
compared numbers with their limits, which also end standard error.

It exits non-zero and prints no result without the cards, or if a module
of jax, jaxlib, flax or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def execute(args, device: str = "cuda", *, entry=None, traffic=None,
            config=None):
    """Set up, measure and check one run; returns the Run. `entry`,
    `traffic` and `config` default to the named cell's files."""
    import torch

    from port_bench import harness as H

    entry = entry or H.workload(args.workload)
    traffic = traffic or H.traffic(entry["traffic"])
    config = config or H.config(entry["config"])
    fp32 = config["dtype"] == "float32"
    torch.backends.cuda.matmul.allow_tf32 = fp32 and config.get("tf32", False)
    torch.backends.cudnn.allow_tf32 = (config.get("tf32", False) if fp32
                                       else torch.backends.cudnn.allow_tf32)
    run = H.Run(cell=entry["name"], seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device, entry=entry,
                traffic=traffic, config=config)
    drv = H.driver(traffic["driver"])
    if run.tracing:
        H.wrap_kernel_entries(run)
    e2e, _ = H.cell_metrics(run.cell)
    run.busy_units = not run.tracing and any(
        m["source"] == "device_trace" for m in e2e)
    drv.setup(run)
    if run.busy_units:
        H.warm_profiler(run.device)
    gc.collect()
    drv.window(run)
    if run.in_window:
        run.end_window()
    drv.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    drv.check(run)
    if run.tracing:
        run.unit_flops = drv.unit_flops(config, traffic)
    return run


def result(run) -> dict:
    """The result line's object for a finished run."""
    import torch

    from port_bench import harness as H
    e2e, layer = H.cell_metrics(run.cell)
    metrics = {}
    if run.tracing:
        for m in layer:
            v = H.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = run.state["end_to_end"](run)
        values["setup_s"] = run.setup_s
        values["peak_mem_gib"] = run.peak_bytes / 2 ** 30
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(run.device),
              "count": int(run.entry["chips"]),
              "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.tracing and run.device_profile is not None:
        device["busy_s"] = run.device_profile.busy_s()
        device["window_s"] = run.device_profile.window_s()
    if run.tracing and run.profile is not None:
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.profile.top_kernels()],
            "idle_gaps": [[n, s] for n, s in run.profile.idle_gaps()]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from port_bench import harness as H
    entry = H.workload(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs on the GPU only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"port_bench: {args.workload} needs {entry['chips']} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    run = execute(args, "cuda", entry=entry)
    found = H.forbidden_modules()
    if found:
        print(f"port_bench: modules of jax or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    out = result(run)
    print(f"units {run.units} in {run.window_s:.3f} s; latencies (s) "
          + " ".join(f"{x:.3f}" for x in run.latencies), file=sys.stderr)
    if run.unit_busy:
        print("device busy (s) " + " ".join(f"{x:.4f}" for x in run.unit_busy),
              file=sys.stderr)
    if run.tracing and run.device_profile is not None:
        n = run.prof_units // 2
        print(f"device-only sub-window: {n} units, {run.prof_s[0]:.3f} s by "
              f"the host's clock, {run.device_profile.window_s():.3f} s by "
              f"its events, busy {run.device_profile.busy_s():.3f} s; "
              f"attribution sub-window: {n} units, {run.prof_s[1]:.3f} s",
              file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
