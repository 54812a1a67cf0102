"""The harness of the port's benchmark: what every cell shares.

It reads ``BENCHMARK.json`` and finds everything else by name, each in
a file of its own under ``port_bench/``, so that a new cell, driver,
metric, kernel or model part is new files and no edit:

- ``cells/<traffic>.json``: a traffic mix, naming its driver;
- ``configs/<config>.json``: a configuration;
- ``drivers/<driver>.py``: ``setup``, ``window``, ``release``, ``check``
  and ``unit_flops(config, traffic)`` (the model FLOPs of one unit);
- ``metrics/<metric>.py``, else ``metrics/<base>.py`` for a metric named
  ``<base>.<suffix>``: ``read(run)``, None where it finds nothing;
- ``entries/<kernel>.py``: one of the port's kernel entries, wrapped in
  every traced run: ``target()`` (its module and attribute),
  ``shapes(*args, **kwargs)`` and ``bound_s(shapes)``;
- ``parts/<part>.py``: one model of a configuration's ``models``:
  ``reference(fields)`` and ``port(fields)``, each (class, config).

A ``Run`` carries one run: the window's units (requests or iterations)
and their latencies, the benchmark's own spans around the calls into each
layer (synchronised at their boundaries, in the traced run only), the two
profiled sub-windows reduced to kernel intervals, and the numbers that
decide ``correct``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "editanything_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def workload(name: str) -> dict:
    """The BENCHMARK.json entry of a cell."""
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return read_json(ROOT / "cells" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(ROOT / "configs" / f"{name}.json")


def load(kind: str, name: str):
    """The module of ``<kind>/<name>.py`` under the harness's folder, loaded
    from its file once, as ``port_bench.<kind>.<name>``."""
    mod_name = f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {name}.py in {ROOT / kind}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def driver(name: str):
    return load("drivers", name)


def part(name: str):
    return load("parts", name)


def entry_names() -> list:
    return sorted(p.stem for p in (ROOT / "entries").glob("*.py"))


def entry(name: str):
    return load("entries", name)


def metric_reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``, or of ``metrics/<base>.py``
    where a metric ``<base>.<suffix>`` has no file of its own."""
    if not (ROOT / "metrics" / f"{name}.py").is_file():
        name = name.split(".")[0]
    return load("metrics", name).read


def cell_metrics(cell: str):
    """(end-to-end, per-layer) metric entries that `cell` reports."""
    b = benchmark()
    e2e = [m for m in b["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in b["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since the
    harness was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class WindowClosed(Exception):
    """Raised from inside a loop the driver does not own (``train()``'s)
    when the window has closed."""


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Run:
    """One run of one cell."""

    def __init__(self, *, cell: str, seed: int, seconds: float, trace: bool,
                 device, entry: dict, traffic: dict, config: dict):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.tracing = bool(trace)
        self.device = torch.device(device)
        self.entry, self.traffic, self.config = entry, traffic, config
        self.state = {}               # the driver's objects
        self.latencies = []           # seconds per unit in the window
        self.busy_units = False       # profile each unit of the window
        self.unit_busy = []           # device-busy seconds per unit
        self.attempted = self.failed = 0
        self.spans = collections.defaultdict(list)   # name -> [seconds]
        self.units = 0
        self.in_window = False
        self.t_start = self.t_end = None
        self.device_profile = None    # the device-only sub-window, reduced
        self.profile = None           # the attribution sub-window, reduced
        self.prof_units = 0           # units inside both sub-windows
        self.prof_t = (None, None)    # their host-clock ends
        self.prof_s = [0.0, 0.0]      # each one's seconds by the host clock
        self.entry_calls = collections.defaultdict(list)
        self.checks = {}              # name -> (value, limit)
        self.unit_flops = None        # model FLOPs of one unit
        self.setup_s = self.peak_bytes = None
        self._profiler = self._profiling = None

    # -- spans ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        """Seconds of the enclosed call, the device synchronised at both
        ends, in the traced run's window; a no-op otherwise."""
        if not (self.tracing and self.in_window):
            yield
            return
        if self.profiling():
            # inside the profiled sub-window: a named range, no sync, so
            # that the device's idle share is the untouched run's
            with torch.profiler.record_function("bench." + name):
                yield
            return
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
        sync()
        self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, fn, name: str):
        """`fn` with a ``span(name)`` around each call."""
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def device_unit(self):
        """Around one unit of the window: where ``busy_units`` is set (an
        untraced run of a cell whose end-to-end metrics read the device's
        trace), a profile of the device's activity alone over the unit,
        reduced to the seconds in which an operation ran on the device
        (``unit_busy``); a no-op otherwise."""
        if not (self.busy_units and self.in_window):
            yield
            return
        from torch.profiler import profile
        sync()
        prof = profile(activities=device_activities(self.device))
        prof.__enter__()
        try:
            yield
        finally:
            sync()
            prof.__exit__(None, None, None)
        self.unit_busy.append(busy_seconds(prof, self.device))

    # -- the window -------------------------------------------------------

    def begin_window(self):
        sync()
        self.setup_s = process_age_s()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t_start = time.perf_counter()
        self.deadline = self.t_start + self.seconds
        self.in_window = True
        self._maybe_profile()

    def unit_done(self, latency=None, failed: bool = False) -> bool:
        """Count one unit of the window; True once the window has closed."""
        self.units += 1
        self.attempted += 1
        self.failed += int(failed)
        if latency is not None:
            self.latencies.append(latency)
        self._maybe_profile()
        # the traced run's window closes only after its profiled sub-windows
        return not self.profiling() and time.perf_counter() >= self.deadline

    def end_window(self):
        sync()
        self.t_end = time.perf_counter()
        self.in_window = False
        if self._profiling == "device":
            self.device_profile = self._stop_profile()
        elif self._profiling == "attribution":
            self.profile = self._stop_profile()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    # -- the profiled sub-windows -------------------------------------------
    #
    # A traced run profiles its first 2 x ``profile_units`` units in two
    # sub-windows: the first records the device's activity alone (kernels,
    # copies and the runtime calls that launch them, no host op), so that
    # the host runs as nearly as untraced and the device's busy time and
    # idle share are the run's; the second adds the host's ops, which
    # attribute kernels to the benchmark's spans (the rooflines) and name
    # the idle gaps (the breakdown). Then it measures for --seconds more.

    def _maybe_profile(self):
        if not self.tracing:
            return
        n = int(self.traffic["trace"]["profile_units"])
        if self.units == 0 and self._profiler is None and self.profile is None:
            self._start_profile("device")
        elif self._profiling == "device" and self.units >= n:
            self.device_profile = self._stop_profile()
            self._start_profile("attribution")
        elif self._profiling == "attribution" and self.units >= 2 * n:
            self.profile = self._stop_profile()
            self.prof_units = self.units
            # the units after this instant are the MFU's and the spans':
            # the traced run measures for --seconds more from here
            self.prof_t = (self.prof_t[0], time.perf_counter())
            self.deadline = self.prof_t[1] + self.seconds

    def _start_profile(self, kind: str):
        from torch.profiler import ProfilerActivity, profile
        acts = device_activities(self.device)
        if kind == "attribution" and ProfilerActivity.CPU not in acts:
            acts.append(ProfilerActivity.CPU)
        sync()
        self._profiler = profile(activities=acts)
        self._profiler.__enter__()
        self._profiling = kind
        self._prof_t0 = time.perf_counter()
        if kind == "device":
            self.prof_t = (self._prof_t0, None)

    def _stop_profile(self):
        sync()
        self.prof_s[self._profiling == "attribution"] = (
            time.perf_counter() - self._prof_t0)
        prof, self._profiler, self._profiling = self._profiler, None, None
        prof.__exit__(None, None, None)
        return reduce_profile(prof)

    def profiling(self) -> bool:
        return self._profiler is not None

    def attributing(self) -> bool:
        """Inside the sub-window that records the host's ops."""
        return self._profiling == "attribution"

    # -- results ------------------------------------------------------------

    def check(self, name: str, value: float, limit: float):
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0 and bool(self.checks)
                and all(math.isfinite(v) and v <= lim
                        for v, lim in self.checks.values()))


# ---------------------------------------------------------------------------
# the profiler's events, reduced
# ---------------------------------------------------------------------------

def union_length(intervals) -> float:
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


def device_activities(device) -> list:
    """The profiler's activities that record a device's work alone: CUDA
    activity on a card, the host's ops where the device is the CPU."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA if torch.device(device).type == "cuda"
            else ProfilerActivity.CPU]


def warm_profiler(device):
    """One short device-only profile, so that the profiler's own start-up
    is set-up's and not the window's first unit's."""
    from torch.profiler import profile
    with profile(activities=device_activities(device)):
        torch.ones(64, device=device).sum()
        sync()


def busy_seconds(prof, device) -> float:
    """Seconds in which an operation ran on the device in a finished
    device-only profile: the union of its operations' intervals."""
    kind = (torch.autograd.DeviceType.CUDA
            if torch.device(device).type == "cuda"
            else torch.autograd.DeviceType.CPU)
    ivs = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == kind and not e.name().startswith("bench.")]
    return union_length(ivs) / 1e9


class Profile:
    """Kernels of the profiled sub-window: (name, start, end, the host time
    of its launch) in ns, and the host ranges of the benchmark's spans and
    of the host ops."""

    def __init__(self, kernels, ranges, ops, window):
        self.kernels, self.ranges, self.ops = kernels, ranges, ops
        self.window = window          # (start, end) ns of the sub-window

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_length([(max(s, lo), min(e, hi)) for _, s, e, _ in
                              self.kernels if e > lo and s < hi]) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def device_seconds_in(self, span: str) -> float:
        """Device seconds of the kernels launched inside ``bench.<span>``."""
        ranges = sorted(self.ranges.get("bench." + span, []))
        starts = [s for s, _ in ranges]
        total = 0.0
        for _, s, e, launch in self.kernels:
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= ranges[i][1]:
                total += e - s
        return total / 1e9

    def top_kernels(self, k: int = 10):
        by = collections.defaultdict(float)
        for name, s, e, _ in self.kernels:
            by[name[:120]] += (e - s) / 1e9
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The longest gaps with no kernel running, each named by the
        innermost benchmark span and host op running when it began."""
        ivs = sorted((s, e) for _, s, e, _ in self.kernels)
        gaps, end = [], self.window[0]
        for s, e in ivs:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        named = collections.defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
            named[self._host_at(a)] += (b - a) / 1e9
        return sorted(named.items(), key=lambda kv: -kv[1])[:k]

    def _host_at(self, t) -> str:
        span = op = None
        for name, ranges in self.ranges.items():
            for s, e in ranges:
                if s <= t <= e and (span is None or s > span[0]):
                    span = (s, name)
        for s, e, name in self.ops:
            if s <= t <= e and (op is None or s > op[0]):
                op = (s, name)
        return "/".join(x[1] for x in (span, op) if x) or "host"


def reduce_profile(prof) -> Profile:
    """Kernel intervals with their launch times, from the profiler's
    events: a kernel's launch is the host runtime call of the same
    correlation id."""
    events = prof.profiler.kineto_results.events()
    launches, kernels, ranges, ops = {}, [], collections.defaultdict(list), []
    starts, ends = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device-side copies of the benchmark's ranges are no work
            if not e.name().startswith("bench."):
                kernels.append(e)
            continue
        name = e.name()
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        starts.append(s)
        ends.append(t)
        if name.startswith("bench."):
            ranges[name].append((s, t))
        elif name.startswith(("cuda", "cu")) and "Launch" in name:
            launches[e.correlation_id()] = s
        elif name.startswith("aten::"):
            ops.append((s, t, name))
    out = []
    for k in kernels:
        launch = launches.get(k.correlation_id(),
                              launches.get(k.linked_correlation_id(), -1))
        out.append((k.name(), k.start_ns(), k.start_ns() + k.duration_ns(),
                    launch))
    lo = min(starts + [k[1] for k in out]) if (starts or out) else 0
    hi = max(ends + [k[2] for k in out]) if (ends or out) else 0
    return Profile(out, dict(ranges), ops, (lo, hi))


# ---------------------------------------------------------------------------
# kernel entries: spans around the port's kernel wrappers
# ---------------------------------------------------------------------------

def wrap_kernel_entries(run: Run):
    """Put a ``bench.<kernel>`` span around every call of each kernel entry
    that ``entries/`` names, and record each call's shapes while the
    attribution sub-window runs. A wrapper keeps the ``launches`` counter
    the original bumps."""
    def wrap(module, attr, tag, shapes):
        orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if not run.attributing():
                return orig(*args, **kwargs)
            run.entry_calls[tag].append(shapes(*args, **kwargs))
            with torch.profiler.record_function("bench." + tag):
                return orig(*args, **kwargs)
        if hasattr(orig, "launches"):
            wrapped.launches = orig.launches
        wrapped.__wrapped__ = orig
        setattr(module, attr, wrapped)

    for name in entry_names():
        spec = entry(name)
        wrap(*spec.target(), name, spec.shapes)


def roofline_share(run: Run, kernel: str):
    """Percent: the sum over the profiled calls of the kernel's bound over
    the device seconds of the work launched inside those calls."""
    calls = run.entry_calls.get(kernel)
    if not calls or run.profile is None:
        return None
    seconds = run.profile.device_seconds_in(kernel)
    if seconds <= 0.0:
        return None
    bound_s = entry(kernel).bound_s
    return 100.0 * sum(bound_s(c) for c in calls) / seconds


def mfu(run: Run, peak: float):
    """Percent of `peak` FLOP/s: the model FLOPs of the units after the
    profiled sub-window over that part's seconds."""
    if run.unit_flops is None or run.prof_t[1] is None:
        return None
    units = run.units - run.prof_units
    seconds = run.t_end - run.prof_t[1]
    if units <= 0 or seconds <= 0:
        return None
    return 100.0 * run.unit_flops * units / seconds / peak


def idle_share(run: Run):
    """Percent of the device-only sub-window with no kernel running."""
    prof = run.device_profile
    if prof is None or prof.window_s() <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s())


def unit_s(run: Run):
    """Seconds per unit by the host's clock (each unit's latency), over
    the traced run's units after its profiled sub-windows."""
    lat = run.latencies[run.prof_units:]
    return sum(lat) / len(lat) if lat else None


def span_ms(run: Run, name: str, divide: float = 1.0):
    """Milliseconds of span `name` per unit of the window (summed over the
    unit's calls), over `divide`. Spans are timed only after the profiled
    sub-window, so the units are those after it."""
    vals = run.spans.get(name)
    if not vals:
        return None
    return 1e3 * sum(vals) / max(1, run.units - run.prof_units) / divide
