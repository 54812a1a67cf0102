"""The program's own spans and counters (``editanything_tpu_torch.utils
.trace``) in the traced run's profiled sub-windows, for the per-layer
metrics that read them.

The program records while a profile records, and stamps the profiler's
clock, so its events fall inside the sub-window that recorded them. In a
traced run nothing else turns it on, and between the two sub-windows only
the harness runs: so the attribution sub-window's events are those after
the device-only sub-window's last event, up to its own last. A checkout
whose program has no such module reads nothing: ``events()`` is None.
"""

from __future__ import annotations

# the program's span around one step, by the cell's kind of traffic
STEP_SPAN = {"edit": "denoise.step", "train": "train.step"}


def events():
    """The program's buffered events, or None without the module: spans
    as (name, start_ns, end_ns, depth), counters as (name, t_ns, n)."""
    try:
        from editanything_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.events()


def attribution_bounds(run):
    """(lo, hi) ns of the attribution sub-window for the program's events,
    or None without it."""
    if run.profile is None:
        return None
    lo = (run.device_profile.window[1] if run.device_profile is not None
          else run.profile.window[0])
    return lo, run.profile.window[1]


def spans(evs, name: str, bounds):
    """[(start, end)] of the spans `name` that lie inside `bounds`."""
    lo, hi = bounds
    return [(ev[1], ev[2]) for ev in evs
            if len(ev) == 4 and ev[0] == name and lo <= ev[1]
            and ev[2] <= hi]


def counted(evs, prefix: str, bounds) -> int:
    """The total of the counters whose names start with `prefix`, at
    instants inside `bounds`."""
    lo, hi = bounds
    return sum(ev[2] for ev in evs
               if len(ev) == 3 and ev[0].startswith(prefix)
               and lo < ev[1] <= hi)


def step_spans(run, bounds):
    """The program's step spans of the cell's kind inside `bounds`, or
    None where the kind has none or the program records none."""
    name = STEP_SPAN.get(run.traffic["driver"])
    evs = events()
    if name is None or evs is None or bounds is None:
        return None
    return spans(evs, name, bounds)
