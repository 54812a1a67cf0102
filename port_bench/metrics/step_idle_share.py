"""Percent of the program's steps in which the card waits, in the edit and
training cells (``step_idle_share.<cell kind>``): in the
device-only sub-window, for each ``denoise.step`` (edit) or ``train.step``
(training) span, the time from its start to the end of the last kernel
launched inside it, and of that the time in which none of those kernels
runs; idle over total, summed over the spans. The cell's idle share with
everything outside its steps taken out."""

import bisect

from port_bench import harness as H
from port_bench import program_trace as PT


def idle_share(kernels, steps):
    """Percent idle of the (start, end) `steps` by the kernels (name,
    start, end, launch) launched inside them; None where none was."""
    by_launch = sorted((launch, s, e) for _, s, e, launch in kernels)
    launches = [k[0] for k in by_launch]
    total = idle = 0
    for start, end in steps:
        mine = by_launch[bisect.bisect_left(launches, start):
                         bisect.bisect_right(launches, end)]
        if not mine:
            continue
        last = max(e for _, _, e in mine)
        busy = H.union_length([(max(s, start), e) for _, s, e in mine])
        total += last - start
        idle += last - start - busy
    return 100.0 * idle / total if total > 0 else None


def read(run):
    prof = run.device_profile
    if prof is None:
        return None
    steps = PT.step_spans(run, prof.window)
    return idle_share(prof.kernels, steps) if steps else None
