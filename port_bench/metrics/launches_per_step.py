"""Host launches per program step, in the edit and training cells
(``launches_per_step.<cell kind>``): in the attribution sub-window,
the distinct launch instants of the kernels whose launch falls inside the
program's ``denoise.step`` (edit) or ``train.step`` (training) spans, over
the number of those spans. The kernels of one CUDA graph's replay share
its ``cudaGraphLaunch`` and count once: this is what the host issues, not
what the device runs."""

import bisect

from port_bench import program_trace as PT


def per_step(kernels, steps):
    """Distinct launch instants of `kernels` (name, start, end, launch)
    inside the (start, end) `steps`, over their number; None with no step
    or no kernel."""
    if not steps or not kernels:
        return None
    steps = sorted(steps)
    starts = [s for s, _ in steps]
    inside = set()
    for _, _, _, launch in kernels:
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= steps[i][1]:
            inside.add(launch)
    return len(inside) / len(steps)


def read(run):
    steps = PT.step_spans(run, PT.attribution_bounds(run))
    return per_step(run.profile.kernels, steps) if steps else None
