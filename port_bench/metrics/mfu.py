"""Percent of the card's peak for the configuration's precision
(``peaks.model_peak``): a unit's model FLOPs (the driver's
``unit_flops``) times the units after the profiled sub-windows, over their
seconds, in any cell (``mfu.<cell kind>``)."""

from port_bench import harness as H
from port_bench.counts import peaks


def read(run):
    return H.mfu(run, peaks.model_peak(run.config))
