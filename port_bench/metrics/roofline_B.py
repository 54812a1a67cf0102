"""Percent of kernel B's roofline, in any cell that runs it
(``roofline_B.<cell kind>``): the bounds of the profiled calls of its
entry (``entries/B.py``) over the device time of the work launched
inside them."""

from port_bench import harness as H


def read(run):
    return H.roofline_share(run, "B")
