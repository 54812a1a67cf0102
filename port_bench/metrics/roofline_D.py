"""Percent of kernel D's roofline, in any cell that runs it
(``roofline_D.<cell kind>``): the bounds of the profiled calls of its
entry (``entries/D.py``) over the device time of the work launched
inside them."""

from port_bench import harness as H


def read(run):
    return H.roofline_share(run, "D")
