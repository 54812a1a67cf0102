"""Percent of kernel A's roofline, in any cell that runs it
(``roofline_A.<cell kind>``): the bounds of the profiled calls of its
entry (``entries/A.py``) over the device time of the work launched
inside them."""

from port_bench import harness as H


def read(run):
    return H.roofline_share(run, "A")
