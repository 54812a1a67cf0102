"""Percent of the device-only profiled sub-window with no kernel running on
the card: 1 - the union of kernel intervals over the sub-window, in any
cell (``idle_share.<cell kind>``)."""

from port_bench import harness as H


def read(run):
    return H.idle_share(run)
