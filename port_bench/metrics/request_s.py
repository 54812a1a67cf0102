"""Seconds per request (or unit) by the host's clock: each unit's latency,
averaged over the traced run's units after its profiled sub-windows, in
any cell (``request_s.<cell kind>``)."""

from port_bench import harness as H


def read(run):
    return H.unit_s(run)
