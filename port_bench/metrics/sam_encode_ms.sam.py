"""Milliseconds per segment-everything request in SAM's image encoder: the
span around the editor's encode function."""

from port_bench import harness as H


def read(run):
    return H.span_ms(run, "sam_encode")
