"""Milliseconds per edit request in the SAM phase: the span around
EditAnythingEditor.get_sam_control inside process (encoder, AMG, ID
map)."""

from port_bench import harness as H


def read(run):
    return H.span_ms(run, "sam_phase")
