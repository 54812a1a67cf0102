"""Milliseconds per segment-everything request in the AMG after the
encoder: spans around the candidates' decode and selection and around
the ID map."""

from port_bench import harness as H


def read(run):
    return H.span_ms(run, "amg_decode")
