"""Milliseconds per training iteration in its input: spans around the
batcher's fetch and around the preprocessor (VAE encode and CLIP)."""

from port_bench import harness as H


def read(run):
    return H.span_ms(run, "train_input")
