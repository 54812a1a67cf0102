"""Milliseconds per training iteration in the step: the span around
train_step (forward, backward, Adam, EMA)."""

from port_bench import harness as H


def read(run):
    return H.span_ms(run, "train_step")
