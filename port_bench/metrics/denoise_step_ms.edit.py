"""Milliseconds per denoise step: the span around the edit pipeline's
run_denoise (ControlNets, UNet, UniPC and the blend over all steps) over
the steps."""

from port_bench import harness as H


def read(run):
    return H.span_ms(run, "denoise", divide=run.traffic["steps"])
