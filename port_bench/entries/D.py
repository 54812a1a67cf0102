"""Kernel D, SAM's two-way transformer: the port's ``core.kernels.
sam_twoway(packed, src1, pe, tokens)`` for a batch of prompts over one
image's keys."""

from port_bench.counts import kernels as K
from port_bench.counts import peaks


def target():
    from editanything_tpu_torch.core import kernels
    return kernels, "sam_twoway"


def shapes(packed, src1, pe, tokens):
    return (tokens.shape[0], tokens.shape[1], src1.shape[1], src1.shape[2],
            packed.w.numel(), packed.v.numel(), src1.element_size())


def bound_s(shapes) -> float:
    b, t, m, d, w_numel, v_numel, item = shapes
    return K.bound_s(*K.twoway_work(b, t, m, d, w_numel=w_numel,
                                    v_numel=v_numel, itemsize=item),
                     peaks.BF16_FLOPS if item == 2 else peaks.FP32_FLOPS)
