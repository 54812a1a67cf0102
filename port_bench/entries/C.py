"""Kernel C, SAM's upscale and hypernetwork products: the port's
``core.kernels.sam_upscale_hyper(src, hyper, ...)`` on a batch of prompts'
square key maps."""

import math

from port_bench.counts import kernels as K
from port_bench.counts import peaks


def target():
    from editanything_tpu_torch.core import kernels
    return kernels, "sam_upscale_hyper"


def shapes(src, hyper, *_, **__):
    return (src.shape[0], math.isqrt(src.shape[1]), src.element_size())


def bound_s(shapes) -> float:
    b, e, item = shapes
    return K.bound_s(*K.upscale_work(b, e, item),
                     peaks.BF16_FLOPS if item == 2 else peaks.FP32_FLOPS)
