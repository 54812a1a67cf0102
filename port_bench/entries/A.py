"""Kernel A, GroupNorm(+SiLU): the port's ``core.kernels.
group_norm_silu(x, ...)``, its statistics and affine in fp32."""

from port_bench.counts import kernels as K
from port_bench.counts import peaks


def target():
    from editanything_tpu_torch.core import kernels
    return kernels, "group_norm_silu"


def shapes(x, *_, **__):
    return (x.numel(), x.element_size())


def bound_s(shapes) -> float:
    numel, item = shapes
    return K.bound_s(*K.group_norm_work(numel, item), peaks.FP32_FLOPS)
