"""Kernel B, flash attention: the port's ``core.flash_attention.
flash_attention(q, k, v, ...)`` on (batch, heads, rows, width) operands,
bf16 on the tensor cores or fp32 in 3xTF32."""

from port_bench.counts import kernels as K
from port_bench.counts import peaks


def target():
    from editanything_tpu_torch.core import flash_attention
    return flash_attention, "flash_attention"


def shapes(q, k, v, **_):
    return (tuple(q.shape), tuple(k.shape), tuple(v.shape), q.element_size())


def bound_s(shapes) -> float:
    (b, h, n, dqk), (_, _, m, _), (_, _, _, dv), item = shapes
    peak = peaks.BF16_FLOPS if item == 2 else peaks.FP32_3XTF32_FLOPS
    return K.bound_s(*K.attention_work(b, h, n, m, dqk, dv, item), peak)
