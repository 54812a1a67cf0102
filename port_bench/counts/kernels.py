"""Operations and bytes of the port's kernel entries, computed from the
shapes of a call, and the least time the card could take for them.

A bound is the larger of the operations over the peak rate of the
operands' precision and the bytes over the memory rate, counting each
input read once and each output written once (``peaks.py``). Each of the
port's kernel entries (``entries/<kernel>.py``) takes its bound from a
call's shapes with these functions.
"""

from __future__ import annotations

from port_bench.counts import peaks


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """Least seconds for `ops` operations at `peak` and `nbytes` of device
    memory traffic."""
    return max(ops / peak, nbytes / peaks.HBM_BYTES_PER_S)


def attention_work(b, h, n, m, dqk, dv, itemsize=2):
    """(FLOPs, bytes) of softmax(q k^T) v: both products; q, k, v read and
    the output written once."""
    return (2.0 * b * h * n * m * (dqk + dv),
            itemsize * b * h * (n * dqk + m * dqk + m * dv + n * dv))


def group_norm_work(numel, itemsize=2):
    """(fp32 operations, bytes): ~10 per element (two statistics, the
    affine and SiLU), one read and one write of the activation."""
    return 10.0 * numel, 2.0 * itemsize * numel


def twoway_work(b, t, m, d=256, mlp=2048, layers=2, w_numel=0, v_numel=0,
                itemsize=2):
    """(FLOPs, bytes) of SAM's two-way transformer for b prompts of t
    tokens over one image of m keys of width d: every projection of the
    image rows per prompt (layer 0's token->image k/v projections of the
    shared keys once), both attention products each way, the token-side
    projections and the MLP; bytes: the keys and their positional encoding
    read, the tokens and the packed weights (w_numel matrix entries in the
    storage dtype, v_numel fp32 vectors) read once, keys and queries
    written."""
    di = d // 2
    macs = 0.0
    for layer in range(layers):
        shared = 1 if layer == 0 else b
        macs += 2 * m * d * di * shared            # t2i k, v projections
        macs += 2 * m * d * di * b                 # i2t q, out projections
        macs += 4 * t * m * di * b                 # t2i and i2t products
        macs += b * (4 * t * d * d + 2 * t * t * d  # token self-attention
                     + 4 * t * d * di               # t2i q/out, i2t k/v
                     + 2 * t * d * mlp)             # MLP
    macs += b * (2 * m * d * di + 2 * t * m * di + 2 * t * d * di)  # final
    nbytes = (m * d * (itemsize + 4) + b * t * d * 4 + w_numel * itemsize
              + v_numel * 4 + b * (m + t) * d * itemsize)
    return 2.0 * macs, float(nbytes)


def upscale_work(b, e, itemsize=2):
    """(FLOPs, bytes) of kernel C: per input pixel 4 taps 256->64, per
    first-stage pixel 4 taps 64->32, the 4 hypernetwork products of the 16
    output pixels; keys read, logits written."""
    macs = b * e * e * (4 * 256 * 64 + 16 * 64 * 32 + 16 * 4 * 32)
    return 2.0 * macs, float(itemsize * b * (e * e * 256 + 4 * 16 * e * e))

