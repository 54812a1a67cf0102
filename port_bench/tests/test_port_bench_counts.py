"""The yardstick's arithmetic pinned at known shapes: the kernels' bounds
(as PERF.md's tables give them) and the model FLOPs of each cell's unit."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness as H
from port_bench.counts import kernels as K
from port_bench.counts import models as M
from port_bench.counts import peaks


def test_attention_bound():
    # B at (4, 8, 4096, 4096, 40): 2 x 4 x 8 x 4096^2 x 80 FLOP at 989 TFLOP/s
    ops, nbytes = K.attention_work(4, 8, 4096, 4096, 40, 40)
    assert ops == 2 * 4 * 8 * 4096 * 4096 * 80
    assert K.bound_s(ops, nbytes, peaks.BF16_FLOPS) * 1e3 == \
        pytest.approx(0.0869, abs=5e-5)
    shapes = ((4, 8, 4096, 40), (4, 8, 4096, 40), (4, 8, 4096, 40), 2)
    assert H.entry("B").bound_s(shapes) == \
        pytest.approx(ops / 989e12, rel=1e-12)
    # fp32 at fp32 accuracy on the tensor cores: 3xTF32, 165 TFLOP/s
    f32 = shapes[:3] + (4,)
    assert H.entry("B").bound_s(f32) * 1e3 == pytest.approx(0.5206, abs=5e-5)


def test_group_norm_bound_is_bytes():
    numel = 4 * 320 * 64 * 64
    t = H.entry("A").bound_s((numel, 2))
    assert t == pytest.approx(2 * 2 * numel / 3.35e12, rel=1e-12)


def test_twoway_and_upscale():
    ops, nbytes = K.upscale_work(256, 64)
    assert ops == 2.0 * 256 * 64 * 64 * (4 * 256 * 64 + 16 * 64 * 32
                                         + 16 * 4 * 32)
    assert H.entry("C").bound_s((256, 64, 2)) == \
        pytest.approx(max(ops / 989e12, nbytes / 3.35e12), rel=1e-12)
    ops, nbytes = K.twoway_work(256, 6, 4096)
    assert ops == 575477383168.0
    assert H.entry("D").bound_s((256, 6, 4096, 256, 0, 0, 2)) == \
        pytest.approx(ops / 989e12, rel=1e-12)


def test_peaks():
    assert peaks.FP32_3XTF32_FLOPS == pytest.approx(165e12)
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    # each configuration's MFU against its precision's peak
    assert peaks.model_peak(H.config("sd15_sam_edit")) == peaks.BF16_FLOPS
    assert peaks.model_peak(H.config("sd15_controlnet_train")) == \
        peaks.FP32_3XTF32_FLOPS
    assert peaks.model_peak({"dtype": "float32", "tf32": True}) == \
        peaks.TF32_FLOPS


def test_flop_counter_counts_products():
    lin = torch.nn.Linear(4, 8, device="meta")
    assert M._count(lambda: lin(torch.empty(3, 4, device="meta"))) == \
        2 * 3 * 4 * 8


@pytest.mark.parametrize("cell,tflop", [("edit_ui", 176.79),
                                        ("sam_amg", 9.65),
                                        ("train_b4", 13.58)])
def test_unit_flops_at_published_widths(cell, tflop):
    entry = H.workload(cell)
    traffic = H.traffic(entry["traffic"])
    flops = H.driver(traffic["driver"]).unit_flops(
        H.config(entry["config"]), traffic)
    assert flops / 1e12 == pytest.approx(tflop, abs=0.005)
