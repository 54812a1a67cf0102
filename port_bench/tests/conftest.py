"""Shared set-up of the benchmark's tests: the repository root on the
path, the ``cuda`` marker, and each cell at a tiny size on the CPU (the
cell's own traffic, limits and configuration, with the models' widths, the
images and the steps cut so that a run takes seconds; the port takes its
kernels' plain twins there).

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import copy
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

UNET = dict(block_out_channels=[32, 64], layers_per_block=1,
            cross_attention_dim=32, attention_head_dim=[2, 2],
            down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
            up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"],
            norm_num_groups=8)
TINY_MODELS = {
    "unet": UNET,
    "controlnet": {"unet": UNET},
    "vae": dict(block_out_channels=[16, 32, 32, 32], layers_per_block=1,
                norm_num_groups=8),
    "text": dict(hidden_size=32, intermediate_size=64, num_layers=2,
                 num_heads=4),
    "sam": dict(embed_dim=64, depth=2, num_heads=2, global_attn_indexes=[1],
                img_size=128, window_size=4),
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skips without one")


def tiny_cell(cell: str):
    """(workload entry, traffic, configuration) of `cell` cut to a tiny
    size, in fp32."""
    from port_bench import harness as H
    entry = H.workload(cell)
    traffic = copy.deepcopy(H.traffic(entry["traffic"]))
    config = copy.deepcopy(H.config(entry["config"]))
    for part, fields in TINY_MODELS.items():
        if part in config["models"]:
            target = config["models"][part]
            for k, v in fields.items():
                if isinstance(v, dict):
                    target[k].update(v)
                else:
                    target[k] = v
    config["dtype"] = "float32"
    if "amg" in config:
        config["amg"].update(points_per_side=8, points_per_batch=16)
    kind = traffic["driver"]
    if kind == "edit":
        traffic.update(image_hw=[64, 64], steps=3, detect_resolution=128,
                       pool=4, warmup=1)
        traffic["trace"]["profile_units"] = 1
        traffic["check"].update(requests=1, within=2, logit_rows=5)
    elif kind == "sam":
        traffic.update(sizes=[[64, 64], [48, 64], [96, 128], [128, 128]],
                       pool=8, warmup=1)
        traffic["trace"]["profile_units"] = 2
        traffic["check"].update(requests=2, within=3, logit_rows=5)
    else:
        traffic.update(images=4, image_hw=[96, 128], masks=10, samples=64,
                       warm_steps=4, check_steps=3)
        traffic["trace"]["profile_units"] = 2
        config["train"].update(resolution=64)
    return entry, traffic, config


def run_tiny(cell: str, *, seed: int = 2 ** 31 + 17, seconds: float = 1.0,
             trace: int = 0):
    """One run of `cell` at its tiny size on the CPU; returns the Run."""
    from port_bench import run as R
    entry, traffic, config = tiny_cell(cell)
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=trace)
    return R.execute(args, "cpu", entry=entry, traffic=traffic,
                     config=config)


@pytest.fixture
def tiny():
    """The helpers above: ``tiny.cell(name)``, ``tiny.run(name, ...)``."""
    return types.SimpleNamespace(cell=tiny_cell, run=run_tiny)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
