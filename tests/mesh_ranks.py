"""The rank side of tests/test_torch_mesh.py: what each of the four
``gloo`` processes of a (2, 2) mesh runs, and what the test process runs
alone with the same weights and data. Imports neither jax nor the JAX
package, so the spawned ranks start without them.

A tiny SD1.5 bundle whose UNet and ControlNet are wide enough for FSDP
(``block_out_channels=(64, 128)``: 147 456-element convs, over the 2^16
floor) and whose first level has one head (kept whole on 2 model ranks,
where JAX splits its columns) and the mid block four (split by heads).
"""

import dataclasses
import json
import os
import shutil
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from editanything_tpu_torch.models import config as C
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.parallel import sharding as S
from editanything_tpu_torch.pipelines.bundle import (_empty, init_weights_,
                                                     random_bundle)
from editanything_tpu_torch.samplers.schedule import make_schedule
from editanything_tpu_torch.train import controlnet_train as T
from editanything_tpu_torch.train import train_controlnet as TC
from editanything_tpu_torch.utils.image import write_png

WORLD = 4
MESH = (2, 2)
CN_LR = 1e-5
# a collective that one rank never joins fails the run after this long
# instead of hanging it (a preview run on rank 0 alone, say)
COLLECTIVE_TIMEOUT_S = 60
REMAT_MODES = (False, True, "full", "offload")


def tiny_mesh_bundle():
    """The tiny bundle (weights from seed 3) with a (64, 128)-wide UNet and
    ControlNet, heads (1, 4)."""
    tb = random_bundle(tiny=True, device="cpu", controlnet_names=(),
                       generator=torch.Generator().manual_seed(3))
    ucfg = dataclasses.replace(tb.unet_cfg, block_out_channels=(64, 128),
                               attention_head_dim=(1, 4))
    cn_cfg = C.ControlNetConfig(unet=ucfg)
    g = torch.Generator().manual_seed(4)
    unet = init_weights_(_empty(UNet2DConditionModel, ucfg, "cpu",
                                torch.float32), g)
    cn = init_weights_(_empty(ControlNetModel, cn_cfg, "cpu", torch.float32),
                       g)
    return dataclasses.replace(tb, unet_cfg=ucfg, unet=unet,
                               controlnets={"sam": (cn_cfg, cn)})


def sa1b_folder(d, n=4):
    """An SA-1B-layout folder of n 80 x 96 PNGs with 3 RLE masks each."""
    from editanything_tpu_torch.ops import rle
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        write_png(os.path.join(d, f"im{i}.png"),
                  rng.randint(0, 255, (80, 96, 3)).astype(np.uint8))
        masks = []
        for _ in range(3):
            m = np.zeros((80, 96), np.uint8)
            y, x = rng.randint(0, 60), rng.randint(0, 70)
            m[y:y + 20, x:x + 20] = 1
            masks.append({"segmentation": rle.encode(m)})
        with open(os.path.join(d, f"im{i}.json"), "w") as f:
            json.dump({"image": {"height": 80, "width": 96},
                       "annotations": masks}, f)
        lines.append(repr({"target": f"im{i}.png", "source": f"im{i}.json",
                           "prompt": f"a photo of a cat {i}"}))
    with open(os.path.join(d, "data.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def train_kwargs(root, out_dir):
    """One ``train()`` run's arguments: batch 2 at 64^2, remat "dots",
    EMA, DDIM previews (2 steps) at step 2, a checkpoint every step."""
    data = os.path.join(root, "sa1b")
    return dict(data_path=data, txt_path=os.path.join(data, "data.txt"),
                out_dir=out_dir, batch_size=2, resolution=64, lr=CN_LR,
                log_every=1, image_every=2, sample_steps=2, ckpt_every=1,
                remat=True, use_ema=True, device="cpu")


def seed_resume(src_ckpt, out_dir):
    """A run directory whose only checkpoint is `src_ckpt`."""
    os.makedirs(os.path.join(out_dir, "ckpt"))
    shutil.copy(src_ckpt, os.path.join(out_dir, "ckpt", "step_1.pt"))


class CountAllReduces(TorchDispatchMode):
    """Counts the functional all-reduces that run (an op a selective
    checkpoint serves from its saved outputs does not reach this mode)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops._c10d_functional.all_reduce.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


def mesh_steps(mesh, draws):
    """One SGD step (rate 1) of the laid-out ControlNet in each remat mode,
    on the global batch `draws` (its t and noise JAX's), split over "data":
    the loss (its mean over the data ranks), the grad norm, every gradient
    gathered whole, the all-reduces that ran and the row-parallel layers."""
    b = tiny_mesh_bundle()
    b.unet.requires_grad_(False)
    group = S.data_group(mesh)
    batch = {k: S.shard_batch(v, group) for k, v in draws["batch"].items()}
    t, noise = (S.shard_batch(draws[k], group) for k in ("t", "noise"))
    out = {}
    for remat in REMAT_MODES:
        state = T.init_train_state(b.controlnets["sam"][1],
                                   lambda p: torch.optim.SGD(p, lr=1.0))
        S.shard_params_tp(mesh, state.controlnet, also_fsdp=True)
        step = T.make_train_step(make_schedule(), remat=remat)
        with CountAllReduces() as counter:
            _, m = step(state, b.unet, batch, t=t, noise=noise)
        layout = S.layout_of(state.controlnet)
        out[remat] = {
            "loss": float(S.mean_over(m["loss"], group)),
            "grad_norm": float(m["grad_norm"]),
            "grads": {k: layout.full(p.grad, layout.placements[k])
                      for k, p in layout.params.items()},
            "all_reduces": counter.count,
            "row_layers": sum(isinstance(x, S.RowParallelLinear)
                              for x in state.controlnet.modules())}
    return out


def rank_runs(mesh, root):
    """Everything a rank runs: the remat modes' steps, ``train(mesh=...)``
    fresh for 2 steps (previews, checkpoints, the EMA's export), a resume
    from the one-process run's step-1 checkpoint, and a txt2img request
    on the mesh."""
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    out["steps"] = mesh_steps(mesh, torch.load(
        os.path.join(root, "draws.pt"), weights_only=True))
    state = TC.train(bundle=tiny_mesh_bundle(), mesh=mesh, max_steps=2,
                     export_path=os.path.join(root, "mesh.safetensors"),
                     **train_kwargs(root, os.path.join(root, "mesh")))
    layout = S.layout_of(state.controlnet)
    out["placements"] = dict(layout.placements)
    out["kept_whole"] = list(layout.kept_whole)
    out["local_shapes"] = {k: tuple(p.shape)
                           for k, p in layout.params.items()}
    out["params"] = S.full_state_dict(state.controlnet)
    out["ema"] = S.full_state_dict(state.ema)
    resumed = TC.train(bundle=tiny_mesh_bundle(), mesh=mesh, max_steps=2,
                       **train_kwargs(root, os.path.join(root,
                                                         "mesh_resume")))
    out["resumed"] = S.full_state_dict(resumed.controlnet)
    out["resumed_step"] = resumed.step
    out["generate"] = generate(mesh)
    return out


def generate(mesh=None):
    """A txt2img request of 2 samples (on a mesh each data group splits
    them) with the tiny bundle of tests/test_torch_parallel.py."""
    from editanything_tpu_torch.pipelines.generate import GenerationPipeline
    bundle = random_bundle(tiny=True, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    cond = np.random.RandomState(3).randint(0, 255, (64, 64, 3)).astype(
        np.uint8)
    return GenerationPipeline(bundle, mesh=mesh)(
        prompt="a photo of a cat", condition_image=cond, num_samples=2,
        image_resolution=64, num_steps=3, seed=7)


def worker(rank, port, root):
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = rank_runs(S.make_mesh(*MESH), root)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
