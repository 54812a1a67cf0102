"""Data parallelism over ``torch.distributed``: two ``gloo`` processes on
the CPU against one process.

Each rank holds the whole tiny model, takes its slice of the global batch
and draws the noise of the whole batch (``parallel/sharding.py``), so two
ranks give what one process gives with the whole batch:
- ControlNet ``train()`` and DreamBooth ``train()`` (full finetune, prior
  preservation: each rank holds whole (instance, class) pairs) for 2
  steps: the DDP-averaged gradients equal one process's within 2e-5 of
  each tensor's largest, the parameters after the second Adam update
  within 1e-2 of the rate (where the gradients' signs are sure), and both
  ranks end equal to the bit;
- a ``GenerationPipeline`` request, an ``EditPipeline`` request with
  DDIM at eta 0.5 in the "mix" mode (per-step noises of the global batch,
  sliced on their batch axis) and an ``Img2ImgPipeline`` request: the
  gathered uint8 images equal one process's (oneDNN off: its convolutions change kernels with the batch).
JAX folds the shard index into its per-step keys instead, so its mesh runs
draw other noise than one device; the port's draws are a deliberate
difference. The sharding helpers are held on one process as well.
"""

import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from editanything_tpu_torch.parallel import sharding as S
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.pipelines.img2img import Img2ImgPipeline
from editanything_tpu_torch.train import train_controlnet as TC
from editanything_tpu_torch.train import train_dreambooth as TD
from editanything_tpu_torch.utils.image import write_png

GRAD_TOL = 2e-5
SIGN_FLOOR = 1e-3
CN_LR = 1e-5
DB_LR = 1e-3
WORLD = 2
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread, and convolutions without oneDNN, whose kernels change
    with the batch: the native ones run each sample alone, so a rank's
    half batch computes what the whole batch computes for it."""
    saved = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(saved[0])
    torch.backends.mkldnn.enabled = saved[1]


def _sa1b_folder(d, n=4):
    from editanything_tpu_torch.ops import rle
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


def _images(d, n, size, seed):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        write_png(os.path.join(d, f"img_{i}.png"),
                  rng.randint(0, 255, (size, size, 3)).astype(np.uint8))


def _inputs(root):
    """The data every run reads."""
    os.makedirs(os.path.join(root, "sa1b"))
    _sa1b_folder(os.path.join(root, "sa1b"))
    _images(os.path.join(root, "inst"), 2, 40, 1)
    _images(os.path.join(root, "cls"), 2, 40, 2)


def _request_inputs():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    cond = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 8:40] = 255
    return img, cond, mask


def _trained(state_module, out_dir):
    """A trained module's parameters, the gradients of its last step (left
    on the module) and of its first (Adam's first moment after one step is
    0.1 g: the step-1 checkpoint's, by the optimizer's parameter order)."""
    ckpt = torch.load(os.path.join(out_dir, "ckpt", "step_1.pt"),
                      weights_only=True)
    names = [n for n, _ in state_module.named_parameters()]
    first = {names[i]: s["exp_avg"] / 0.1
             for i, s in ckpt["opt_state"]["state"].items()}
    return {"params": {k: v.detach().clone()
                       for k, v in state_module.named_parameters()},
            "grads": {k: v.grad.clone()
                      for k, v in state_module.named_parameters()},
            "first": first}


def _runs(root, tag, group):
    """Every run of the module, in this process: what the trainers trained
    and the requests' images."""
    out = {}
    cn = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",),
                       generator=torch.Generator().manual_seed(3))
    d = os.path.join(root, f"cn_{tag}")
    state = TC.train(data_path=os.path.join(root, "sa1b"),
                     txt_path=os.path.join(root, "sa1b", "data.txt"),
                     out_dir=d, bundle=cn, batch_size=2, resolution=64,
                     max_steps=2, lr=CN_LR, image_every=100, ckpt_every=1,
                     use_ema=False, device="cpu", group=group)
    out["controlnet"] = _trained(state.controlnet, d)
    db = random_bundle(tiny=True, device="cpu", family="sd15_inpaint",
                       controlnet_names=(),
                       generator=torch.Generator().manual_seed(4))
    d = os.path.join(root, f"db_{tag}")
    state = TD.train(instance_data_dir=os.path.join(root, "inst"),
                     instance_prompt="a photo of a cat", output_dir=d,
                     bundle=db, class_data_dir=os.path.join(root, "cls"),
                     class_prompt="a photo of a dog",
                     with_prior_preservation=True, num_class_images=2,
                     batch_size=2, lr=DB_LR, max_steps=2, resolution=32,
                     ckpt_every=1, device="cpu", group=group)
    out["dreambooth"] = _trained(state.unet, d)

    bundle = random_bundle(tiny=True, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    img, cond, mask = _request_inputs()
    out["generate"] = GenerationPipeline(bundle, group=group)(
        prompt="a photo of a cat", condition_image=cond, num_samples=2,
        image_resolution=64, num_steps=3, seed=7)
    out["edit"] = EditPipeline(bundle, inpaint_mode="mix", group=group)(
        image=img, mask=mask, prompt="a dog", condition_image=cond,
        num_samples=2, image_resolution=64, num_steps=3, sampler="ddim",
        eta=0.5, seed=8)
    out["img2img"] = Img2ImgPipeline(bundle, group=group)(
        image=img, prompt="a dog", condition_image=cond, num_samples=2,
        image_resolution=64, num_steps=4, seed=9)
    return out


def _worker(rank, port, root):
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        out = _runs(root, "ddp", dist.group.WORLD)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    _inputs(root)
    ctx = mp.start_processes(_worker, args=(_free_port(), root),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        # join returns False while a rank is still running
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return _runs(root, "one", None), ranks


@pytest.mark.parametrize("name", ["controlnet", "dreambooth"])
def test_two_ranks_train_as_one_process(results, name):
    """The first step's gradients (DDP's average) within 2e-5 of each
    tensor's largest (one process sums the batch in one reduction, the
    ranks in two; 5.2e-6 measured); the parameters after the second update
    within 1e-2 of the rate where both steps' gradients are above 1e-3 of
    their tensor's largest (Adam's first updates go by the gradient's sign,
    and at rounding noise the sign is noise, so a parameter bound of 1e-6
    of the largest cannot hold); the ranks equal to the bit."""
    one, ranks = results
    lr = CN_LR if name == "controlnet" else DB_LR
    want = one[name]
    for r in ranks:
        for part in ("params", "grads"):
            for k, v in r[name][part].items():
                assert torch.equal(v, ranks[0][name][part][k]), (part, k)
    got = ranks[0][name]
    compared = total = 0
    for k, p in want["params"].items():
        g, w = got["first"][k], want["first"][k]
        scale = float(w.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_TOL * scale)
        sure = torch.ones_like(p, dtype=torch.bool)
        for part in ("first", "grads"):
            w = want[part][k]
            sure &= w.abs() > SIGN_FLOOR * w.abs().max()
        err = float((got["params"][k] - p).abs()[sure].max()) if sure.any() \
            else 0.0
        assert err <= 1e-2 * lr, (k, err)
        compared += int(sure.sum())
        total += p.numel()
    assert compared > 0.5 * total


@pytest.mark.parametrize("name", ["generate", "edit", "img2img"])
def test_two_ranks_request_as_one_process(results, name):
    one, ranks = results
    for r in ranks:
        assert r[name].shape == one[name].shape == (2, 64, 64, 3)
        np.testing.assert_array_equal(r[name], one[name])
    # the two samples differ: each rank denoised its own
    assert not np.array_equal(one[name][0], one[name][1])


def test_sharding_helpers_on_one_process():
    x = torch.arange(12).reshape(6, 2)
    assert S.shard_batch(x, None) is x and S.gather_batch(x, None) is x
    assert S.rank_and_size(None) == (0, 1) and S.default_group() is None
    net = torch.nn.Linear(2, 2)
    assert S.unwrap(net) is net and S.replicate(net, None) is net
    assert torch.equal(S.mean_over(torch.tensor(3.0), None),
                       torch.tensor(3.0))
    assert S.init_from_env("cpu") == "cpu"
