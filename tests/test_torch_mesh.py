"""The (data, model) mesh: tensor-parallel and FSDP ControlNet training,
four ``gloo`` processes on the CPU as a (2, 2) mesh against one process
and against JAX's own mesh.

- Layout: the tensors JAX's ``shard_params_tp(..., also_fsdp=True)`` and
  ``shard_params_fsdp`` split on (1, 2), (2, 1) and (2, 2) meshes of the
  conftest's CPU devices, and the axis of each (carried to the port's
  layout by JAX's own ``tree_to_diffusers``), equal the port's
  ``layout_plan``, apart from the layers the port keeps whole where their
  heads do not divide.
- ``train(mesh=...)`` on the ranks (tests/mesh_ranks.py) for 2 steps with
  remat "dots", the EMA, previews at step 2 on every rank, a checkpoint
  every step and the export, against ``train()`` in one process: the first
  step's gradients (Adam's first moment over 0.1) within 2e-5 of each
  tensor's largest (fp32 sums over other splits: a row-parallel layer's
  over the model ranks, the batch's over the data ranks); the parameters
  and the EMA after the second update within 1e-2 of the rate where both
  steps' gradients are above 1e-3 of their tensor's largest (Adam's first
  updates go by the gradient's sign); loss and grad norm 1e-5 relative;
  every rank's gathered parameters equal to the bit; a (2, 2) checkpoint
  resumed in one process and a one-process checkpoint resumed on (2, 2)
  each within those bounds of a one-process resume; a txt2img request on
  the mesh returns the one-process images.
- One JAX step (SGD at 2^20 recovers its gradients, as in
  tests/test_torch_train.py) on a state laid out by JAX's
  ``shard_params_tp(make_mesh(2, 2), ..., also_fsdp=True)`` against the
  port's (2, 2) step on the same draws, in every remat mode: loss 1e-5
  relative, gradients 2e-5 of each tensor's largest. "dots" runs no more
  all-reduces than no remat (the row-parallel sums are saved); "full" and
  "offload" rerun each row-parallel sum once.
- One-process units: GEGLU's half permutation and its inverse, an
  attention computed from each rank's heads, ``global_norm``'s count of
  each element once, SD2.1's misaligned heads kept whole, and ``group=``
  with ``mesh=`` raising.
"""

import json
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from editanything_tpu.checkpoints.convert import tree_to_diffusers
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.parallel import sharding as JS
from editanything_tpu.samplers import make_schedule as jax_schedule
from editanything_tpu.train import controlnet_train as JT
from editanything_tpu_torch.models import blocks as B
from editanything_tpu_torch.parallel import sharding as S
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.train import controlnet_train as T
from editanything_tpu_torch.train import train_controlnet as TC

import mesh_ranks as R
from test_torch_edit_modes import jax_twin
from test_torch_train import _batch, _jax_draws, _port_batch

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
SIGN_FLOOR = 1e-3
SPAWN_TIMEOUT_S = 240
SGD_LR = 2.0 ** 20


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread, and convolutions without oneDNN, whose kernels change
    with the batch (tests/test_torch_parallel.py)."""
    saved = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(saved[0])
    torch.backends.mkldnn.enabled = saved[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _trained_first(out_dir):
    """A run's first-step gradients: Adam's first moment after one step
    (its step-1 checkpoint's) over 0.1, by the optimizer's parameter
    order."""
    ckpt = torch.load(os.path.join(out_dir, "ckpt", "step_1.pt"),
                      weights_only=True)
    names = list(ckpt["params"])
    return {names[i]: s["exp_avg"] / 0.1
            for i, s in ckpt["opt_state"]["state"].items()}


def _trained(state, out_dir):
    """The parameters and EMA of a run, the gradients of its last step
    (left on the module) and of its first, and its metrics."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    return {"params": S.full_state_dict(state.controlnet),
            "ema": S.full_state_dict(state.ema),
            "grads": {k: p.grad.clone() for k, p in
                      state.controlnet.named_parameters()},
            "first": _trained_first(out_dir), "metrics": metrics}


def _jax_mesh_step(tb, draws_key):
    """JAX's loss, grad norm, gradients (diffusers keys, torch layout) and
    their recovery floors for one step on a (2, 2) mesh of the CPU
    devices, the state laid out as JAX's train() lays it out."""
    jb = jax_twin(tb)
    cn_cfg, cn = jb.controlnets["sam"]
    mesh = JS.make_mesh(2, 2, devices=jax.devices()[:4])
    state = JT.init_train_state(cn, optax.sgd(SGD_LR))
    state = state._replace(cn_params=JS.shard_params_tp(
        mesh, state.cn_params, also_fsdp=True))
    batch, key = draws_key
    new, m = jax.jit(JT.make_train_step(cn_cfg, jax_schedule(),
                                        optax.sgd(SGD_LR)))(
        state, JS.replicate(mesh, jb.unet),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    grads = tree_to_diffusers(jax.tree.map(
        lambda a, b: (np.asarray(a) - np.asarray(b)) / SGD_LR, cn,
        new.cn_params))
    eps = float(np.finfo(np.float32).eps)
    floors = {k: eps * (float(np.abs(v).max()) / SGD_LR
                        + float(np.abs(grads[k]).max()))
              for k, v in tree_to_diffusers(cn).items()}
    return float(m["loss"]), float(m["grad_norm"]), grads, floors


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' runs, and in this process meanwhile: JAX's mesh step,
    ``train()`` fresh and resumed from its own step-1 checkpoint; after
    them, ``train()`` resumed from the mesh's step-1 checkpoint."""
    root = str(tmp_path_factory.mktemp("mesh"))
    R.sa1b_folder(os.path.join(root, "sa1b"))
    batch, key = _batch(1), jax.random.PRNGKey(11)
    t, noise = _jax_draws(key, batch["latents"].shape)
    torch.save({"batch": _port_batch(batch), "t": t, "noise": noise},
               os.path.join(root, "draws.pt"))
    one = TC.train(bundle=R.tiny_mesh_bundle(), max_steps=2,
                   export_path=os.path.join(root, "one.safetensors"),
                   **R.train_kwargs(root, os.path.join(root, "one")))
    one_ckpt = os.path.join(root, "one", "ckpt", "step_1.pt")
    for d in ("mesh_resume", "one_resume"):
        R.seed_resume(one_ckpt, os.path.join(root, d))

    ctx = mp.start_processes(R.worker, args=(_free_port(), root),
                             nprocs=R.WORLD, join=False, start_method="spawn")
    try:
        out = {"one": _trained(one, os.path.join(root, "one")),
               "jax": _jax_mesh_step(R.tiny_mesh_bundle(), (batch, key))}
        resumed = TC.train(bundle=R.tiny_mesh_bundle(), max_steps=2,
                           **R.train_kwargs(root, os.path.join(
                               root, "one_resume")))
        out["generate"] = R.generate()
        out["one_resume"] = {
            "params": S.full_state_dict(resumed.controlnet),
            "grads": {k: p.grad.clone() for k, p in
                      resumed.controlnet.named_parameters()}}
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        # join returns False while a rank is still running
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out["ranks"] = [torch.load(os.path.join(root, f"rank{r}.pt"),
                               weights_only=False) for r in range(R.WORLD)]
    R.seed_resume(os.path.join(root, "mesh", "ckpt", "step_1.pt"),
                  os.path.join(root, "from_mesh"))
    from_mesh = TC.train(bundle=R.tiny_mesh_bundle(), max_steps=2,
                         **R.train_kwargs(root, os.path.join(root,
                                                             "from_mesh")))
    out["from_mesh"] = S.full_state_dict(from_mesh.controlnet)
    out["root"] = root
    return out


def _close_to_first_grads(got, want):
    for k, w in want.items():
        scale = float(w.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(got[k], w, rtol=0, atol=GRAD_TOL * scale)


def _params_close(got, want, grads):
    """`got` within 1e-2 of the rate of `want` where every gradient in
    `grads` is sure of its sign; most elements compared."""
    compared = total = 0
    for k, p in want.items():
        sure = torch.ones_like(p, dtype=torch.bool)
        for g in grads:
            sure &= g[k].abs() > SIGN_FLOOR * g[k].abs().max()
        err = float((got[k] - p).abs()[sure].max()) if sure.any() else 0.0
        assert err <= 1e-2 * R.CN_LR, (k, err)
        compared += int(sure.sum())
        total += p.numel()
    assert compared > 0.5 * total


def test_mesh_train_matches_one_process(results):
    one, ranks = results["one"], results["ranks"]
    mesh_dir = os.path.join(results["root"], "mesh")
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for r in ranks[1:]:
        for part in ("params", "ema", "resumed"):
            for k, v in r[part].items():
                assert torch.equal(v, ranks[0][part][k]), (part, k)
    got = ranks[0]
    mesh_first = _trained_first(mesh_dir)
    _close_to_first_grads(mesh_first, one["first"])
    grads = [one["first"], one["grads"]]
    _params_close(got["params"], one["params"], grads)
    _params_close(got["ema"], one["ema"], grads)
    with open(os.path.join(mesh_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    assert [m["step"] for m in metrics] == [1, 2]
    for m, w in zip(metrics, one["metrics"]):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"],
                                   rtol=LOSS_RTOL)
    # the previews ran (on every rank: their forwards gather) and rank 0
    # wrote them; the export is the gathered EMA
    files = os.listdir(os.path.join(mesh_dir, "images"))
    for name in ("input", "hint", "reconstruction", "samples", "samples_ema"):
        assert f"{name}_00000002.png" in files, name
    from editanything_tpu_torch.checkpoints.safetensors_io import load_file
    exported = load_file(os.path.join(results["root"], "mesh.safetensors"))
    assert sorted(exported) == sorted(got["ema"])
    for k, v in got["ema"].items():
        assert torch.equal(exported[k], v), k


def test_mesh_layout_splits_every_kind(results):
    """Each rank holds its slice of every split tensor; both axes split
    some, and the first level's one-head attentions stay whole."""
    ranks = results["ranks"]
    full = ranks[0]["params"]
    split = {"data": 0, "model": 0}
    for k, place in ranks[0]["placements"].items():
        shape = list(full[k].shape)
        if place.axis is not None:
            shape[place.dim] //= 2
            split[place.axis] += 1
        for r in ranks:
            assert r["local_shapes"][k] == tuple(shape), k
    assert split["data"] > 0 and split["model"] > 0, split
    assert ranks[0]["kept_whole"] == [
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1",
        "down_blocks.0.attentions.0.transformer_blocks.0.attn2"]


def test_checkpoints_resume_across_meshes(results):
    """A one-process checkpoint resumed on (2, 2) and a (2, 2) checkpoint
    resumed in one process each train on as a one-process resume does."""
    one, ranks = results["one"], results["ranks"]
    want = results["one_resume"]
    assert ranks[0]["resumed_step"] == 2
    # the resumed step draws its own batch (the batcher is seeded by the
    # step it starts from): its gradients and the first step's decide
    grads = [one["first"], want["grads"]]
    _params_close(ranks[0]["resumed"], want["params"], grads)
    _params_close(results["from_mesh"], want["params"], grads)


def test_mesh_step_matches_jax_in_every_remat_mode(results):
    jl, jn, jg, floors = results["jax"]
    steps = results["ranks"][0]["steps"]
    for remat, s in steps.items():
        np.testing.assert_allclose(s["loss"], jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(s["grad_norm"], jn, rtol=LOSS_RTOL)
        assert sorted(s["grads"]) == sorted(jg)
        for name, want in jg.items():
            scale = float(np.abs(want).max())
            assert scale > 0, name
            err = float(np.abs(s["grads"][name].numpy() - want).max())
            assert err <= GRAD_TOL * scale + floors[name], (remat, name, err)
    for r in results["ranks"]:
        for remat, s in r["steps"].items():
            assert s["all_reduces"] == steps[remat]["all_reduces"]
    plain, rows = steps[False]["all_reduces"], steps[False]["row_layers"]
    assert rows > 0
    assert steps[True]["all_reduces"] == plain
    assert steps["full"]["all_reduces"] == plain + rows
    assert steps["offload"]["all_reduces"] == plain + rows


def test_mesh_request_matches_one_process(results):
    """A txt2img request on the (2, 2) mesh: each data group denoises its
    sample, every rank returns the one-process images."""
    want = results["generate"]
    assert want.shape == (2, 64, 64, 3)
    assert not np.array_equal(want[0], want[1])
    for r in results["ranks"]:
        np.testing.assert_array_equal(r["generate"], want)


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 1), (2, 2)])
def test_layout_matches_jax(mesh_shape, kind):
    """The port's plan against the shardings JAX's shard_params_tp (with
    also_fsdp) or shard_params_fsdp gives the same ControlNet: each
    tensor's split axis marked in an array of its shape (+1, +2, ... along
    "data", -1, -2, ... along "model"), carried to the port's layout by
    JAX's tree_to_diffusers."""
    n_data, n_model = mesh_shape
    tb = R.tiny_mesh_bundle()
    cn = tb.controlnets["sam"][1]
    tree = jax_twin(tb).controlnets["sam"][1]
    mesh = JS.make_mesh(n_data, n_model,
                        devices=jax.devices()[:n_data * n_model])
    tp = kind == "tp"
    laid = (JS.shard_params_tp(mesh, tree, also_fsdp=True) if tp else
            JS.shard_params_fsdp(mesh, tree))

    def marker(x):
        spec = list(x.sharding.spec) + [None] * (x.ndim - len(x.sharding.spec))
        out = np.zeros(x.shape, np.float32)
        for axis, name in enumerate(spec):
            if name is not None:
                shape = [1] * x.ndim
                shape[axis] = x.shape[axis]
                sign = 1.0 if name == "data" else -1.0
                out += sign * np.arange(1, x.shape[axis] + 1,
                                        dtype=np.float32).reshape(shape)
        return out
    marks = tree_to_diffusers(jax.tree.map(marker, laid))
    plan, kept = S.layout_plan(cn, n_data, n_model, tp=tp, fsdp=True)
    assert sorted(plan) == sorted(marks)
    differ, split = [], {"data": 0, "model": 0}
    for name, place in plan.items():
        m = marks[name]
        dims = [d for d in range(m.ndim) if m.shape[d] > 1
                and np.any(np.diff(m, axis=d) != 0)]
        want = (None if not dims else
                ("data" if m.max() > 0 else "model", dims[0]))
        assert len(dims) <= 1, name
        got = None if place.axis is None else (place.axis, place.dim)
        if got is not None:
            split[place.axis] += 1
        if got != want:
            differ.append(name)
            # the only difference: an attention the port keeps whole
            assert want[0] == "model" and got != want
            assert any(name.startswith(layer + ".") for layer in kept), name
    assert split["data"] > 0 and (split["model"] > 0) == tp
    if n_model == 2 and tp:
        assert differ and kept
    else:
        assert not differ and not kept


def test_geglu_halves_round_trip():
    inner, n = 6, 3
    full = torch.arange(2 * inner * 4, dtype=torch.float32).reshape(
        2 * inner, 4)
    place = S.Placement("model", 0, geglu=True)
    parts = [S.shard_of(full, place, i, n) for i in range(n)]
    h, gate = full.chunk(2)
    for i, part in enumerate(parts):
        ph, pg = part.chunk(2)
        assert torch.equal(ph, h[2 * i:2 * i + 2])
        assert torch.equal(pg, gate[2 * i:2 * i + 2])
    assert torch.equal(S.unshard(parts, place), full)
    plain = S.Placement("data", 1)
    cols = [S.shard_of(full, plain, i, 2) for i in range(2)]
    assert torch.equal(S.unshard(cols, plain), full)


def test_attention_from_each_ranks_heads():
    """An attention whose projections hold one rank's heads (its rows of
    to_q/k/v, its columns of to_out, no bias) computes that rank's share:
    the shares sum to the whole attention."""
    torch.manual_seed(0)
    attn = B.Attention(32, 24, heads=4)
    x, ctx = torch.randn(2, 10, 32), torch.randn(2, 7, 24)
    want = attn(x, ctx)
    total = 0
    for i in range(2):
        part = B.Attention(32, 24, heads=4)
        with torch.no_grad():
            for proj in ("to_q", "to_k", "to_v"):
                w = getattr(attn, proj).weight
                setattr(part, proj, torch.nn.Linear(w.shape[1], 16,
                                                    bias=False))
                getattr(part, proj).weight.copy_(w[16 * i:16 * (i + 1)])
            out = torch.nn.Linear(16, 32, bias=False)
            out.weight.copy_(attn.to_out[0].weight[:, 16 * i:16 * (i + 1)])
            part.to_out[0] = out
            total = total + part(x, ctx)
    torch.testing.assert_close(total + attn.to_out[0].bias, want, rtol=0,
                               atol=1e-5)


def test_global_norm_counts_each_element_once():
    """Four simulated ranks of a (2, 2) mesh each square-sum their slices;
    summed over each split tensor's axis group, every rank's total is the
    whole tensors' sum once."""
    torch.manual_seed(1)
    fulls = [torch.randn(8, 4), torch.randn(6, 4), torch.randn(4, 4),
             torch.randn(5)]
    places = [S.Placement("data", 0), S.Placement("model", 0, geglu=True),
              S.Placement("model", 1), S.REPLICATED]
    sizes = {"data": 2, "model": 2}
    want = sum(float(f.square().sum()) for f in fulls)
    local = {}
    for d in range(2):
        for m in range(2):
            index = {"data": d, "model": m}
            values = [float(S.shard_of(f, p, index[p.axis], 2).square().sum())
                      if p.axis else float(f.square().sum())
                      for f, p in zip(fulls, places)]
            local[d, m] = S.sums_by_axis(places, values, sizes)
    for d in range(2):
        for m in range(2):
            total = local[d, m][None]
            total += sum(local[e, m]["data"] for e in range(2))
            total += sum(local[d, e]["model"] for e in range(2))
            assert total == pytest.approx(want, rel=1e-6)
    # on an axis of size 1 nothing is split: summed once, whole
    sums = S.sums_by_axis(places, [1.0, 2.0, 3.0, 4.0],
                          {"data": 1, "model": 1})
    assert sums == {None: 10.0}
    whole = T.global_norm(fulls)
    assert float(whole) == pytest.approx(want ** 0.5, rel=1e-6)


def test_misaligned_heads_stay_whole():
    """SD2.1's first level has 5 heads, which do not divide by 2 model
    ranks: a tiny SD2.1 ControlNet with heads (5, 4) keeps the first
    level's attentions whole on 2 model ranks and splits the rest."""
    import dataclasses
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.controlnet import ControlNetModel
    from editanything_tpu_torch.pipelines.bundle import _empty
    tb = random_bundle(tiny=True, device="cpu", family="sd21",
                       controlnet_names=())
    ucfg = dataclasses.replace(tb.unet_cfg, block_out_channels=(40, 64),
                               attention_head_dim=(5, 4), norm_num_groups=8)
    cn = _empty(ControlNetModel, C.ControlNetConfig(unet=ucfg), "cpu",
                torch.float32)
    plan, kept = S.layout_plan(cn, 1, 2)
    assert kept == ["down_blocks.0.attentions.0.transformer_blocks.0.attn1",
                    "down_blocks.0.attentions.0.transformer_blocks.0.attn2"]
    for name, place in plan.items():
        if any(name.startswith(layer + ".") for layer in kept):
            assert place == S.REPLICATED, name
    assert plan["mid_block.attentions.0.transformer_blocks.0.attn1.to_q."
                "weight"] == S.Placement("model", 0)
    # the first level's feed-forward still splits: its GEGLU width divides
    assert plan["down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0."
                "proj.weight"] == S.Placement("model", 0, geglu=True)


def test_group_and_mesh_together_raise(tmp_path):
    tb = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",))
    R.sa1b_folder(str(tmp_path / "sa1b"))
    kw = R.train_kwargs(str(tmp_path), str(tmp_path / "run"))
    with pytest.raises(ValueError, match="not both"):
        TC.train(bundle=tb, max_steps=1, group=object(), mesh=object(), **kw)
    with pytest.raises(ValueError, match="not both"):
        GenerationPipeline(tb, group=object(), mesh=object())
    with pytest.raises(RuntimeError, match="initialised"):
        S.make_mesh(1, 1)
