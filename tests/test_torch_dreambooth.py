"""The port's DreamBooth-inpaint training against the JAX package's.

A tiny SD1.5 bundle with the 9-channel inpaint UNet, drawn by the port's
``random_bundle(family="sd15_inpaint")`` and carried to JAX by
tests/test_torch_edit_modes.py's ``jax_twin``, so both sides hold the same
weights. Every draw is JAX's, handed to the port: a step's t and noise
(its key split as dreambooth_inpaint.py:71-73 splits it), the class
images' initial latents (train_dreambooth.py:91-92). JAX's gradients come
out of its step run with ``optax.sgd(SGD_LR)`` (tests/test_torch_train.py
explains the recovery and its rounding floor).

Held: ``random_mask`` and ``DreamBoothBatcher`` equal; the preprocessor's
latents within 1e-5 and its latent mask equal (JAX's nearest rule takes
source pixel 8i + 4); one full and one LoRA step, with and without prior
preservation, the loss within 1e-5 relative and each gradient tensor
within 2e-5 of its largest; AdamW with a warm-up, two steps, within 1e-2
of the rate where the gradients' signs are sure; the class images within
2 uint8 levels; and the port's own ``train()`` end to end with a resume,
with the cases of JAX's tests/test_train_extras.py:79-130 and
tests/test_train_programs.py:92-149. JAX runs its plain references.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from editanything_tpu.checkpoints.convert import tree_to_diffusers
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import vae as JV
from editanything_tpu.samplers import make_schedule as jax_schedule
from editanything_tpu.train import dreambooth_inpaint as JDB
from editanything_tpu.train import train_dreambooth as JTD
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.samplers.schedule import make_schedule
from editanything_tpu_torch.train import dreambooth_inpaint as DB
from editanything_tpu_torch.train import train_dreambooth as TD
from editanything_tpu_torch.utils.image import write_png

from test_torch_edit_modes import jax_twin
from test_torch_train import SGD_LR, _jax_draws, _nchw

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
LATENT_TOL = 1e-5
ADAM_LR = 1e-3
ADAM_TOL = 1e-2 * ADAM_LR
SIGN_FLOOR = 1e-3
IMAGE_LEVELS = 2
RANK = 2


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inpaint_bundle(seed=3):
    return random_bundle(tiny=True, device="cpu", family="sd15_inpaint",
                         controlnet_names=(),
                         generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def bundles():
    tb = _inpaint_bundle()
    return tb, jax_twin(tb)


def _write_images(directory, n=2, size=48, seed=0):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        write_png(os.path.join(directory, f"img_{i}.png"),
                  rng.randint(0, 255, (size, size, 3)).astype(np.uint8))


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(b, 8, 8, 1)) > 0.5).astype(np.float32)
    return {"latents": rng.standard_normal((b, 8, 8, 4), np.float32),
            "mask": mask,
            "masked_latents": rng.standard_normal((b, 8, 8, 4), np.float32),
            "context": rng.standard_normal((b, 8, 32), np.float32)}


def _port_batch(batch):
    return {"latents": _nchw(batch["latents"]), "mask": _nchw(batch["mask"]),
            "masked_latents": _nchw(batch["masked_latents"]),
            "context": torch.from_numpy(batch["context"])}


def _random_deltas(tb, seed=9):
    """Deltas with every up nonzero, so each down gets a gradient; JAX's
    layout, as numpy."""
    g = torch.Generator().manual_seed(seed)
    deltas = DB.init_lora_deltas(tb.unet, rank=RANK, generator=g)
    return {p: {"down": d["down"].numpy(),
                "up": (0.05 * torch.randn(d["up"].shape, generator=g)).numpy()}
            for p, d in deltas.items()}


# --- the host pieces ---------------------------------------------------------

def test_random_mask_matches_jax_and_its_bounds():
    for seed in range(4):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        for hw, full in (((32, 24), False), ((17, 40), False), ((16, 16), True)):
            want = JDB.random_mask(a, hw, mask_full_image=full)
            got = DB.random_mask(b, hw, mask_full_image=full)
            np.testing.assert_array_equal(got, want)
            assert got.shape == hw and set(np.unique(got)) <= {0.0, 1.0}
    assert DB.random_mask(np.random.RandomState(0), (16, 16),
                          mask_full_image=True).mean() > 0.9


def test_batcher_matches_jax(tmp_path):
    _write_images(str(tmp_path / "inst"), n=3, size=40, seed=1)
    _write_images(str(tmp_path / "cls"), n=2, size=56, seed=2)
    kw = dict(class_dir=str(tmp_path / "cls"), resolution=32, seed=4)
    want = JTD.DreamBoothBatcher(str(tmp_path / "inst"), **kw)
    got = TD.DreamBoothBatcher(str(tmp_path / "inst"), **kw)
    for _ in range(3):
        for w, g in zip(want.next(2), got.next(2)):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_preprocessor_matches_jax(bundles):
    tb, jb = bundles
    rng = np.random.default_rng(6)
    imgs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    masks = np.stack([JDB.random_mask(np.random.RandomState(i), (64, 64))
                      for i in range(2)])[..., None]
    masks[1, 3::8, :] = 1.0      # rows only JAX's 8i + 4 rule skips
    masked = imgs * (masks < 0.5)
    lat = JV.encode_to_latents(jb.vae, jb.vae_cfg, jnp.asarray(imgs))
    mlat = JV.encode_to_latents(jb.vae, jb.vae_cfg, jnp.asarray(masked))
    m = jax.image.resize(jnp.asarray(masks), (2, 8, 8, 1), method="nearest")
    got = TD.make_preprocessor()(tb.vae, _nchw(imgs), _nchw(masks),
                                 _nchw(masked))
    assert not any(x.requires_grad for x in got)
    for g, w in zip(got, (lat, m, mlat)):
        assert g.dtype == torch.float32
        g = g.permute(0, 2, 3, 1).numpy()
        if w is m:
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_allclose(g, np.asarray(w), atol=LATENT_TOL,
                                       rtol=0)
    # the rule differs from torch's plain "nearest" on this mask
    plain = torch.nn.functional.interpolate(_nchw(masks), size=(8, 8))
    assert not torch.equal(plain, got[1])


# --- the steps ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_sgd_step(ucfg, plw, lora):
    make = JDB.make_db_lora_train_step if lora else JDB.make_db_train_step
    return jax.jit(make(ucfg, jax_schedule(), optax.sgd(SGD_LR),
                        prior_loss_weight=plw))


def _floors(params, grads):
    eps = float(np.finfo(np.float32).eps)
    return {k: eps * (float(np.abs(v).max()) / SGD_LR
                      + float(np.abs(grads[k]).max()))
            for k, v in params.items()}


def _jax_full_grads(jb, params, batch, key, plw):
    state = JDB.DBState(params, optax.sgd(SGD_LR).init(params),
                        jnp.asarray(0))
    new, m = _jax_sgd_step(jb.unet_cfg, plw, False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                         / SGD_LR, params, new.unet_params)
    return float(m["loss"]), tree_to_diffusers(grads)


def _flat(deltas):
    return {f"{p}/{k}": np.asarray(v) for p, d in deltas.items()
            for k, v in d.items()}


def _jax_lora_grads(jb, deltas, batch, key, plw):
    deltas = jax.tree.map(jnp.asarray, deltas)
    carry = (deltas, optax.sgd(SGD_LR).init(deltas), jnp.asarray(0))
    new, m = _jax_sgd_step(jb.unet_cfg, plw, True)(
        carry, jb.unet, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                         / SGD_LR, deltas, new[0])
    return float(m["loss"]), _flat(grads)


def _assert_grads(got, want, floors):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_TOL * scale + floors[name], (name, err, scale)


@pytest.mark.parametrize("plw", [0.0, 1.0])
def test_full_step_gradients_match_jax(bundles, plw):
    tb, jb = bundles
    batch, key = _batch(1), jax.random.PRNGKey(11)
    jl, jg = _jax_full_grads(jb, jb.unet, batch, key, plw)
    # rate 0: the step's update leaves the weights, its gradients stay
    unet = copy.deepcopy(tb.unet).requires_grad_(True)
    opt = DB.AdamW(0.0)
    state = DB.DBState(unet, opt(unet.parameters()))
    t, noise = _jax_draws(key, batch["latents"].shape)
    _, m = DB.make_db_train_step(tb.unet_cfg, make_schedule(), opt,
                                 prior_loss_weight=plw)(
        state, _port_batch(batch), t=t, noise=noise)
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=LOSS_RTOL)
    assert state.step == 1
    _assert_grads({k: p.grad.numpy() for k, p in unet.named_parameters()}, jg,
                  _floors(tree_to_diffusers(jb.unet), jg))


@pytest.mark.parametrize("plw", [0.0, 1.0])
def test_lora_step_gradients_match_jax(bundles, plw):
    tb, jb = bundles
    deltas = _random_deltas(tb)
    batch, key = _batch(2), jax.random.PRNGKey(12)
    jl, jg = _jax_lora_grads(jb, deltas, batch, key, plw)
    before = {k: v.clone() for k, v in tb.unet.state_dict().items()}
    opt = DB.AdamW(0.0)
    lora = DB.LoRADeltas({p: {k: torch.from_numpy(v) for k, v in d.items()}
                          for p, d in deltas.items()})
    state = DB.LoRAState(lora, opt(lora.parameters()))
    t, noise = _jax_draws(key, batch["latents"].shape)
    _, m = DB.make_db_lora_train_step(tb.unet_cfg, make_schedule(), opt,
                                      prior_loss_weight=plw)(
        state, tb.unet, _port_batch(batch), t=t, noise=noise)
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=LOSS_RTOL)
    _assert_grads({k: p.grad.numpy() for k, p in lora.named_parameters()},
                  jg, _floors(_flat(deltas), jg))
    # only the deltas take gradients; the UNet stays bit-unchanged
    assert all(p.grad is None for p in tb.unet.parameters())
    assert all(torch.equal(v, before[k])
               for k, v in tb.unet.state_dict().items())


def test_lora_deltas_match_jax_layout_and_merge(bundles):
    """The deltas' paths are the JAX tree's (JAX's init walks the same
    projections), shaped (din, r) and (r, dout); the merge adds (down @
    up).T as JAX adds down @ up to its (din, dout) kernel; a zero up
    merges to the UNet itself (tests/test_train_extras.py:99-109)."""
    tb, jb = bundles
    want = JDB.init_lora_deltas(jax.random.PRNGKey(1), jb.unet, rank=RANK)
    got = DB.init_lora_deltas(tb.unet, rank=RANK,
                              generator=torch.Generator().manual_seed(1))
    assert list(got) == list(want) and len(got) == 24
    for p in want:
        for k in ("down", "up"):
            assert tuple(got[p][k].shape) == want[p][k].shape, (p, k)
        assert not got[p]["up"].any()
    merged = DB.apply_lora_deltas(tb.unet, got)
    for name, w in merged.items():
        assert torch.equal(w, tb.unet.get_parameter(name))
    deltas = _random_deltas(tb)
    jm = tree_to_diffusers(JDB.apply_lora_deltas(
        jb.unet, jax.tree.map(jnp.asarray, deltas)))
    tm = DB.apply_lora_deltas(tb.unet, {p: {k: torch.from_numpy(v) for k, v
                                            in d.items()}
                                        for p, d in deltas.items()})
    assert len(tm) == 24
    for name, w in tm.items():
        np.testing.assert_allclose(w.numpy(), jm[name], atol=1e-6, rtol=0)


def test_adamw_with_warmup_matches_jax(bundles):
    """Two full steps under optax.adamw with warmup_constant_schedule(0, lr,
    2): the first at rate 0 (optax's schedule reads the count before its
    increment), the second at lr / 2, decay 1e-2."""
    tb, jb = bundles
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    batches = [_batch(3), _batch(4)]
    sched = optax.warmup_constant_schedule(0.0, ADAM_LR, 2)
    opt = optax.adamw(sched, weight_decay=1e-2)
    step = jax.jit(JDB.make_db_train_step(jb.unet_cfg, jax_schedule(), opt))
    state = JDB.DBState(jb.unet, opt.init(jb.unet), jnp.asarray(0))
    grads = []
    for b, k in zip(batches, keys):
        # rate 0 at the first step: both gradients are taken at the start
        grads.append(_jax_full_grads(jb, jb.unet, b, k, 0.0)[1])
        state, _ = step(state, {n: jnp.asarray(v) for n, v in b.items()}, k)
    want = tree_to_diffusers(jax.device_get(state.unet_params))

    unet = copy.deepcopy(tb.unet).requires_grad_(True)
    topt = DB.AdamW(ADAM_LR, warmup_steps=2)
    tstate = DB.DBState(unet, topt(unet.parameters()))
    tstep = DB.make_db_train_step(tb.unet_cfg, make_schedule(), topt)
    for i, (b, k) in enumerate(zip(batches, keys)):
        t, noise = _jax_draws(k, b["latents"].shape)
        tstep(tstate, _port_batch(b), t=t, noise=noise)
        if i == 0:
            assert all(torch.equal(a, c) for a, c in zip(
                unet.parameters(), tb.unet.parameters()))
    got = {k: v.detach().numpy() for k, v in unet.named_parameters()}
    compared = 0
    for name, w in want.items():
        sure = np.ones(w.shape, bool)
        for g in grads:
            sure &= np.abs(g[name]) > SIGN_FLOOR * np.abs(g[name]).max()
        compared += int(sure.sum())
        err = np.abs(got[name] - w)[sure]
        assert err.max(initial=0) <= ADAM_TOL, (name, err.max())
    assert compared > 0.5 * sum(v.size for v in want.values())
    assert any(not np.array_equal(got[n], tree_to_diffusers(jb.unet)[n])
               for n in got)


def test_adamw_decay_matches_optax():
    """Zero gradients leave only the decoupled decay: under
    warmup_constant_schedule(0, lr, 2) the first update keeps the weights
    and the second takes (lr / 2) 1e-2 p off them, as optax.adamw does, to
    two fp32 spacings; a decay dropped or scaled by 1 % is far outside."""
    lr = 0.1
    p0 = 3 * np.random.default_rng(0).standard_normal((64, 32), np.float32)
    opt = optax.adamw(optax.warmup_constant_schedule(0.0, lr, 2),
                      weight_decay=1e-2)
    params = jnp.asarray(p0)
    st = opt.init(params)
    for _ in range(2):
        upd, st = opt.update(jnp.zeros_like(params), st, params)
        params = optax.apply_updates(params, upd)
    want = np.asarray(params)
    np.testing.assert_allclose(want - p0, -(lr / 2) * 1e-2 * p0, rtol=1e-3,
                               atol=2 * np.spacing(np.abs(p0).max()))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    sched = DB.AdamW(lr, warmup_steps=2)
    topt = sched([p])
    for count in range(2):
        p.grad = torch.zeros_like(p)
        DB._apply_update(topt, sched, count)
        if count == 0:
            assert torch.equal(p.detach(), torch.from_numpy(p0))
    err = np.abs(p.detach().numpy() - want).max()
    assert err <= 2 * np.spacing(np.abs(p0).max()), err
    assert err <= 1e-3 * np.abs(want - p0).max()


# --- the program -------------------------------------------------------------

def _captured_arrays(monkeypatch):
    """The arrays each side hands PIL to save as its class JPEGs."""
    seen = []
    real = Image.fromarray

    def record(arr, *a, **kw):
        seen.append(np.array(arr))
        return real(arr, *a, **kw)
    monkeypatch.setattr(Image, "fromarray", record)
    return seen


def test_class_images_match_jax(bundles, tmp_path, monkeypatch):
    tb, jb = bundles
    seen = _captured_arrays(monkeypatch)
    kw = dict(class_prompt="a photo of a dog", num_class_images=2,
              resolution=32, num_steps=2, batch_size=2, seed=0)
    assert JTD.generate_class_images(jb, class_dir=str(tmp_path / "j"),
                                     **kw) == 2
    want = np.stack(seen)
    seen.clear()
    # JAX's draw of the batch (train_dreambooth.py:91-92)
    _, k = jax.random.split(jax.random.PRNGKey(0))
    noise = np.asarray(jax.random.normal(k, (2, 4, 4, 4), jnp.float32))
    assert TD.generate_class_images(tb, class_dir=str(tmp_path / "t"),
                                    noise=[noise], **kw) == 2
    got = np.stack(seen)
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= IMAGE_LEVELS
    assert sorted(os.listdir(tmp_path / "t")) == ["class_0.jpg",
                                                  "class_1.jpg"]
    # already full: nothing more (tests/test_train_programs.py:92-106)
    assert TD.generate_class_images(tb, class_dir=str(tmp_path / "t"),
                                    **kw) == 0


def test_step_9ch_and_lora_trains_deltas_only():
    """tests/test_train_extras.py:88-130 on the port: a 9-channel step with
    prior halves moves the step; a LoRA step moves the ups."""
    tb = _inpaint_bundle(seed=0)
    batch = _port_batch(_batch(7, b=4))
    unet = copy.deepcopy(tb.unet).requires_grad_(True)
    opt = DB.AdamW(1e-3)
    state = DB.DBState(unet, opt(unet.parameters()))
    state, m = DB.make_db_train_step(tb.unet_cfg, make_schedule(), opt,
                                     prior_loss_weight=1.0)(
        state, batch, generator=torch.Generator().manual_seed(3))
    assert np.isfinite(float(m["loss"])) and state.step == 1
    lora = DB.LoRADeltas(DB.init_lora_deltas(tb.unet, rank=RANK))
    opt = DB.AdamW(1e-2)
    lstate = DB.LoRAState(lora, opt(lora.parameters()))
    lstate, m = DB.make_db_lora_train_step(tb.unet_cfg, make_schedule(), opt)(
        lstate, tb.unet, _port_batch(_batch(8)),
        generator=torch.Generator().manual_seed(4))
    assert np.isfinite(float(m["loss"]))
    assert any(d["up"].abs().max() > 0 for d in lora.tree().values())
    with pytest.raises(ValueError, match="9-channel"):
        DB.make_db_train_step(random_bundle(
            tiny=True, device="cpu", controlnet_names=()).unet_cfg,
            make_schedule(), opt)


def _metrics(d):
    return [json.loads(line) for line in open(os.path.join(d,
                                                           "metrics.jsonl"))]


def test_train_with_prior_preservation_and_resume(tmp_path):
    tb = _inpaint_bundle(seed=0)
    inst, cls, out = (str(tmp_path / n) for n in ("inst", "class", "out"))
    _write_images(inst, n=2)
    before = {k: v.clone() for k, v in tb.unet.state_dict().items()}
    kw = dict(instance_data_dir=inst, instance_prompt="a photo of a cat",
              output_dir=out, bundle=tb, class_data_dir=cls,
              class_prompt="a photo of a dog", with_prior_preservation=True,
              num_class_images=1, class_gen_steps=2, batch_size=1, lr=1e-3,
              resolution=32, ckpt_every=2, log_every=1, device="cpu")
    state = TD.train(max_steps=2, **kw)
    assert state.step == 2 and len(os.listdir(cls)) == 1
    # a copy of the UNet trained; the bundle's own as it was
    assert any(not torch.equal(p, before[k])
               for k, p in state.unet.state_dict().items())
    assert all(torch.equal(v, before[k]) for k, v in tb.unet.state_dict().items())
    saved = torch.load(os.path.join(out, "unet.pt"), weights_only=True)
    assert all(torch.equal(saved[k], v)
               for k, v in state.unet.state_dict().items())
    assert [r["step"] for r in _metrics(out)] == [1, 2]
    resumed = TD.train(max_steps=3, **kw)
    assert resumed.step == 3
    assert [r["step"] for r in _metrics(out)] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in _metrics(out))
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["step_2.pt",
                                                             "step_3.pt"]


def test_train_lora_leaves_the_unet(tmp_path):
    tb = _inpaint_bundle(seed=0)
    inst, out = str(tmp_path / "inst"), str(tmp_path / "out")
    _write_images(inst, n=1)
    before = {k: v.clone() for k, v in tb.unet.state_dict().items()}
    kw = dict(instance_data_dir=inst, instance_prompt="a photo of a cat",
              output_dir=out, bundle=tb, use_lora=True, lora_rank=RANK,
              batch_size=1, lr=1e-2, lr_warmup_steps=1, resolution=32,
              ckpt_every=1, device="cpu")
    state = TD.train(max_steps=2, **kw)
    assert state.step == 2
    assert all(torch.equal(v, before[k]) for k, v in tb.unet.state_dict().items())
    assert any(float(d["up"].detach().abs().max()) > 0
               for d in state.deltas.tree().values())
    saved = torch.load(os.path.join(out, "lora_deltas.pt"), weights_only=True)
    assert sorted(saved) == sorted(f"{p}/{k}" for p in state.deltas.paths
                                   for k in ("down", "up"))
    ckpt = torch.load(os.path.join(out, "ckpt", "step_2.pt"),
                      weights_only=True)
    resumed = TD.train(max_steps=3, **kw)
    assert resumed.step == 3
    # resumed from step 2: its third update moved step 2's deltas
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "step_1.pt", "step_2.pt", "step_3.pt"]
    assert any(not torch.equal(p, ckpt["params"][k])
               for k, p in resumed.deltas.state_dict().items())
    assert all(torch.equal(v, before[k]) for k, v in tb.unet.state_dict().items())


def test_train_bf16_bundle_trains_fp32(tmp_path):
    """A bf16 bundle (a bundle spec's default dtype) at the default rate
    5e-6: the trained UNet copy and the LoRA deltas are fp32, so the
    updates (about the rate per element, far below a bf16 spacing) move
    them; the bundle's UNet stays bf16 and unchanged."""
    tb = random_bundle(tiny=True, device="cpu", family="sd15_inpaint",
                       controlnet_names=(), dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    inst = str(tmp_path / "inst")
    _write_images(inst, n=1)
    before = {k: v.clone() for k, v in tb.unet.state_dict().items()}
    kw = dict(instance_data_dir=inst, instance_prompt="a photo of a cat",
              bundle=tb, batch_size=1, resolution=32, max_steps=1,
              log_every=1, device="cpu")
    full = TD.train(output_dir=str(tmp_path / "full"), **kw)
    params = full.unet.state_dict()
    assert sorted(params) == sorted(before)
    assert all(v.dtype == torch.float32 for v in params.values())
    moved = (sum(int((params[k] != v.float()).sum())
                 for k, v in before.items())
             / sum(v.numel() for v in before.values()))
    assert moved > 0.5, moved
    assert np.isfinite(_metrics(str(tmp_path / "full"))[0]["loss"])
    lora = TD.train(output_dir=str(tmp_path / "lora"), use_lora=True,
                    lora_rank=RANK, **kw)
    tree = lora.deltas.tree()
    assert all(v.dtype == torch.float32 for d in tree.values()
               for v in d.values())
    assert all(float(d["up"].detach().abs().max()) > 0 for d in tree.values())
    assert all(v.dtype == torch.bfloat16 and torch.equal(v, before[k])
               for k, v in tb.unet.state_dict().items())
