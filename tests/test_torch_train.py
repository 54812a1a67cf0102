"""The port's ControlNet training against the JAX package's.

One step of ``make_train_step`` at the tiny SD1.5 config in fp32 from the
same weights (the port's ``random_bundle``, every conv drawn, the zero
convs and the hint stack's last conv included, as a trained checkpoint's
are; carried to JAX by its ``state_dict_to_tree``) and the same draws (JAX
splits the step's key into t and the noise; the test computes them and
hands them to the port): the loss, the grad norm and every gradient (JAX's
out of its train step with SGD: params before minus after, over the rate),
for the eps and the v target; two Adam steps with the EMA;
the preprocessor and the DDIM sample program at 2 steps; ``train()`` end to
end (metrics, grids, checkpoint, resume, export keys against JAX's
``tree_to_diffusers``); the autograd Functions of kernels B, A and E (their
launch replaced by the twin here, where no kernel runs) and the packed conv
weights' repack after an optimizer step.

The JAX side runs through its plain references (its Pallas kernels off, as
in tests/test_torch_edit_modes.py). Tolerances: the loss 1e-5 relative;
each gradient tensor 2e-5 of its largest magnitude (fp32 sums over two
deep stacks in other orders), plus the rounding of JAX's recovered
gradient (``SGD_LR``); Adam's parameters after two steps 1e-2 of
the learning rate, at the elements whose JAX gradient exceeds 1e-3 of the
tensor's largest (Adam's first update is lr * sign(g), and where g is
rounding noise the sign is too); the EMA the same; the sample images and
latents 1e-4.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from editanything_tpu.checkpoints.convert import tree_to_diffusers
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import clip_text as JCT
from editanything_tpu.models import vae as JV
from editanything_tpu.samplers import make_schedule as jax_schedule
from editanything_tpu.train import controlnet_train as JT
from editanything_tpu.train import train_controlnet as JTC
from editanything_tpu_torch.core import flash_attention as FA
from editanything_tpu_torch.core import kernels as K
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.samplers.schedule import make_schedule
from editanything_tpu_torch.train import controlnet_train as T
from editanything_tpu_torch.train import train_controlnet as TC

from test_torch_edit_modes import jax_twin

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
ADAM_LR = 1e-3
ADAM_TOL = 1e-2 * ADAM_LR
SIGN_FLOOR = 1e-3
SAMPLE_TOL = 1e-4


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


@pytest.fixture(scope="module")
def bundles():
    tb = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",),
                       generator=torch.Generator().manual_seed(3))
    tb.unet.requires_grad_(False)
    return tb, jax_twin(tb)


def _nchw(x):
    return torch.from_numpy(np.array(x).transpose(0, 3, 1, 2).copy())


def _batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((b, 8, 8, 4), np.float32),
            "hint": rng.uniform(0, 1, (b, 64, 64, 3)).astype(np.float32),
            "context": rng.standard_normal((b, 8, 32), np.float32)}


def _port_batch(batch):
    return {"latents": _nchw(batch["latents"]), "hint": _nchw(batch["hint"]),
            "context": torch.from_numpy(batch["context"])}


def _jax_draws(key, shape):
    """JAX's t and noise for a step's key (controlnet_train.py:110-113)."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(k_n, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), _nchw(noise)


# JAX's gradients come out of its train step through SGD at this rate: a
# power of two, so that (params - (params - SGD_LR g)) / SGD_LR rounds only
# where params - SGD_LR g does, at an fp32 ulp of max(|params|, SGD_LR |g|)
SGD_LR = 2.0 ** 20


@functools.lru_cache(maxsize=None)
def _jax_sgd_program(cn_cfg, prediction_type):
    return jax.jit(JT.make_train_step(cn_cfg, jax_schedule(),
                                      optax.sgd(SGD_LR),
                                      prediction_type=prediction_type))


def _jax_grads(jb, params, batch, key, prediction_type=None):
    """JAX's loss, grad norm and gradients (a tree) at `params`."""
    cn_cfg = jb.controlnets["sam"][0]
    state = JT.init_train_state(params, optax.sgd(SGD_LR))
    new, m = _jax_sgd_program(cn_cfg, prediction_type)(
        state, jb.unet, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    grads = jax.tree.map(
        lambda a, b: (np.asarray(a) - np.asarray(b)) / SGD_LR, params,
        new.cn_params)
    return float(m["loss"]), float(m["grad_norm"]), grads


def _jax_sgd_step(jb, batch, key, prediction_type=None):
    """JAX's loss, grad norm and gradients (diffusers keys, torch layout),
    and each gradient's floor: the rounding of its recovery."""
    cn = jb.controlnets["sam"][1]
    loss, norm, grads = _jax_grads(jb, cn, batch, key, prediction_type)
    eps = float(np.finfo(np.float32).eps)
    grads = tree_to_diffusers(grads)
    floors = {k: eps * (float(np.abs(v).max()) / SGD_LR
                        + float(np.abs(grads[k]).max()))
              for k, v in tree_to_diffusers(cn).items()}
    return loss, norm, grads, floors


def _port_sgd_step(tb, batch, key, prediction_type=None):
    cn = tb.controlnets["sam"][1]
    state = T.init_train_state(cn, lambda p: torch.optim.SGD(p, lr=1.0))
    step = T.make_train_step(make_schedule(),
                             prediction_type=prediction_type)
    t, noise = _jax_draws(key, batch["latents"].shape)
    _, m = step(state, tb.unet, _port_batch(batch), t=t, noise=noise)
    grads = {k: p.grad.numpy() for k, p in state.controlnet.named_parameters()}
    return float(m["loss"]), float(m["grad_norm"]), grads


@pytest.mark.parametrize("prediction_type", [None, "v_prediction"])
def test_step_gradients_match_jax(bundles, prediction_type):
    tb, jb = bundles
    batch, key = _batch(1), jax.random.PRNGKey(11)
    jl, jn, jg, floors = _jax_sgd_step(jb, batch, key, prediction_type)
    tl, tn, tg = _port_sgd_step(tb, batch, key, prediction_type)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tn, jn, rtol=LOSS_RTOL)
    assert sorted(tg) == sorted(jg)
    for name, want in jg.items():
        scale = float(np.abs(want).max())
        # every ControlNet tensor gets a gradient: the zero convs are drawn
        assert scale > 0, name
        err = float(np.abs(tg[name] - want).max())
        assert err <= GRAD_TOL * scale + floors[name], (name, err, scale)


def _jax_ema(ema, params, step):
    """JAX's LitEma update, as its train_step writes it
    (controlnet_train.py:133-137)."""
    decay = jnp.minimum(0.9999, (1.0 + step) / (10.0 + step))
    return jax.tree.map(lambda e, p: e * decay + (1.0 - decay) * p, ema,
                        params)


def test_adam_steps_and_ema_match_jax(bundles):
    """Two Adam steps with the EMA. JAX's side is its train_step's update
    (``optax.adam`` then the LitEma formula) applied to the gradients of its
    compiled step at each step's parameters."""
    tb, jb = bundles
    params = jb.controlnets["sam"][1]
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    batches = [_batch(2), _batch(3)]
    opt = optax.adam(ADAM_LR)

    @jax.jit
    def update(g, opt_state, params, ema, step):
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, _jax_ema(ema, params, step)

    opt_state, ema, grads = opt.init(params), params, []
    for i, (b, k) in enumerate(zip(batches, keys)):
        g = _jax_grads(jb, params, b, k)[2]
        grads.append(tree_to_diffusers(g))
        # host arrays, as the first step's, so the compiled step is reused
        params, opt_state, ema = jax.device_get(
            update(g, opt_state, params, ema, jnp.int32(i)))
    want_p, want_e = tree_to_diffusers(params), tree_to_diffusers(ema)

    tcn = tb.controlnets["sam"][1]
    tstate = T.init_train_state(tcn, T.make_optimizer(ADAM_LR), use_ema=True)
    tstep = T.make_train_step(make_schedule())
    for b, k in zip(batches, keys):
        t, noise = _jax_draws(k, b["latents"].shape)
        tstep(tstate, tb.unet, _port_batch(b), t=t, noise=noise)
    assert tstate.step == 2
    got_p = {k: v.detach().numpy() for k, v in
             tstate.controlnet.named_parameters()}
    got_e = {k: v.numpy() for k, v in tstate.ema.named_parameters()}
    compared = 0
    for name in want_p:
        sure = np.ones(want_p[name].shape, bool)
        for g in grads:
            sure &= np.abs(g[name]) > SIGN_FLOOR * np.abs(g[name]).max()
        compared += int(sure.sum())
        for got, want in ((got_p, want_p), (got_e, want_e)):
            err = np.abs(got[name] - want[name])[sure]
            assert err.max(initial=0) <= ADAM_TOL, (name, err.max())
    assert compared > 0.5 * sum(v.size for v in want_p.values())
    # the caller's ControlNet is not trained in place
    for name, p in tcn.named_parameters():
        assert not torch.equal(p, tstate.controlnet.get_parameter(name)), name


def test_preprocessor_and_sample_program_match_jax(bundles):
    tb, jb = bundles
    rng = np.random.default_rng(4)
    jpg = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ids = np.asarray(jb.tokenizer(["a photo of a cat", "a dog"], pad_to=8,
                                  truncate=True))
    jl = JV.encode_to_latents(jb.vae, jb.vae_cfg, jnp.asarray(jpg))
    jc = JCT.apply(jb.text, jb.text_cfg, jnp.asarray(ids))
    np.testing.assert_array_equal(
        tb.tokenizer(["a photo of a cat", "a dog"], pad_to=8, truncate=True),
        ids)
    tl, tc = TC.make_preprocessor()(tb.vae, tb.text, _nchw(jpg),
                                    torch.from_numpy(ids).long())
    assert not tl.requires_grad and not tc.requires_grad
    np.testing.assert_allclose(tl.permute(0, 2, 3, 1).numpy(), np.asarray(jl),
                               atol=SAMPLE_TOL, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=SAMPLE_TOL,
                               rtol=0)

    cn_cfg, cn = jb.controlnets["sam"]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), jl.shape))
    hint = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ctx = {"cond": jc, "uncond": jnp.flip(jc, 0)}
    want = JTC.make_sample_program(jb.unet_cfg, cn_cfg, jb.vae_cfg,
                                   jax_schedule(), num_steps=2)(
        jb.unet, cn, jb.vae, jnp.asarray(noise), ctx, jnp.asarray(hint))
    tcfg, tcn = tb.controlnets["sam"]
    got = TC.make_sample_program(tb.unet_cfg, tcfg, make_schedule(),
                                 num_steps=2)(
        tb.unet, tcn, tb.vae, _nchw(noise),
        {"cond": tc, "uncond": tc.flip(0)}, _nchw(hint))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=SAMPLE_TOL, rtol=0)


def _sa1b_folder(d, n=4):
    """An SA-1B-layout folder: PNG targets, annotation JSONs with RLE masks,
    data.txt of dict literals (as tests/test_train_loop.py writes it)."""
    from editanything_tpu_torch.ops import rle
    from editanything_tpu_torch.utils.image import write_png
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        write_png(str(d / f"im{i}.png"),
                  rng.randint(0, 255, (80, 96, 3)).astype(np.uint8))
        masks = []
        for _ in range(3):
            m = np.zeros((80, 96), np.uint8)
            y, x = rng.randint(0, 60), rng.randint(0, 70)
            m[y:y + 20, x:x + 20] = 1
            masks.append({"segmentation": rle.encode(m)})
        (d / f"im{i}.json").write_text(json.dumps(
            {"image": {"height": 80, "width": 96}, "annotations": masks}))
        lines.append(repr({"target": f"im{i}.png", "source": f"im{i}.json",
                           "prompt": f"a photo of a cat {i}"}))
    (d / "data.txt").write_text("\n".join(lines) + "\n")
    return d


def test_train_end_to_end_resume_and_export(bundles, tmp_path):
    from editanything_tpu_torch.checkpoints.safetensors_io import load_file
    tb, jb = bundles
    data = _sa1b_folder(tmp_path)
    out = str(tmp_path / "run")
    kw = dict(data_path=str(data), txt_path=str(data / "data.txt"),
              out_dir=out, bundle=tb, batch_size=2, resolution=64,
              log_every=1, device="cpu")
    before = {k: v.clone() for k, v in tb.unet.state_dict().items()}
    state = TC.train(max_steps=3, image_every=2, ckpt_every=2, sample_steps=2,
                     export_path=str(tmp_path / "cn.safetensors"), **kw)
    assert state.step == 3
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in recs)
    files = os.listdir(os.path.join(out, "images"))
    for name in ("input", "hint", "reconstruction", "samples", "samples_ema"):
        assert f"{name}_00000002.png" in files, (name, files)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["step_2.pt",
                                                             "step_3.pt"]
    assert all(torch.equal(v, before[k])
               for k, v in tb.unet.state_dict().items())
    exported = load_file(str(tmp_path / "cn.safetensors"))
    want_keys = tree_to_diffusers(jb.controlnets["sam"][1])
    assert sorted(exported) == sorted(want_keys)
    for k, v in state.ema.state_dict().items():
        assert torch.equal(exported[k], v), k
    assert any(not torch.equal(a, b) for a, b in zip(
        state.ema.parameters(), state.controlnet.parameters()))

    resumed = TC.train(max_steps=4, image_every=100, ckpt_every=100, **kw)
    assert resumed.step == 4
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "step_2.pt", "step_3.pt", "step_4.pt"]


@pytest.mark.parametrize("remat", [False, "full", "dots", "offload"])
def test_remat_modes_give_the_same_gradients(bundles, remat):
    tb, _ = bundles
    batch, key = _batch(6), jax.random.PRNGKey(2)
    cn = tb.controlnets["sam"][1]
    t, noise = _jax_draws(key, batch["latents"].shape)
    grads = []
    for mode in (False, remat):
        state = T.init_train_state(cn, lambda p: torch.optim.SGD(p, lr=1.0))
        T.make_train_step(make_schedule(), remat=mode)(
            state, tb.unet, _port_batch(batch), t=t, noise=noise)
        grads.append([p.grad for p in state.controlnet.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6 * float(a.abs().max()),
                                   rtol=0)


def test_remat_offload_keeps_the_no_batch_matmuls_and_reruns_the_rest():
    """"offload" as JAX's offload_dot_with_no_batch_dims: against no remat,
    the backward reruns the forward's other ops (a batched matmul, a conv,
    an activation) but no mm/addmm, whose outputs come back from the host;
    "full" reruns them all. The gradients are the same."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(8, 8, generator=g), torch.randn(8, 8, generator=g)
    conv = torch.randn(3, 3, 3, 3, generator=g)

    def fn(x):
        y = torch.nn.functional.linear(torch.tanh(x @ w1), w2, w2[0])
        y = torch.nn.functional.conv2d(y.reshape(2, 3, 4, 8)[..., :4], conv)
        return torch.bmm(y.reshape(2, 3, 4), y.reshape(2, 4, 3)).sin()

    counts, grads = {}, {}
    for mode in (False, "full", "offload"):
        x = torch.randn(6, 4, 8, generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        with Count() as c:
            T.rematerialize(fn, mode)(x).sum().backward()
        counts[mode], grads[mode] = c.n, x.grad
    ops = (aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.convolution.default, aten.tanh.default)
    none, full, off = ([counts[m].get(op, 0) for op in ops]
                       for m in (False, "full", "offload"))
    assert all(n > 0 for n in none)
    assert off[:2] == none[:2]          # no matmul without a batch axis rerun
    assert off[2:] == [n + 1 for n in none[2:]] == full[2:]
    assert full[:2] == [n + 1 for n in none[:2]]
    for mode in ("full", "offload"):
        torch.testing.assert_close(grads[mode], grads[False], atol=0, rtol=0)


# --- the kernels' autograd Functions -----------------------------------------

@pytest.fixture()
def twins_as_kernels(monkeypatch):
    """The Functions' launches replaced by the twins (no kernel runs here),
    counting as the wrappers do."""
    def flash(q, k, v, scale):
        FA.flash_attention.launches += 1
        return FA.flash_attention_reference(q, k, v, scale=scale)

    def gn(x, w, b, num_groups, eps, silu):
        K.group_norm_silu.launches += 1
        return K.group_norm_silu_reference(x, w, b, num_groups=num_groups,
                                           eps=eps, apply_silu=silu)

    def resnet(x, args, num_groups, eps):
        K.resnet_fused.launches += 1
        return K.resnet_fused_reference(x, *args, num_groups=num_groups,
                                        eps=eps)
    monkeypatch.setattr(FA, "_launch", flash)
    monkeypatch.setattr(K, "_gn_launch", gn)
    monkeypatch.setattr(K, "_resnet_forward", resnet)


def _grads(fn, inputs):
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in inputs]
    out = fn(*leaves)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    wrt = [t for t in leaves if t is not None]
    return out.detach(), torch.autograd.grad(out, wrt, g)


def _resnet_inputs(g, trow=True, shortcut=True):
    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g) * s
    cin, cout = 8, 16 if shortcut else 8
    return [r(2, cin, 5, 6), 1 + r(cin, s=0.1), r(cin, s=0.1),
            r(cout, cin, 3, 3, s=0.2), r(cout, s=0.1),
            r(2, cout) if trow else None, 1 + r(cout, s=0.1), r(cout, s=0.1),
            r(cout, cout, 3, 3, s=0.2), r(cout, s=0.1),
            r(cout, cin, 1, 1, s=0.3) if shortcut else None,
            r(cout, s=0.1) if shortcut else None]


@pytest.mark.parametrize("kind", ["flash", "flash_deep_qk", "gn", "gn_no_silu",
                                  "resnet", "resnet_identity"])
def test_functions_backward_through_the_twins(twins_as_kernels, kind):
    """Each kernel's launch through ``TwinVJP``: its gradients equal the
    twin's own autograd, and under checkpointing its forward runs (and
    counts) once more."""
    g = torch.Generator().manual_seed(0)
    if kind.startswith("flash"):
        dqk = 24 if kind == "flash_deep_qk" else 16
        inputs = [torch.randn(2, 3, 7, dqk, generator=g),
                  torch.randn(2, 3, 5, dqk, generator=g),
                  torch.randn(2, 3, 5, 16, generator=g)]
        twin = lambda q, k, v: FA.flash_attention_reference(q, k, v, scale=0.3)
        fn = lambda q, k, v: K.twin_vjp(lambda *a: FA._launch(*a, 0.3),
                                        twin, q, k, v)
        counter = FA.flash_attention
    elif kind.startswith("gn"):
        silu = kind == "gn"
        inputs = [torch.randn(2, 8, 5, 6, generator=g) * 2 + 1,
                  1 + 0.1 * torch.randn(8, generator=g),
                  0.1 * torch.randn(8, generator=g)]
        twin = lambda x, w, b: K.group_norm_silu_reference(
            x, w, b, num_groups=4, eps=1e-5, apply_silu=silu)
        fn = lambda x, w, b: K.twin_vjp(
            lambda *a: K._gn_launch(*a, 4, 1e-5, silu), twin, x, w, b)
        counter = K.group_norm_silu
    else:
        inputs = _resnet_inputs(g, shortcut=kind == "resnet",
                                trow=kind == "resnet")
        present = [i for i, t in enumerate(inputs) if t is not None]

        def spread(*ts):
            full = [None] * 12
            for i, t in zip(present, ts):
                full[i] = t
            return full
        twin = lambda *ts: K.resnet_fused_reference(*spread(*ts), num_groups=4,
                                                    eps=1e-5)
        fn = lambda *ts: K.twin_vjp(
            lambda x, *a: K._resnet_forward(x, a, 4, 1e-5),
            functools.partial(K.resnet_fused_reference, num_groups=4,
                              eps=1e-5), *spread(*ts))
        inputs = [inputs[i] for i in present]
        counter = K.resnet_fused
    got_out, got = _grads(fn, inputs)
    want_out, want = _grads(twin, inputs)
    torch.testing.assert_close(got_out, want_out, atol=0, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    counter.launches = 0
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = torch.utils.checkpoint.checkpoint(fn, *leaves, use_reentrant=False)
    out.sum().backward()
    assert counter.launches == 2


def test_packed_conv_weight_repacks_after_an_optimizer_step():
    conv = torch.nn.Conv2d(8, 16, 3)
    first = K.packed_conv_weight(conv.weight, 8)
    assert K.packed_conv_weight(conv.weight, 8) is first
    conv.weight.grad = torch.ones_like(conv.weight)
    torch.optim.SGD(conv.parameters(), lr=0.5).step()
    second = K.packed_conv_weight(conv.weight, 8)
    assert second is not first
    torch.testing.assert_close(second, K.pack_conv_weight(conv.weight, 8),
                               atol=0, rtol=0)
    torch.testing.assert_close(second, first - 0.5, atol=1e-6, rtol=0)


def test_checkpoint_manager_retention_and_params(tmp_path):
    """The JAX manager's interface (tests/test_train_loop.py's round trip)
    over torch files: the interval, retention, the latest step, a dict
    state, and one-shot parameter files."""
    from editanything_tpu_torch.train.checkpointing import (
        CheckpointManager, load_params, save_params)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2,
                            save_interval_steps=5)
    assert mgr.latest_step() is None and mgr.restore({}) is None
    assert not mgr.maybe_save(3, {"w": torch.arange(8.0)})
    for step in (5, 10, 15):
        assert mgr.maybe_save(step, {"w": torch.arange(8.0) + step,
                                     "step": step})
    assert mgr.all_steps() == [10, 15] and mgr.latest_step() == 15
    got = mgr.restore({})
    assert got["step"] == 15 and torch.equal(got["w"], torch.arange(8.0) + 15)
    assert mgr.restore({}, step=10)["step"] == 10
    mgr.close()
    conv = torch.nn.Conv2d(3, 4, 3)
    save_params(str(tmp_path / "p.pt"), conv)
    other = torch.nn.Conv2d(3, 4, 3)
    load_params(str(tmp_path / "p.pt"), other)
    assert all(torch.equal(a, b) for a, b in zip(conv.parameters(),
                                                 other.parameters()))
    assert sorted(load_params(str(tmp_path / "p.pt"), None)) == ["bias",
                                                                  "weight"]


def test_loggers_and_profiler(tmp_path):
    from editanything_tpu_torch.train.logging import (ImageLogger,
                                                      MetricLogger,
                                                      is_main_process)
    from editanything_tpu_torch.utils.image import read_image
    assert is_main_process()
    log = MetricLogger(str(tmp_path), every=2)
    for step in (1, 2, 3, 4):
        log.log(step, {"loss": torch.tensor(0.5 * step), "note": None})
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [(r["step"], r["loss"], r["note"]) for r in recs] == [
        (2, 1.0, "None"), (4, 2.0, "None")]
    images = ImageLogger(str(tmp_path), every=3, max_images=2)
    batch = np.linspace(-1, 1, 3 * 4 * 5 * 3).reshape(3, 4, 5, 3)
    assert not images.maybe_log(2, {"x": batch})
    assert images.maybe_log(3, {"x": batch})
    strip = read_image(str(tmp_path / "images" / "x_00000003.png"))
    assert strip.shape == (4, 10, 3)
    want = (np.clip((batch[:2] + 1) / 2, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(strip, np.concatenate(list(want), axis=1))
