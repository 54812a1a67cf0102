"""The port's textual inversion against the JAX package's.

The placeholder rows and prompt ids; one TI step at the tiny SD1.5 config
in fp32 from the same weights (tests/test_torch_edit_modes.py's carry) and
JAX's draws (its step key split into t and the noise): the loss, the
placeholder rows' gradient (JAX's out of its step through SGD, as in
tests/test_torch_train.py) and the rows after one Adam step (JAX's
``optax.adam`` on that gradient), every other row unchanged on both sides;
``train_textual_inversion`` end to end (the embedding file, checkpoint,
resume, the rows left in the bundle); and the editor's flow: the reference
crop staged by ``process(ref_textinv=True)``, ``train_staged_textinv``,
then ``process(ref_textinv=True, ref_textinv_path=...)`` with the learned
file; and the step and ``train_textual_inversion`` on a bf16 bundle, the
step's loss against fp32 on the same weights within 5e-3 relative. The JAX side runs through its plain references. Tolerances: the loss
1e-5 relative, the gradient 2e-5 of its largest magnitude, the Adam rows
1e-2 of the rate where the gradient exceeds 1e-3 of its largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.samplers import make_schedule as jax_schedule
from editanything_tpu.train import textual_inversion as JTI
from editanything_tpu_torch.checkpoints.lora import load_ti_file
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.samplers.schedule import make_schedule
from editanything_tpu_torch.train import textual_inversion as TTI
from editanything_tpu_torch.train.train_ti import train_textual_inversion
from editanything_tpu_torch.utils.image import write_png

from test_torch_edit_modes import jax_twin

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
LR = 1e-3
ADAM_TOL = 1e-2 * LR
SIGN_FLOOR = 1e-3
BF16_LOSS_RTOL = 5e-3     # bf16 UNet and text tower against fp32
SGD_LR = 2.0 ** 20        # see tests/test_torch_train.py
NUM_VECTORS = 3


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


def _bundle(names=()):
    tb = random_bundle(tiny=True, device="cpu", controlnet_names=names,
                       generator=torch.Generator().manual_seed(3))
    return tb


def _nchw(x):
    return torch.from_numpy(np.array(x).transpose(0, 3, 1, 2).copy())


def test_placeholder_rows_and_prompt_ids_match_jax():
    tb = _bundle()
    jb = jax_twin(tb)
    jtext, jids = JTI.add_placeholder_tokens(
        jb.text, jb.tokenizer, num_vectors=NUM_VECTORS,
        initializer_token="cat")
    tids = TTI.add_placeholder_tokens(tb.text, tb.tokenizer,
                                      num_vectors=NUM_VECTORS,
                                      initializer_token="cat")
    assert tids == jids
    np.testing.assert_array_equal(
        tb.text.embeddings.token_embedding.weight.detach().numpy(),
        np.asarray(jtext["embeddings"]["token_embedding"]["weight"]))
    for template in TTI.IMAGENET_TEMPLATES_SMALL[:5] + ["{} of a dog"]:
        assert (TTI.placeholder_prompt_ids(tb.tokenizer, template, tids, 8)
                == JTI.placeholder_prompt_ids(jb.tokenizer, template, jids, 8))
    assert TTI.IMAGENET_TEMPLATES_SMALL == JTI.IMAGENET_TEMPLATES_SMALL


def test_ti_step_matches_jax():
    tb = _bundle()
    jb = jax_twin(tb)
    jtext, pids = JTI.add_placeholder_tokens(
        jb.text, jb.tokenizer, num_vectors=NUM_VECTORS,
        initializer_token="cat")
    TTI.add_placeholder_tokens(tb.text, tb.tokenizer, num_vectors=NUM_VECTORS,
                               initializer_token="cat")
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 8, 8, 4), np.float32)
    ids = np.asarray([
        JTI.placeholder_prompt_ids(jb.tokenizer, t, pids, 8)
        for t in ("a photo of a {}", "the {} of a dog")], np.int32)
    key = jax.random.PRNGKey(9)
    table = jtext["embeddings"]["token_embedding"]["weight"]

    step = jax.jit(JTI.make_ti_train_step(
        jb.text_cfg, jb.unet_cfg, jax_schedule(), optax.sgd(SGD_LR), pids))
    new, m = step(JTI.TIState(table, optax.sgd(SGD_LR).init(table),
                              jnp.int32(0)),
                  jtext, jb.unet, {"latents": jnp.asarray(lat),
                                   "input_ids": jnp.asarray(ids)}, key)
    grad = (np.asarray(table) - np.asarray(new.embeddings)) / SGD_LR
    updates, _ = jax.jit(optax.adam(LR).update)(
        jnp.asarray(grad), optax.adam(LR).init(table), table)
    want_rows = np.asarray(table + updates)

    k_t, k_n = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000)))
    noise = _nchw(jax.random.normal(k_n, lat.shape, jnp.float32))
    tb.text.requires_grad_(False)
    tb.unet.requires_grad_(False)
    tstep = TTI.make_ti_train_step(make_schedule(), pids)
    before = tb.text.embeddings.token_embedding.weight.detach().clone()
    results = {}
    for name, opt in (("sgd", lambda p: torch.optim.SGD(p, lr=1.0)),
                      ("adam", functools.partial(torch.optim.Adam, lr=LR))):
        state = TTI.init_ti_state(tb.text, opt)
        _, tm = tstep(state, tb.text, tb.unet,
                      {"latents": _nchw(lat), "input_ids": ids},
                      t=t, noise=noise)
        assert state.step == 1
        results[name] = (float(tm["loss"]), state)
    loss, sgd = results["sgd"]
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(results["adam"][0], float(m["loss"]),
                               rtol=LOSS_RTOL)
    p0, p1 = min(pids), max(pids) + 1
    tgrad = (before - sgd.embeddings.detach()).numpy()
    scale = np.abs(grad[p0:p1]).max()
    assert scale > 0
    np.testing.assert_allclose(tgrad[p0:p1], grad[p0:p1],
                               atol=GRAD_TOL * scale, rtol=0)
    rows = results["adam"][1].embeddings.detach().numpy()
    for got in (rows, sgd.embeddings.detach().numpy()):
        np.testing.assert_array_equal(got[:p0], before.numpy()[:p0])
    np.testing.assert_array_equal(np.asarray(new.embeddings)[:p0],
                                  np.asarray(table)[:p0])
    sure = np.abs(grad[p0:p1]) > SIGN_FLOOR * scale
    assert sure.mean() > 0.5
    err = np.abs(rows[p0:p1] - want_rows[p0:p1])[sure]
    assert err.max() <= ADAM_TOL
    np.testing.assert_array_equal(
        TTI.learned_embeddings(results["adam"][1], pids).numpy(),
        rows[p0:p1])
    # the live text tower's table was not trained in place
    torch.testing.assert_close(tb.text.embeddings.token_embedding.weight,
                               before, atol=0, rtol=0)


def test_ti_step_on_a_bf16_bundle_matches_fp32():
    """A loaded bundle is bf16: the step runs its UNet in bf16 (the loss in
    fp32) and trains the bf16 table. One step against the same weights in
    fp32: the loss within BF16_LOSS_RTOL, only the placeholder rows move,
    the table stays bf16."""
    losses = {}
    for dtype in (torch.bfloat16, torch.float32):
        tb = _bundle().to("cpu", torch.bfloat16).to("cpu", dtype)
        pids = TTI.add_placeholder_tokens(tb.text, tb.tokenizer, num_vectors=2,
                                          initializer_token="cat")
        tb.text.requires_grad_(False)
        tb.unet.requires_grad_(False)
        state = TTI.init_ti_state(tb.text,
                                  functools.partial(torch.optim.Adam, lr=LR))
        before = state.embeddings.detach().clone()
        g = torch.Generator().manual_seed(0)
        lat = torch.randn(2, 4, 8, 8, generator=g)
        ids = np.asarray([TTI.placeholder_prompt_ids(
            tb.tokenizer, "a photo of a {}", pids, 8)] * 2)
        _, m = TTI.make_ti_train_step(make_schedule(), pids)(
            state, tb.text, tb.unet, {"latents": lat, "input_ids": ids},
            t=torch.tensor([10, 700]),
            noise=torch.randn(2, 4, 8, 8, generator=g))
        assert state.embeddings.dtype == dtype
        moved = (state.embeddings.detach() != before).any(dim=1)
        assert moved.nonzero().flatten().tolist() == pids
        losses[dtype] = float(m["loss"])
    np.testing.assert_allclose(losses[torch.bfloat16], losses[torch.float32],
                               rtol=BF16_LOSS_RTOL)


def _folder(d, n=2):
    d.mkdir()
    rng = np.random.RandomState(1)
    for i in range(n):
        write_png(str(d / f"i{i}.png"),
                  rng.randint(0, 256, (48, 56, 3)).astype(np.uint8))
    return d


def test_train_textual_inversion_end_to_end(tmp_path):
    data = _folder(tmp_path / "imgs")
    kw = dict(data_dir=str(data), output_path=str(tmp_path / "e.npy"),
              num_vectors=2, initializer_token="cat", batch_size=2,
              resolution=64, save_steps=2, out_dir=str(tmp_path / "run"),
              ckpt_every=2, log_every=1, device="cpu")
    tb = _bundle()
    table0 = tb.text.embeddings.token_embedding.weight.detach().clone()
    state, pids = train_textual_inversion(bundle=tb, max_steps=3, **kw)
    assert state.step == 3 and pids == [2000, 2001]
    assert tb.tokenizer.placeholders == {"<new-obj>": pids}
    table = tb.text.embeddings.token_embedding.weight.detach()
    assert table.shape == (2002, 32)
    torch.testing.assert_close(table[:2000], table0, atol=0, rtol=0)
    learned = load_ti_file(str(tmp_path / "e.npy"))
    np.testing.assert_array_equal(learned, table[2000:].numpy())
    init = table0[tb.tokenizer.encode("cat")[0]].numpy()
    assert not np.allclose(learned, init[None])
    # a fresh bundle from the same seed resumes from step 3
    state2, _ = train_textual_inversion(bundle=_bundle(), max_steps=4, **kw)
    assert state2.step == 4
    assert not np.array_equal(load_ti_file(str(tmp_path / "e.npy")), learned)


def test_train_textual_inversion_on_a_bf16_bundle(tmp_path):
    """``train_textual_inversion`` (what ``train_staged_textinv`` runs) on a
    bf16 bundle, the dtype ``load_bundle`` gives: it trains, writes finite
    rows and leaves them in the bf16 table."""
    data = _folder(tmp_path / "imgs")
    tb = _bundle().to("cpu", torch.bfloat16)
    table0 = tb.text.embeddings.token_embedding.weight.detach().clone()
    state, pids = train_textual_inversion(
        bundle=tb, data_dir=str(data), output_path=str(tmp_path / "e.npy"),
        num_vectors=2, initializer_token="cat", batch_size=2, resolution=64,
        max_steps=3, device="cpu")
    assert state.step == 3
    table = tb.text.embeddings.token_embedding.weight.detach()
    assert table.dtype == torch.bfloat16 and table.shape == (2002, 32)
    torch.testing.assert_close(table[:2000], table0, atol=0, rtol=0)
    learned = load_ti_file(str(tmp_path / "e.npy"))
    assert np.isfinite(learned).all()
    np.testing.assert_array_equal(learned, table[2000:].float().numpy())
    assert not np.array_equal(learned[0], table0[tb.tokenizer.encode("cat")[0]]
                              .float().numpy())


def test_staged_textinv_trains_and_feeds_process(tmp_path, capsys):
    tb = _bundle(("sam", "inpaint"))
    editor = EditAnythingEditor(tb)
    editor.textinv_stage_dir = str(tmp_path / "stage")
    rng = np.random.RandomState(2)
    ref_mask = np.zeros((64, 64), np.uint8)
    ref_mask[8:56, 16:48] = 255
    req = dict(image=rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
               mask=(np.mgrid[0:64, 0:64][0] > 32).astype(np.uint8) * 255,
               condition_image=rng.randint(0, 255, (64, 64, 3)).astype(
                   np.uint8),
               prompt="a photo of <new-obj>", num_samples=1,
               image_resolution=64, detect_resolution=64, ddim_steps=2,
               ref_image=rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
               ref_mask=ref_mask, ref_textinv=True)
    path = str(tmp_path / "learned.npy")
    editor.process(**req, ref_textinv_path=path)
    assert "staged the ref crop" in capsys.readouterr().out
    out = editor.train_staged_textinv(path, max_steps=2, num_vectors=2,
                                      batch_size=1, resolution=64)
    assert out == path
    learned = load_ti_file(path)
    assert learned.shape == (2, 32)
    _, results, _, _ = editor.process(**req, ref_textinv_path=path)
    assert results[0].shape == (64, 64, 3) and results[0].dtype == np.uint8
    # the file's rows appended once more and the placeholder moved to them
    table = tb.text.embeddings.token_embedding.weight.detach()
    assert table.shape[0] == 2004
    assert tb.tokenizer.placeholders["<new-obj>"] == [2002, 2003]
    np.testing.assert_array_equal(table[2002:].numpy(), learned)
    np.testing.assert_array_equal(table[2000:2002].numpy(), learned)
