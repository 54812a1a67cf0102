"""The port's BLIP-2 (models/blip2.py), its GPT-2 tokenizer and its loaders
against the JAX package's, at the JAX package's tiny widths in fp32.

Weights: every parameter drawn nonzero with numpy from a seed, in the port's
names, and carried to the JAX tree by the JAX package's ``blip2_to_tree``
(the port's names are what its key map produces, so they pass it as they
are); the HF layout (the tiny ``transformers`` Blip2ForConditionalGeneration's
keys) goes through ``blip2_to_tree`` on one side and the port's
``blip2_state_dict`` / ``load_blip2`` on the other; a JAX ``init_blip2``
tree through ``state_dict_from_tree``.

Tolerances: the tokenizer exact; the vision tower, the Q-Former, OPT's
prefill and decode logits within 1e-5 of JAX's (fp32 sums in other orders;
outputs of magnitude ~1-10); greedy tokens equal, with every step's top-2
logit margin above 1e-5 so that no tie decides a token; the HF model's own
outputs within 2e-5, with its LayerNorm eps set to the 1e-5 that the JAX
package and the port use everywhere.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.checkpoints.convert import blip2_to_tree
from editanything_tpu.models import blip2 as JB
from editanything_tpu.text import tokenizer as JT
from editanything_tpu_torch.checkpoints.convert import (blip2_state_dict,
                                                        state_dict_from_tree)
from editanything_tpu_torch.checkpoints.safetensors_io import save_file
from editanything_tpu_torch.models import blip2 as TB
from editanything_tpu_torch.pipelines.bundle import (load_blip2,
                                                     module_from_state_dict,
                                                     random_blip2)
from editanything_tpu_torch.text import tokenizer as TT

TINY = TB.tiny_blip2_config()
JTINY = JB.tiny_blip2_config()
TOL = 1e-5
HF_TOL = 2e-5
PROMPT_LEN = 3
NEW_TOKENS = 8
TEXTS = ["a photo of a cat", "  two  spaces and a dog ", "cats: 12, dogs: 3.5!?",
         "naïve café — 日本語 ✓ a cat's toy"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def random_state_dict(seed: int, cfg=TINY) -> dict:
    """Every parameter of the port's BLIP2 drawn nonzero (numpy fp32):
    weights N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1),
    the token table N(0, 0.5) so that greedy margins are wide, the other
    embeddings N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in TB.BLIP2(cfg).state_dict().items()}
    out = {}
    for k, shape in shapes.items():
        if k.endswith("embed_tokens.weight"):
            a = 0.5 * rng.standard_normal(shape)
        elif len(shape) >= 2 and k.endswith(".weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif "norm" in k and k.endswith(".weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k.endswith(".bias"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = 0.3 * rng.standard_normal(shape)
        out[k] = a.astype(np.float32)
    return out


def port_model(sd: dict) -> TB.BLIP2:
    return module_from_state_dict(
        TB.BLIP2, TINY, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX functions, jitted once for the module."""
    return {
        "vision": jax.jit(lambda p, x: JB.vision_encoder(p, JTINY, x)),
        "qformer": jax.jit(lambda p, x: JB.qformer(p, JTINY, x)),
        "prefill": jax.jit(lambda p, e: JB._prefill_caches(
            p, JTINY, e, e.shape[1] + NEW_TOKENS)),
        "forward": jax.jit(lambda p, e: JB.opt_forward(p, JTINY, e)[0]),
        "decode": jax.jit(lambda p, e, c, pos: JB.opt_forward(
            p, JTINY, e, caches=c, pos=pos, total_len=c[0]["k"].shape[2])),
        "caption": jax.jit(JB.make_caption_fn(
            JTINY, prompt_len=PROMPT_LEN, max_new_tokens=NEW_TOKENS)),
    }


@pytest.fixture(scope="module")
def models():
    sd = random_state_dict(0)
    return blip2_to_tree(sd), port_model(sd)


def _pixels(seed, b=2):
    x = np.random.RandomState(seed).randn(b, TINY.image_size, TINY.image_size,
                                          3).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _prompts(seed, b=2):
    return np.random.RandomState(seed).randint(
        3, TINY.vocab_size, (b, PROMPT_LEN)).astype(np.int32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    diff = np.abs(got - np.asarray(want)).max()
    assert diff <= tol, diff
    return diff


# --- tokenizer and config --------------------------------------------------

@pytest.mark.parametrize("text", TEXTS)
def test_gpt2_tokenizer_matches_jax(text):
    jt, tt = JT.tiny_gpt2_tokenizer(), TT.tiny_gpt2_tokenizer()
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids) == text
    framed = [tt.bos_id] + ids + [tt.pad_id, tt.eos_id, 9999]
    assert tt.decode(framed) == jt.decode(framed)


def test_gpt2_tokenizer_from_files_matches_jax(tmp_path):
    base = TT.tiny_gpt2_tokenizer(words=("photo", "cat", "ca", "at"))
    vocab = tmp_path / "vocab.json"
    merges = tmp_path / "merges.txt"
    vocab.write_text(json.dumps(base.encoder), encoding="utf-8")
    ranked = sorted(base.bpe_ranks, key=base.bpe_ranks.get)
    merges.write_text("#version: 0.2\n" + "\n".join(" ".join(p) for p in ranked)
                      + "\n", encoding="utf-8")
    tt = TT.GPT2Tokenizer.from_files(str(vocab), str(merges))
    jt = JT.GPT2Tokenizer.from_files(str(vocab), str(merges))
    assert (tt.bos_id, tt.eos_id, tt.pad_id) == (jt.bos_id, jt.eos_id,
                                                 jt.pad_id) == (2, 2, 1)
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text) == base.encode(text)


def test_blip2_config_mirrors_jax():
    jf = [(f.name, f.type) for f in dataclasses.fields(JB.BLIP2Config)]
    tf = [(f.name, f.type) for f in dataclasses.fields(TB.BLIP2Config)]
    assert jf == tf
    assert dataclasses.asdict(JB.BLIP2Config()) == dataclasses.asdict(TB.BLIP2Config())
    assert dataclasses.asdict(JTINY) == dataclasses.asdict(TINY)
    assert JB.BLIP2Config().num_patches == TB.BLIP2Config().num_patches == 256


# --- the model, piece by piece ------------------------------------------------

def test_vision_encoder_and_qformer_match_jax(models, jax_fns):
    tree, port = models
    x, px = _pixels(1)
    want = jax_fns["vision"](tree, jnp.asarray(x))
    with torch.no_grad():
        got = TB.vision_encoder(port, px)
        assert got.shape == (2, 1 + TINY.num_patches, TINY.vision_hidden)
        _close(got, want)
        q_want = jax_fns["qformer"](tree, want)
        q_got = TB.qformer(port, torch.from_numpy(np.asarray(want)))
    assert q_got.shape == (2, TINY.num_query_tokens, TINY.qformer_hidden)
    _close(q_got, q_want)


def test_opt_prefill_and_decode_logits_match_jax(models, jax_fns):
    """Prefill logits and caches, then 3 decode steps through the cache, each
    against JAX's and against the port's own full forward over the grown
    sequence."""
    tree, port = models
    emb = 0.5 * np.random.RandomState(2).randn(2, 5, TINY.opt_hidden) \
        .astype(np.float32)
    j_logits, j_caches = jax_fns["prefill"](tree, jnp.asarray(emb))
    table = port.language_model.embed_tokens.weight
    with torch.no_grad():
        t_emb = torch.from_numpy(emb)
        logits, caches = TB._prefill_caches(port, t_emb, 5 + NEW_TOKENS)
        _close(logits, j_logits)
        for c, jc in zip(caches, j_caches):
            _close(c["k"], jc["k"])
            _close(c["v"], jc["v"])
        full, _ = TB.opt_forward(port, t_emb)
        _close(full, jax_fns["forward"](tree, jnp.asarray(emb)))
        _close(full[:, -1], logits)
        seq = t_emb
        for step in range(3):
            tok = logits.argmax(-1)
            temb = table[tok][:, None]
            seq = torch.cat([seq, temb], dim=1)
            logits_j, j_caches = jax_fns["decode"](
                tree, jnp.asarray(temb.numpy()), j_caches, 5 + step)
            lg, caches = TB.opt_forward(port, temb, caches=caches, pos=5 + step,
                                        total_len=5 + NEW_TOKENS)
            _close(lg, logits_j)
            full, _ = TB.opt_forward(port, seq)
            _close(lg[:, -1], full[:, -1])
            logits = lg[:, -1]


def greedy_margins(port, px, prompt, toks) -> np.ndarray:
    """Top-2 logit margin of every step up to each row's first eos, from the
    full forward over [queries; prompt; tokens so far]."""
    lm = port.language_model
    with torch.no_grad():
        qemb = port.language_projection(TB.qformer(port, TB.vision_encoder(port, px)))
        seq = torch.cat([qemb, lm.embed_tokens(prompt),
                         lm.embed_tokens(toks[:, :-1])], dim=1)
        logits, _ = TB.opt_forward(port, seq)
    n0 = qemb.shape[1] + prompt.shape[1]
    top2 = logits[:, n0 - 1:].topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).numpy()
    eos = (toks == TINY.eos_token_id).numpy()
    first = np.where(eos.any(1), eos.argmax(1), toks.shape[1] - 1)
    return np.concatenate([margins[r, :first[r] + 1] for r in range(len(first))])


def test_greedy_tokens_equal_make_caption_fn(models, jax_fns):
    tree, port = models
    x, px = _pixels(3)
    prompt = _prompts(4)
    want = np.asarray(jax_fns["caption"](tree, jnp.asarray(x), jnp.asarray(prompt)))
    with torch.no_grad():
        got = TB.caption(port, px, torch.from_numpy(prompt).long(),
                         max_new_tokens=NEW_TOKENS)
    margins = greedy_margins(port, px, torch.from_numpy(prompt).long(), got)
    print(f"tokens {got.tolist()}; smallest top-2 margin {margins.min():.3e}")
    assert margins.min() > TOL
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_eos_latches_and_stops_early(models, jax_fns):
    """With eos's embedding row made the likeliest next token, rows reach eos
    within the budget and stay there; the port's loop stops at the step
    where every row is done, and its tokens equal JAX's fixed-length scan."""
    tree, port = models
    sd = random_state_dict(0)
    table = sd["language_model.embed_tokens.weight"]
    hidden = port_hidden_direction(port)
    table[TINY.eos_token_id] = 3.0 * hidden
    tree_eos, port_eos = blip2_to_tree(sd), port_model(sd)
    x, px = _pixels(5)
    prompt = _prompts(6)
    want = np.asarray(jax_fns["caption"](tree_eos, jnp.asarray(x),
                                         jnp.asarray(prompt)))
    calls = []
    forward = TB.opt_forward

    def counted(*args, **kwargs):
        calls.append(kwargs.get("pos"))
        return forward(*args, **kwargs)
    TB.opt_forward = counted
    try:
        with torch.no_grad():
            got = TB.caption(port_eos, px, torch.from_numpy(prompt).long(),
                             max_new_tokens=NEW_TOKENS).numpy()
    finally:
        TB.opt_forward = forward
    np.testing.assert_array_equal(got, want)
    eos = got == TINY.eos_token_id
    assert eos.any(1).all(), got
    first = eos.argmax(1)
    for r, f in enumerate(first):
        assert eos[r, f:].all()
    # decode steps run until the step at which the last row first emits eos
    assert len(calls) == first.max() < NEW_TOKENS - 1, (calls, got)


def port_hidden_direction(port) -> np.ndarray:
    """The mean final-norm output over a few random sequences: a token row
    along it wins the argmax at most positions."""
    emb = torch.from_numpy(np.random.RandomState(7).randn(
        4, 6, TINY.opt_hidden).astype(np.float32))
    lm = port.language_model
    with torch.no_grad():
        x = emb + lm.embed_positions.weight[torch.arange(6) + 2]
        for lp in lm.layers:
            x, _ = TB._opt_layer(lp, TINY, x, TB._causal_mask(6, "cpu"))
        h = lm.final_layer_norm(x).mean(dim=(0, 1))
    return (h / h.norm()).numpy()


# --- weights carried across ---------------------------------------------------

def test_jax_init_tree_loads_strictly(jax_fns):
    tree = jax.jit(JB.init_blip2, static_argnums=1)(jax.random.PRNGKey(0),
                                                   JTINY)
    port = TB.BLIP2(TINY).eval()
    port.load_state_dict(state_dict_from_tree(tree), strict=True)
    x, px = _pixels(8)
    with torch.no_grad():
        _close(TB.vision_encoder(port, px), jax_fns["vision"](tree, jnp.asarray(x)))


def hf_tiny_model(eps=None):
    """transformers' Blip2ForConditionalGeneration at TINY's widths (random
    init, no files); `eps` overrides the vision tower's and the Q-Former's
    LayerNorm eps."""
    os.environ.setdefault("USE_TF", "0")     # transformers' torch side only
    from transformers import (Blip2Config, Blip2ForConditionalGeneration,
                              Blip2QFormerConfig, Blip2VisionConfig, OPTConfig)
    vc = Blip2VisionConfig(
        hidden_size=TINY.vision_hidden, intermediate_size=TINY.vision_mlp,
        num_hidden_layers=TINY.vision_layers,
        num_attention_heads=TINY.vision_heads, image_size=TINY.image_size,
        patch_size=TINY.patch_size, **({} if eps is None else
                                       {"layer_norm_eps": eps}))
    qc = Blip2QFormerConfig(
        hidden_size=TINY.qformer_hidden, num_hidden_layers=TINY.qformer_layers,
        num_attention_heads=TINY.qformer_heads,
        intermediate_size=TINY.qformer_mlp,
        cross_attention_frequency=TINY.cross_attention_frequency,
        encoder_hidden_size=TINY.vision_hidden, vocab_size=64,
        **({} if eps is None else {"layer_norm_eps": eps}))
    tc = OPTConfig(hidden_size=TINY.opt_hidden, num_hidden_layers=TINY.opt_layers,
                   ffn_dim=TINY.opt_ffn, num_attention_heads=TINY.opt_heads,
                   vocab_size=TINY.vocab_size,
                   max_position_embeddings=TINY.max_positions,
                   word_embed_proj_dim=TINY.opt_hidden)
    cfg = Blip2Config(vision_config=vc.to_dict(), qformer_config=qc.to_dict(),
                      text_config=tc.to_dict(),
                      num_query_tokens=TINY.num_query_tokens)
    torch.manual_seed(0)
    return Blip2ForConditionalGeneration(cfg).eval()


def test_hf_layout_through_both_loaders_computes_the_same(tmp_path, jax_fns):
    """A random HF-layout state dict (every value nonzero, the LM head tied)
    through JAX's blip2_to_tree and the port's load_blip2 (a .safetensors
    file): equal image tokens, queries and greedy tokens. The older layout
    (bias-free fused qkv beside q_bias and v_bias) loads to the same model
    where the fused bias's k third is zero."""
    rng = np.random.default_rng(11)
    keys = {k: tuple(v.shape) for k, v in hf_tiny_model().state_dict().items()}
    hf = {}
    for k, shape in keys.items():
        scale = 0.5 if k.endswith("embed_tokens.weight") else (
            1.0 / np.sqrt(np.prod(shape[1:])) if len(shape) >= 2 and
            k.endswith("weight") else 0.1)
        hf[k] = (scale * rng.standard_normal(shape)).astype(np.float32)
    hf["language_model.lm_head.weight"] = hf[
        "language_model.model.decoder.embed_tokens.weight"]
    tree = blip2_to_tree(hf)
    path = tmp_path / "blip2.safetensors"
    save_file({k: torch.from_numpy(v) for k, v in hf.items()}, str(path))
    port = load_blip2(str(path), TINY, device="cpu", dtype=torch.float32)
    x, px = _pixels(9)
    prompt = _prompts(10)
    img = jax_fns["vision"](tree, jnp.asarray(x))
    with torch.no_grad():
        _close(TB.vision_encoder(port, px), img)
        _close(TB.qformer(port, torch.from_numpy(np.asarray(img))),
               jax_fns["qformer"](tree, img))
        got = TB.caption(port, px, torch.from_numpy(prompt).long(),
                         max_new_tokens=NEW_TOKENS)
    assert greedy_margins(port, px, torch.from_numpy(prompt).long(),
                          got).min() > TOL
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_fns["caption"](tree, jnp.asarray(x), jnp.asarray(prompt))))

    legacy = {k: torch.from_numpy(v) for k, v in hf.items()}
    for i in range(TINY.vision_layers):
        pre = f"vision_model.encoder.layers.{i}.self_attn."
        q, k, v = legacy.pop(pre + "qkv.bias").chunk(3)
        legacy[pre + "q_bias"], legacy[pre + "v_bias"] = q, v
        hf[pre + "qkv.bias"][TINY.vision_hidden:2 * TINY.vision_hidden] = 0
    old = module_from_state_dict(TB.BLIP2, TINY, blip2_state_dict(legacy),
                                 device="cpu", dtype=torch.float32)
    new = module_from_state_dict(
        TB.BLIP2, TINY, blip2_state_dict({k: torch.from_numpy(v)
                                          for k, v in hf.items()}),
        device="cpu", dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(TB.vision_encoder(old, px),
                                   TB.vision_encoder(new, px), rtol=0, atol=0)
    untied = {k: torch.from_numpy(v) for k, v in hf.items()}
    untied["language_model.lm_head.weight"] = untied[
        "language_model.lm_head.weight"] + 1.0
    with pytest.raises(ValueError, match="tied"):
        blip2_state_dict(untied)


def test_hf_model_loads_strictly_and_matches_hf(tmp_path):
    """The tiny transformers model's own state dict (a .pt file) loads
    strictly through load_blip2, and with its LayerNorm eps at 1e-5 the
    port's image tokens, queries and OPT logits equal HF's."""
    hf = hf_tiny_model(eps=1e-5)
    with torch.no_grad():   # HF's init leaves biases and the k bias at zero
        for name, p in hf.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    path = tmp_path / "blip2.pt"
    torch.save(hf.state_dict(), str(path))
    port = load_blip2(str(path), TINY, device="cpu", dtype=torch.float32)
    _, px = _pixels(12)
    with torch.no_grad():
        img = hf.vision_model(pixel_values=px).last_hidden_state
        _close(TB.vision_encoder(port, px), img.numpy(), HF_TOL)
        queries = hf.qformer(query_embeds=hf.query_tokens.expand(2, -1, -1),
                             encoder_hidden_states=img).last_hidden_state
        _close(TB.qformer(port, img), queries.numpy(), HF_TOL)
        emb = hf.language_projection(queries)
        want = hf.language_model(inputs_embeds=emb).logits
        got, _ = TB.opt_forward(port, emb)
    _close(got, want.numpy(), HF_TOL)


def test_random_blip2_draws_every_tensor():
    model = random_blip2(TINY, device="cpu", seed=3)
    again = random_blip2(TINY, device="cpu", seed=3)
    for (name, p), q in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith("weight") or name in (
                "vision_model.cls_token", "vision_model.pos_embed",
                "qformer.query_tokens"):
            assert p.abs().sum() > 0, name
    std = model.qformer.query_tokens.std().item()
    assert 0.01 < std < 0.03
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            random_blip2(TINY)
