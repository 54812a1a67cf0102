"""The port's checkpoint loaders against the JAX package's and the
safetensors package.

The ``.safetensors`` reader and writer against ``safetensors.torch`` and
``safetensors.numpy`` both ways, at every dtype of the format, 0-d and
empty tensors and ``__metadata__``; ``load_torch_state_dict`` on each file
family; every ldm/cldm key map on tests/ldm_replica.py's genuine ldm
layouts and tests/sd_replica.py's diffusers ones, key for key and array
for array, and their round trips; the cldm YAML configs; kohya LoRA merging
and both textual-inversion loaders; the tokenizer's file formats and
placeholders; and the surgery tools. The maps move arrays without
arithmetic, so they are held exactly; so are bf16 LoRA merges (the port
rounds as the JAX package does) and fp32 ones within 1e-6 (products summed
in another order).
"""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as stn
import safetensors.torch as stt
import torch
from safetensors import safe_open

from editanything_tpu.checkpoints import convert as JCV
from editanything_tpu.checkpoints import ldm as JLDM
from editanything_tpu.checkpoints import legacy as JLEG
from editanything_tpu.checkpoints import lora as JLORA
from editanything_tpu.checkpoints import surgery as JSURG
from editanything_tpu.checkpoints.convert import state_dict_to_tree
from editanything_tpu.text import tokenizer as JTOK
from editanything_tpu.train import textual_inversion as JTI
from editanything_tpu_torch.checkpoints import convert as TCV
from editanything_tpu_torch.checkpoints import ldm as TLDM
from editanything_tpu_torch.checkpoints import legacy as TLEG
from editanything_tpu_torch.checkpoints import lora as TLORA
from editanything_tpu_torch.checkpoints import safetensors_io as SIO
from editanything_tpu_torch.checkpoints import surgery as TSURG
from editanything_tpu_torch.checkpoints.convert import state_dict_from_tree
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.text import tokenizer as TTOK

import ldm_replica as LR
import sd_replica as R
from test_ldm_ingest import TINY_YAML, _diff_unet, _ldm_unet
from test_sd_parity import _randomize

DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny ops on one thread: beside the other test workers a thread pool
    per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(sd):
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def _t(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_same(got, want, what=""):
    """Same keys, and at each the same array (dtype-agnostic, exact)."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:8])
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(np.asarray(g), np.asarray(want[k]),
                                      err_msg=f"{what} {k}")


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    full = torch.randn(3, 5, 2, generator=g) * 50
    if dtype == torch.uint8:
        full = full.abs()
    return {"a.weight": full.to(dtype),
            "b.scalar": full[0, 0, 0].to(dtype).clone(),
            "c.empty": torch.zeros(0, 4, dtype=dtype),
            "d.vector": full[:, 0, 0].to(dtype).clone()}


# --- safetensors_io --------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_io_matches_the_package_both_ways(tmp_path, dtype):
    ts = _tensors(dtype)
    meta = {"format": "pt", "note": "x"}
    ours, theirs = str(tmp_path / "ours.st"), str(tmp_path / "theirs.st")
    SIO.save_file(ts, ours, metadata=meta)
    stt.save_file(ts, theirs, metadata=meta)
    for path in (ours, theirs):
        for got in (stt.load_file(path), SIO.load_file(path)):
            assert set(got) == set(ts)
            for k, v in ts.items():
                assert got[k].dtype == dtype and got[k].shape == v.shape, k
                assert torch.equal(got[k], v), k
        with safe_open(path, framework="pt") as f:
            assert f.metadata() == meta
    if dtype != torch.bfloat16:     # numpy has no bfloat16
        arrays = {k: v.numpy() for k, v in ts.items()}
        npath = str(tmp_path / "numpy.st")
        stn.save_file(arrays, npath)
        _assert_same(SIO.load_file(npath), arrays)
        _assert_same(stn.load_file(ours), arrays)


def test_safetensors_io_casts_floats_only(tmp_path):
    path = str(tmp_path / "mixed.st")
    SIO.save_file({"w": torch.randn(4, 4).half(), "i": torch.arange(3)}, path)
    got = SIO.load_file(path, dtype=torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and got["i"].dtype == torch.int64
    assert torch.equal(got["w"], stt.load_file(path)["w"].bfloat16())


# --- load_torch_state_dict -------------------------------------------------

def _write(kind, sd, path):
    tensors = _t(sd)
    if kind == "safetensors":
        stn.save_file(sd, path)
    elif kind == "pt":
        torch.save(tensors, path)
    elif kind == "lightning ckpt":
        torch.save({"state_dict": tensors, "global_step": 12}, path)
    else:       # detectron2 / DETR
        torch.save({"model": tensors, "iteration": 5}, path)


@pytest.mark.parametrize("kind,suffix", [
    ("safetensors", ".safetensors"), ("pt", ".pt"),
    ("lightning ckpt", ".ckpt"), ("model-wrapped pth", ".pth")])
def test_load_torch_state_dict_matches_jax(tmp_path, kind, suffix):
    rng = np.random.default_rng(1)
    sd = {"x.weight": rng.standard_normal((4, 3)).astype(np.float32),
          "x.bias": rng.standard_normal(4).astype(np.float16),
          "n.steps": np.arange(3, dtype=np.int64)}
    path = str(tmp_path / f"ckpt{suffix}")
    _write(kind, sd, path)
    want = JCV.load_torch_state_dict(path)
    got = TCV.load_torch_state_dict(path)
    _assert_same(got, want, kind)
    for k in sd:
        assert got[k].numpy().dtype == want[k].dtype
    cast = TCV.load_torch_state_dict(path, dtype=torch.bfloat16)
    assert cast["x.weight"].dtype == torch.bfloat16
    assert cast["n.steps"].dtype == torch.int64


class _Custom:
    pass


def test_load_torch_state_dict_refuses_arbitrary_pickles(tmp_path):
    path = str(tmp_path / "custom.pt")
    torch.save({"w": torch.ones(2), "obj": _Custom()}, path)
    with pytest.raises(ValueError, match="custom.pt.*weights_only"):
        TCV.load_torch_state_dict(path)


# --- ldm / cldm key maps ---------------------------------------------------

def _diff_controlnet():
    return _np(_randomize(R.ControlNetReplica(
        _diff_unet(), cond_chans=(4, 8, 8, 8), block_out_channels=(32, 64),
        layers_per_block=2), seed=5).state_dict_standalone())


def _ldm_controlnet():
    return _np(_randomize(LR.LDMControlNetReplica(
        model_channels=32, channel_mult=(1, 2), num_res_blocks=2,
        context_dim=48, heads=2, groups=8, hint_chans=(4, 8, 8, 8)),
        seed=6).state_dict())


def _diff_vae():
    return _np(_randomize(R.VAEReplica(chans=(8, 8, 8, 16), layers=1, z=4,
                                       groups=4), seed=7).state_dict())


def _ldm_vae():
    return _np(_randomize(LR.LDMVAEReplica(chans=(8, 8, 8, 16), layers=1,
                                           z=4, groups=4), seed=8).state_dict())


def _openclip():
    torch.manual_seed(4)
    return _np(LR.LDMOpenCLIPTextReplica(vocab=100, d=32, layers=3, heads=4,
                                         ctx=8).state_dict())


KEY_MAPS = {
    "unet ldm->diffusers": ("ldm_unet_to_diffusers",
                            lambda: _np(_ldm_unet().state_dict()), ()),
    "unet diffusers->ldm": ("diffusers_unet_to_ldm",
                            lambda: _np(_diff_unet().state_dict()), (2,)),
    "controlnet cldm->diffusers": ("ldm_controlnet_to_diffusers",
                                   _ldm_controlnet, ()),
    "controlnet diffusers->cldm": ("diffusers_controlnet_to_ldm",
                                   _diff_controlnet, (2,)),
    "vae ldm->diffusers": ("ldm_vae_to_diffusers", _ldm_vae, ()),
    "vae diffusers->ldm": ("diffusers_vae_to_ldm", _diff_vae, ()),
    "openclip->hf": ("openclip_text_to_hf", _openclip, (2,)),
    "hf->openclip": ("hf_text_to_openclip",
                     lambda: JLDM.openclip_text_to_hf(_openclip(), 2), ()),
}


@pytest.mark.parametrize("case", KEY_MAPS)
def test_ldm_key_map_matches_jax(case):
    name, make, args = KEY_MAPS[case]
    sd = make()
    got = getattr(TLDM, name)(_t(sd), *args)
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    _assert_same(got, getattr(JLDM, name)(sd, *args), case)


@pytest.mark.parametrize("case", ["unet", "controlnet", "vae", "text"])
def test_ldm_round_trip(case):
    """diffusers -> ldm -> diffusers returns the state dict unchanged."""
    if case == "unet":
        sd = _np(_diff_unet().state_dict())
        back = TLDM.ldm_unet_to_diffusers(TLDM.diffusers_unet_to_ldm(sd, 2))
    elif case == "controlnet":
        sd = _diff_controlnet()
        back = TLDM.ldm_controlnet_to_diffusers(
            TLDM.diffusers_controlnet_to_ldm(sd, 2))
    elif case == "vae":
        sd = _diff_vae()
        back = TLDM.ldm_vae_to_diffusers(TLDM.diffusers_vae_to_ldm(sd))
    else:
        sd = TLDM.openclip_text_to_hf(_openclip(), 2)
        back = TLDM.openclip_text_to_hf(TLDM.hf_text_to_openclip(_t(sd)), 2)
    _assert_same(back, sd, case)


def _cldm_sd(text_layout="openclip"):
    # the open_clip tower whole (3 resblocks), the HF one already cut to 2
    text = JLDM.openclip_text_to_hf(_openclip(),
                                    3 if text_layout == "openclip" else 2)
    sd = _np(TLDM.state_dicts_to_ldm(
        unet=_diff_unet().state_dict(), vae=_t(_diff_vae()), text=_t(text),
        controlnet=_t(_diff_controlnet()), text_layout=text_layout))
    sd["model.betas"] = np.linspace(1e-4, 2e-2, 10).astype(np.float32)
    sd["model_ema.decay"] = np.asarray(0.9999, np.float32)
    return sd


@pytest.mark.parametrize("text_layout,extract_ema",
                         [("openclip", False), ("hf", False),
                          ("openclip", True)])
def test_ldm_to_state_dicts_matches_ldm_to_tree(text_layout, extract_ema):
    """Each section through the port equals the JAX package's tree of it,
    the EMA shadow (model_ema.*, dots removed) in place of the live UNet
    where asked; and state_dicts_to_ldm writes the sections back."""
    sd = _cldm_sd(text_layout)
    if extract_ema:
        for k in [k for k in sd if k.startswith("model.diffusion_model.")]:
            sd["model_ema." + k[len("model."):].replace(".", "")] = \
                sd[k] + np.float32(1.0)
    want = JLDM.ldm_to_tree(sd, extract_ema=extract_ema)
    got = TLDM.ldm_to_state_dicts(_t(sd), extract_ema=extract_ema)
    assert got["text_layout"] == want["text_layout"] == text_layout
    for part in ("unet", "controlnet", "vae", "text"):
        emb = (("token_embedding", "position_embedding") if part == "text"
               else ())
        tree = state_dict_to_tree(_np(got[part]), embedding_modules=emb)
        assert jax.tree.structure(tree) == jax.tree.structure(want[part]), part
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want[part])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if extract_ema:
        live = TLDM.ldm_to_state_dicts(_t(sd))["unet"]
        for k, v in got["unet"].items():
            torch.testing.assert_close(v, live[k] + 1.0, rtol=0, atol=0)
    else:
        # written back, all but the open_clip tower's dropped last resblock
        back = TLDM.state_dicts_to_ldm(
            unet=got["unet"], vae=got["vae"], text=got["text"],
            controlnet=got["controlnet"], text_layout=text_layout)
        _assert_same(back, {k: v for k, v in sd.items()
                            if not k.startswith(("model.betas", "model_ema"))
                            and ".resblocks.2." not in k},
                     "state_dicts_to_ldm")


def test_cldm_controlnet_to_diffusers_sd_matches_jax(tmp_path):
    sd = _cldm_sd()
    path = str(tmp_path / "cldm.ckpt")
    torch.save({"state_dict": _t(sd)}, path)
    want = JLDM.cldm_controlnet_to_diffusers_sd(path)
    _assert_same(TLDM.cldm_controlnet_to_diffusers_sd(path), want)
    _assert_same(want, _diff_controlnet())


def test_missing_section_raises(tmp_path):
    sd = {k: v for k, v in _cldm_sd().items()
          if not k.startswith("first_stage_model.")}
    path = str(tmp_path / "no_vae.ckpt")
    torch.save({"state_dict": _t(sd)}, path)
    with pytest.raises(ValueError, match="no vae section"):
        TLDM.load_ldm_bundle(yaml_dict(TINY_YAML), path, tokenizer=None,
                             device="cpu")


# --- cldm YAML configs -----------------------------------------------------

V2_YAML = TINY_YAML.replace("num_heads: 2", "num_head_channels: 16\n"
                            "        use_linear_in_transformer: true") \
    .replace("timesteps: 1000", "timesteps: 1000\n    parameterization: v")


def yaml_dict(text):
    import yaml
    return yaml.safe_load(text)


def _fields(cfg):
    if dataclasses.is_dataclass(cfg):
        return {f.name: _fields(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    return cfg


@pytest.mark.parametrize("text", [TINY_YAML, V2_YAML], ids=["v1", "v2"])
def test_configs_from_cldm_yaml_match_jax(tmp_path, text):
    path = tmp_path / "cldm.yaml"
    path.write_text(text)
    want = JLEG.configs_from_cldm_yaml(str(path))
    for got in (TLEG.configs_from_cldm_yaml(str(path)),
                TLEG.configs_from_cldm_yaml(yaml_dict(text))):
        for name in ("unet", "controlnet", "vae", "text"):
            assert _fields(got[name]) == _fields(want[name]), name
            assert type(got[name]).__name__ == type(want[name]).__name__
        assert got["sd_locked"] == want["sd_locked"]
        assert got["control_scales"] == want["control_scales"]
        s, w = got["schedule"], want["schedule"]
        assert s.prediction_type == w.prediction_type
        assert s.num_train_timesteps == w.num_train_timesteps
        np.testing.assert_array_equal(s.alphas_cumprod.numpy(),
                                      np.asarray(w.alphas_cumprod))


# --- kohya LoRA --------------------------------------------------------------

# (kohya target, up shape, down shape, alpha or None): attention and FFN
# linears, the 1x1-conv proj_in, a 3x3 resnet conv, the time projection,
# text-encoder projections with HF's text_model. prefix and without it, one
# with no alpha, one naming no module, and one with no down factor
LORA_TARGETS = [
    ("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q",
     (32, 4), (4, 32), 2.0),
    ("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k",
     (32, 4), (4, 32), 1.0),
    ("lora_unet_up_blocks_1_attentions_0_transformer_blocks_0_attn1_to_out_0",
     (32, 4), (4, 32), 4.0),
    ("lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_0_proj",
     (512, 4), (4, 64), 2.0),
    ("lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_2",
     (64, 4), (4, 256), None),
    ("lora_unet_down_blocks_0_attentions_0_proj_in", (32, 4, 1, 1),
     (4, 32, 1, 1), 2.0),
    ("lora_unet_down_blocks_0_resnets_0_conv1", (32, 4, 1, 1),
     (4, 32, 3, 3), 2.0),
    ("lora_unet_down_blocks_1_resnets_0_time_emb_proj", (64, 4), (4, 128),
     2.0),
    ("lora_te_text_model_encoder_layers_0_self_attn_q_proj", (32, 4), (4, 32),
     2.0),
    ("lora_te_text_model_encoder_layers_1_mlp_fc1", (64, 4), (4, 32), 1.0),
    ("lora_te_encoder_layers_1_mlp_fc2", (32, 4), (4, 64), 2.0),
    ("lora_te_text_model_encoder_layers_0_self_attn_out_proj", (32, 4),
     (4, 32), None),
    ("lora_unet_down_blocks_7_attentions_0_proj_in", (32, 4), (4, 32), 1.0),
]


def _lora_sd(seed=11):
    rng = np.random.default_rng(seed)
    sd = {}
    for name, up, down, alpha in LORA_TARGETS:
        sd[f"{name}.lora_up.weight"] = rng.standard_normal(up).astype(
            np.float32) * 0.1
        sd[f"{name}.lora_down.weight"] = rng.standard_normal(down).astype(
            np.float32) * 0.1
        if alpha is not None:
            sd[f"{name}.alpha"] = np.asarray(alpha, np.float32)
    sd["lora_unet_conv_in.lora_up.weight"] = np.ones((32, 4, 1, 1), np.float32)
    return sd


def test_target_to_path_matches_jax():
    for name, *_ in LORA_TARGETS:
        assert TLORA._target_to_path(name) == JLORA._target_to_path(name), name
    model, path = TLORA._target_to_path(LORA_TARGETS[2][0])
    assert path[-2:] == ["to_out", "0"]
    assert TLORA._target_to_path(LORA_TARGETS[3][0])[1][-4:] == [
        "ff", "net", "0", "proj"]


@pytest.mark.parametrize("dtype,multiplier", [
    (torch.float32, 1.0), (torch.float32, 0.7), (torch.bfloat16, 0.5),
    (torch.bfloat16, 0.7)])
def test_merge_kohya_lora_matches_jax(dtype, multiplier):
    tb = random_bundle(tiny=True, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    emb = ("token_embedding", "position_embedding")
    trees = {"unet": state_dict_to_tree(_np(tb.unet.state_dict()), dtype=jdt),
             "text_encoder": state_dict_to_tree(_np(tb.text.state_dict()),
                                                embedding_modules=emb,
                                                dtype=jdt)}
    modules = {"unet": tb.unet.to(dtype), "text_encoder": tb.text.to(dtype)}
    before = {k: v.clone() for k, v in modules["unet"].state_dict().items()}
    sd = _lora_sd()
    want = JLORA.merge_kohya_lora(trees, sd, multiplier=multiplier)
    got = TLORA.merge_kohya_lora(modules, _t(sd), multiplier=multiplier)
    assert got == want == {"merged": 12, "skipped": 2}
    for name in ("unet", "text_encoder"):
        f32 = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                           trees[name])
        want_sd = state_dict_from_tree(f32)
        for k, v in modules[name].state_dict().items():
            w = want_sd[k]
            if dtype == torch.bfloat16:
                assert torch.equal(v.float(), w), (name, k)
            else:
                torch.testing.assert_close(v, w, rtol=0, atol=1e-6)
    changed = [k for k, v in modules["unet"].state_dict().items()
               if not torch.equal(v, before[k])]
    assert len(changed) == 8


# --- textual inversion -------------------------------------------------------

@pytest.mark.parametrize("fmt", ["npy", "diffusers bin", "a1111 pt",
                                 "safetensors"])
def test_load_ti_file_matches_jax(tmp_path, fmt):
    vec = np.random.default_rng(3).standard_normal((2, 32)).astype(np.float32)
    if fmt == "npy":
        path = str(tmp_path / "emb.npy")
        np.save(path, vec)
    elif fmt == "diffusers bin":
        path = str(tmp_path / "learned_embeds.bin")
        torch.save({"<new-obj>": torch.from_numpy(vec)}, path)
    elif fmt == "a1111 pt":
        path = str(tmp_path / "emb.pt")
        torch.save({"string_to_param": {"*": torch.from_numpy(vec)},
                    "name": "emb", "step": 3}, path)
    else:
        path = str(tmp_path / "emb.safetensors")
        stn.save_file({"emb_params": vec}, path)
    want = JLORA.load_ti_file(path)
    got = TLORA.load_ti_file(path)
    assert got.dtype == np.float32 and got.shape == (2, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vec)


def _text_pair():
    tb = random_bundle(tiny=True, device="cpu",
                       generator=torch.Generator().manual_seed(4))
    tree = state_dict_to_tree(_np(tb.text.state_dict()),
                              embedding_modules=("token_embedding",
                                                 "position_embedding"))
    return tb.text, jax.tree.map(jnp.asarray, tree)


def test_textual_inversion_overwrite_matches_jax():
    text, tree = _text_pair()
    vec = np.random.default_rng(5).standard_normal((2, 32)).astype(np.float32)
    want = JLORA.load_textual_inversion(tree, vec, [7, 9])
    TLORA.load_textual_inversion(text, vec, [7, 9])
    got = text.embeddings.token_embedding.weight.detach().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(want["embeddings"]["token_embedding"]["weight"]))
    assert got.shape[0] == 2000


def test_textual_inversion_append_matches_jax():
    text, tree = _text_pair()
    vec = np.random.default_rng(6).standard_normal((3, 32)).astype(np.float32)
    want, want_ids = JTI.load_textual_inversion(tree, jnp.asarray(vec))
    ids = TLORA.append_textual_inversion(text, vec)
    assert ids == want_ids == [2000, 2001, 2002]
    table = text.embeddings.token_embedding
    assert isinstance(table, torch.nn.Embedding) and table.num_embeddings == 2003
    np.testing.assert_array_equal(
        table.weight.detach().numpy(),
        np.asarray(want["embeddings"]["token_embedding"]["weight"]))
    # the grown table encodes its new ids past the config's vocab_size
    out = text(torch.tensor([[1, 2001, 2002, 5]]))
    assert out.shape == (1, 4, 32) and torch.isfinite(out).all()


# --- tokenizer ---------------------------------------------------------------

PROMPTS = ["a photo of <new-obj> on a sofa", "<new-obj>", "a cat, a dog",
           "photo of a dog<new-obj>cat"]


def test_tokenizer_files_and_placeholders_match_jax(tmp_path):
    base = JTOK.tiny_tokenizer()
    merges = [" ".join(p) for p, _ in sorted(base.bpe_ranks.items(),
                                             key=lambda kv: kv[1])]
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges))
    (tmp_path / "vocab.json").write_text(json.dumps(base.encoder))
    with gzip.open(tmp_path / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("header\n" + "\n".join(merges) + "\n")
    pairs = [
        (JTOK.CLIPTokenizer.from_hf(str(tmp_path / "vocab.json"),
                                    str(tmp_path / "merges.txt")),
         TTOK.CLIPTokenizer.from_hf(str(tmp_path / "vocab.json"),
                                    str(tmp_path / "merges.txt"))),
        (JTOK.CLIPTokenizer(vocab_path=str(tmp_path / "bpe.txt.gz")),
         TTOK.CLIPTokenizer(vocab_path=str(tmp_path / "bpe.txt.gz"))),
    ]
    for jt, tt in pairs:
        assert tt.encoder == jt.encoder == base.encoder
        for tok in (jt, tt):
            tok.add_placeholder("<new-obj>", [len(base.encoder),
                                              len(base.encoder) + 1])
        for text in PROMPTS:
            ids = tt.encode(text)
            assert ids == jt.encode(text), text
        plain = tt.encode("a photo of a cat")
        assert tt.decode(plain) == jt.decode(plain) == "a photo of a cat"
    bad = dict(base.encoder, **{"<|endoftext|>": 3})
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="endoftext"):
        TTOK.CLIPTokenizer.from_hf(str(tmp_path / "bad.json"),
                                   str(tmp_path / "merges.txt"))


# --- surgery -----------------------------------------------------------------

def test_surgery_matches_jax():
    tb = random_bundle(tiny=True, device="cpu",
                       generator=torch.Generator().manual_seed(8))
    other = random_bundle(tiny=True, device="cpu",
                          generator=torch.Generator().manual_seed(9))
    unet, unet2 = tb.unet.state_dict(), other.unet.state_dict()
    cn = tb.controlnets["sam"][1].state_dict()
    jt = lambda sd: jax.tree.map(jnp.asarray, state_dict_to_tree(_np(sd)))
    grafted = TSURG.graft_controlnet_from_unet(unet, cn)
    _assert_same(grafted, state_dict_from_tree(
        JSURG.graft_controlnet_from_unet(jt(unet), jt(cn))))
    shared = [k for k in cn if k.split(".")[0] in TSURG._SHARED_KEYS]
    assert shared and all(torch.equal(grafted[k], unet[k]) for k in shared)
    assert all(torch.equal(grafted[k], cn[k]) for k in cn if k not in shared)
    moved = TSURG.transfer_control_offset(cn, unet, unet2)
    want = state_dict_from_tree(jax.tree.map(np.asarray, (
        JSURG.transfer_control_offset(jt(cn), jt(unet), jt(unet2)))))
    for k in cn:
        torch.testing.assert_close(moved[k], want[k], rtol=0, atol=1e-6)


def test_transfer_control_matches_jax():
    sd = _cldm_sd("hf")
    rng = np.random.default_rng(4)
    new_base = {k: (v + rng.standard_normal(v.shape).astype(v.dtype)
                    if v.dtype == np.float32 else v) for k, v in sd.items()}
    _assert_same(TLDM.transfer_control(_t(sd), _t(sd), _t(new_base)),
                 JLDM.transfer_control(sd, sd, new_base))


def test_add_control_grafts_from_diffusion():
    """tool_add_control's semantics: the control branch in the genuine
    cldm layout (tests/ldm_replica.py's, with cldm's 16/32/96/256 hint
    stack), its encoder copied from model.diffusion_model, its zero convs
    and the hint stack's last conv zero."""
    full = _cldm_sd("hf")
    plain = {k: v for k, v in full.items()
             if not k.startswith("control_model.")}
    layout = LR.LDMControlNetReplica(
        model_channels=32, channel_mult=(1, 2), num_res_blocks=2,
        context_dim=48, heads=2, groups=8,
        hint_chans=(16, 32, 96, 256)).state_dict()
    got = TLDM.add_control(_t(plain))
    ctrl = {k[len("control_model."):]: v for k, v in got.items()
            if k.startswith("control_model.")}
    assert {k: tuple(v.shape) for k, v in ctrl.items()} == {
        k: tuple(v.shape) for k, v in layout.items()}
    assert {k: v for k, v in got.items()
            if not k.startswith("control_model.")}.keys() == plain.keys()
    copied = [k for k in ctrl if "model.diffusion_model." + k in plain]
    assert len(copied) > 50
    for k in copied:
        np.testing.assert_array_equal(np.asarray(ctrl[k]),
                                      plain["model.diffusion_model." + k])
    for k in ("zero_convs.0.0.weight", "zero_convs.3.0.bias",
              "middle_block_out.0.weight", "input_hint_block.14.weight"):
        assert not np.asarray(ctrl[k]).any(), k
    assert np.asarray(ctrl["input_hint_block.0.weight"]).any()
    # the grafted branch loads into the port's ControlNet
    assert TLDM.ldm_to_state_dicts(got)["controlnet"] is not None
