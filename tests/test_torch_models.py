"""The port's models (editanything_tpu_torch.models) against the JAX
package's, with the same weights: JAX parameter trees at the widths of
``random_bundle(tiny=True)`` carried across by ``state_dict_from_tree`` and
loaded with strict=True. The JAX side runs its Pallas kernels in interpret
mode (conftest).

Norm scales/biases are drawn away from their identity init, and the
ControlNet zero convs (zero at init) are filled with seeded values, so the
affine and residual paths carry signal.

Tolerances: 2e-4 absolute (relative to outputs of magnitude ~1-10) for the
deep stacks (UNet, ControlNet, VAE: dozens of fp32 convs, norms and
attentions summed in other orders on each side), 1e-4 for single blocks
and the CLIP tower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.checkpoints.convert import state_dict_to_tree
from editanything_tpu.models import blocks as JB
from editanything_tpu.models import clip_text as JCT
from editanything_tpu.models import config as JC
from editanything_tpu.models import controlnet as JCN
from editanything_tpu.models import unet as JU
from editanything_tpu.models import vae as JV
from editanything_tpu.pipelines.bundle import random_bundle as jax_random_bundle
from editanything_tpu.text import tokenizer as JT
from editanything_tpu_torch.checkpoints.convert import state_dict_from_tree
from editanything_tpu_torch.core import kernels as tk
from editanything_tpu_torch.models import blocks as TB
from editanything_tpu_torch.models import config as TC
from editanything_tpu_torch.models import controlnet as TCN
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vae import AutoencoderKL
from editanything_tpu_torch.pipelines.bundle import module_from_tree
from editanything_tpu_torch.text import tokenizer as TT

DEEP_TOL = 2e-4
BLOCK_TOL = 1e-4


def port_cfg(jcfg):
    """A JAX-package config as the port's config of the same name."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if "unet" in kw:
        kw["unet"] = port_cfg(kw["unet"])
    return getattr(TC, type(jcfg).__name__)(**kw)


def perturb(tree, seed):
    """Norm scales ~1 +- 0.2 and biases ~+-0.1 instead of the 1/0 init."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (walk(v) if isinstance(v, dict) else
                        v + 0.2 * rng.standard_normal(v.shape, np.float32)
                        if k == "scale" else
                        0.1 * rng.standard_normal(v.shape, np.float32)
                        if k == "bias" else np.asarray(v))
                    for k, v in node.items()}
        return node
    return walk(tree)


def fill_zero_convs(tree, seed):
    rng = np.random.default_rng(seed)
    tree = dict(tree)

    def conv(p):
        k = np.asarray(p["kernel"])
        fan_in = k.shape[0] * k.shape[1] * k.shape[2]
        bound = np.float32(1.0 / np.sqrt(fan_in))
        return {"kernel": rng.uniform(-bound, bound, k.shape).astype(np.float32),
                "bias": 0.1 * rng.standard_normal(k.shape[-1], np.float32)}
    emb = dict(tree["controlnet_cond_embedding"])
    emb["conv_out"] = conv(emb["conv_out"])
    tree["controlnet_cond_embedding"] = emb
    tree["controlnet_down_blocks"] = {
        k: conv(v) for k, v in tree["controlnet_down_blocks"].items()}
    tree["controlnet_mid_block"] = conv(tree["controlnet_mid_block"])
    return tree


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def close(got, want, tol):
    got = got.detach()
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def jbundle():
    b = jax_random_bundle(jax.random.PRNGKey(42), tiny=True,
                          dtype=jnp.float32)
    b.unet = perturb(b.unet, 1)
    b.vae = perturb(b.vae, 2)
    b.text = perturb(b.text, 3)
    b.controlnets = {
        name: (cfg, fill_zero_convs(perturb(tree, 10 + i), 20 + i))
        for i, (name, (cfg, tree)) in enumerate(b.controlnets.items())}
    return b


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "sample": rng.standard_normal((2, 8, 8, 4), np.float32),
        "t": np.array([999, 500], np.int32),
        "context": rng.standard_normal((2, 8, 32), np.float32),
        "cond": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
        "image": rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32),
        "ids": rng.integers(0, 2000, (2, 8)).astype(np.int32),
    }


# --- configs ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["UNetConfig", "ControlNetConfig",
                                  "VAEConfig", "CLIPTextConfig"])
def test_config_mirrors_jax(name):
    jcls, tcls = getattr(JC, name), getattr(TC, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert jf == tf
    assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
    assert dataclasses.asdict(JC.sd15_unet()) == dataclasses.asdict(TC.sd15_unet())
    assert dataclasses.asdict(JC.clip_vit_l()) == dataclasses.asdict(TC.clip_vit_l())
    for fn in ("sd15_inpaint_unet", "sd21_unet", "openclip_vit_h"):
        assert (dataclasses.asdict(getattr(JC, fn)())
                == dataclasses.asdict(getattr(TC, fn)())), fn
    assert JC.UNetConfig().time_embed_dim == TC.UNetConfig().time_embed_dim
    assert JC.CLIPTextConfig().head_dim == TC.CLIPTextConfig().head_dim


# --- blocks -----------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,temb,eps", [(16, 32, 64, 1e-5),
                                               (32, 32, None, 1e-6)])
def test_resnet_block_matches_jax(cin, cout, temb, eps):
    params = perturb(JB.init_resnet_block(jax.random.PRNGKey(1), cin, cout,
                                          temb), 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, cin), np.float32)
    t = rng.standard_normal((2, temb), np.float32) if temb else None
    want = JB.resnet_block(params, jnp.asarray(x),
                           None if t is None else jnp.asarray(t),
                           num_groups=8, eps=eps)
    blk = TB.ResnetBlock2D(cin, cout, temb, num_groups=8, eps=eps)
    blk.load_state_dict(state_dict_from_tree(params), strict=True)
    got = blk(nchw(x), None if t is None else torch.from_numpy(t))
    close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("use_linear", [False, True])
def test_spatial_transformer_matches_jax(use_linear):
    params = perturb(JB.init_spatial_transformer(
        jax.random.PRNGKey(2), 32, 24, use_linear=use_linear), 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 32), np.float32)
    ctx = rng.standard_normal((2, 5, 24), np.float32)
    want = JB.spatial_transformer(params, jnp.asarray(x), jnp.asarray(ctx),
                                  heads=2, use_linear=use_linear, num_groups=8)
    blk = TB.Transformer2DModel(32, 24, heads=2, use_linear=use_linear,
                                num_groups=8)
    blk.load_state_dict(state_dict_from_tree(params), strict=True)
    tctx = torch.from_numpy(ctx)
    close(blk(nchw(x), tctx), want, BLOCK_TOL)
    close(blk(nchw(x), tctx, kv=blk.context_kv(tctx)), want, BLOCK_TOL)


def test_vae_attention_matches_jax():
    params = perturb(JB.init_vae_attention(jax.random.PRNGKey(3), 32), 8)
    x = np.random.default_rng(9).standard_normal((2, 4, 4, 32), np.float32)
    want = JB.vae_attention(params, jnp.asarray(x), num_groups=8)
    blk = TB.VAEAttention(32, num_groups=8)
    blk.load_state_dict(state_dict_from_tree(params), strict=True)
    close(blk(nchw(x)), want, BLOCK_TOL)


# --- whole models -----------------------------------------------------------

def test_unet_matches_jax(jbundle, inputs):
    want = JU.apply(jbundle.unet, jbundle.unet_cfg,
                    jnp.asarray(inputs["sample"]), jnp.asarray(inputs["t"]),
                    jnp.asarray(inputs["context"]))
    unet = module_from_tree(UNet2DConditionModel, port_cfg(jbundle.unet_cfg),
                            jbundle.unet)
    ctx = torch.from_numpy(inputs["context"])
    got = unet(nchw(inputs["sample"]), torch.from_numpy(inputs["t"]), ctx,
               ctx_kv=unet.context_kv(ctx))
    close(got, want, DEEP_TOL)


def test_controlnets_and_unet_with_residuals_match_jax(jbundle, inputs):
    names = ("sam", "inpaint")
    jparams = [jbundle.controlnets[n][1] for n in names]
    jcfgs = [jbundle.controlnets[n][0] for n in names]
    sample = jnp.asarray(inputs["sample"])
    t, ctx = jnp.asarray(inputs["t"]), jnp.asarray(inputs["context"])
    cond = jnp.asarray(inputs["cond"])
    jdown, jmid = JCN.multi_controlnet_apply(jparams, jcfgs, sample, t, ctx,
                                             [cond, cond], [0.5, 1.0])
    jout = JU.apply(jbundle.unet, jbundle.unet_cfg, sample, t, ctx,
                    down_block_residuals=jdown, mid_block_residual=jmid)

    nets = [module_from_tree(ControlNetModel, port_cfg(c), p)
            for c, p in zip(jcfgs, jparams)]
    unet = module_from_tree(UNet2DConditionModel, port_cfg(jbundle.unet_cfg),
                            jbundle.unet)
    ts, tctx, tcond = (torch.from_numpy(inputs["t"]),
                       torch.from_numpy(inputs["context"]),
                       nchw(inputs["cond"]))
    tsample = nchw(inputs["sample"])
    # one net from the raw condition, one from a precomputed hint + K/V
    down, mid = TCN.multi_controlnet_apply(
        nets, tsample, ts, tctx, [tcond, None], [0.5, 1.0],
        hint_embeddings=[None, nets[1].hint_embedding(tcond)],
        ctx_kvs=[None, nets[1].context_kv(tctx)])
    assert len(down) == len(jdown)
    for got, want in zip(down, jdown):
        close(got, want, DEEP_TOL)
    close(mid, jmid, DEEP_TOL)
    assert float(np.abs(np.asarray(jmid)).max()) > 1e-2  # residuals are live
    out = unet(tsample, ts, tctx, down_block_residuals=down,
               mid_block_residual=mid)
    close(out, jout, DEEP_TOL)


def test_vae_encode_decode_match_jax(jbundle, inputs):
    jcfg = jbundle.vae_cfg
    x = jnp.asarray(inputs["image"])
    post = JV.encode(jbundle.vae, jcfg, x)
    jlat = JV.encode_to_latents(jbundle.vae, jcfg, x)
    jimg = JV.decode_from_latents(jbundle.vae, jcfg, jlat)
    vae = module_from_tree(AutoencoderKL, port_cfg(jcfg), jbundle.vae)
    tpost = vae.encode(nchw(inputs["image"]))
    close(tpost.mean, post.mean, DEEP_TOL)
    close(tpost.logvar, post.logvar, DEEP_TOL)
    tlat = vae.encode_to_latents(nchw(inputs["image"]))
    close(tlat, jlat, DEEP_TOL)
    close(vae.decode_from_latents(nchw(jlat)), jimg, DEEP_TOL)


@pytest.mark.parametrize("layer_skip", [0, 1])
def test_clip_text_matches_jax(jbundle, inputs, layer_skip):
    want = JCT.apply(jbundle.text, jbundle.text_cfg,
                     jnp.asarray(inputs["ids"]), layer_skip=layer_skip)
    text = module_from_tree(CLIPTextModel, port_cfg(jbundle.text_cfg),
                            jbundle.text)
    got = text(torch.from_numpy(inputs["ids"]).long(), layer_skip=layer_skip)
    close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("text", [
    "a photo of a cat", "  A  PHOTO of a dog, it's 3 &amp; 4 cats!  ", "",
    "photograph of cathedral dogs", "caf\u00e9 \u732b <|endoftext|> x"])
def test_tokenizer_matches_jax(text):
    words = ("photo", "of", "a", "cat", "dog", "graph")
    for kw in ({}, {"words": words, "context_length": 8}):
        want, got = JT.tiny_tokenizer(**kw), TT.tiny_tokenizer(**kw)
        assert got.encode(text) == want.encode(text)
        assert (got.bos_id, got.eos_id, got.context_length) == (
            want.bos_id, want.eos_id, want.context_length)


# --- SD2.1 traits and the inpainting UNet -----------------------------------

SD21_TINY = dict(block_out_channels=(32, 64), layers_per_block=1,
                 cross_attention_dim=48, attention_head_dim=(2, 4),
                 use_linear_projection=True,
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 norm_num_groups=8)


@pytest.mark.parametrize("variant", ["sd21_linear", "inpaint_9ch"])
def test_unet_variants_load_strictly_and_match_jax(jbundle, variant):
    """SD2.1's linear proj_in/proj_out (2-D kernels where SD1.5 has 1x1
    convs) and the inpainting UNet's 9-channel conv_in load from JAX trees
    with strict=True and compute what the JAX UNet computes (the SD2.1
    ControlNets: tests/test_torch_edit_modes.py)."""
    rng = np.random.default_rng(31)
    if variant == "sd21_linear":
        jcfg = JC.UNetConfig(**SD21_TINY)
        c_in, ctx_dim = 4, 48
    else:
        jcfg = dataclasses.replace(jbundle.unet_cfg, in_channels=9)
        c_in, ctx_dim = 9, 32
    tree = perturb(JU.init_unet(jax.random.PRNGKey(30), jcfg, jnp.float32), 32)
    sample = rng.standard_normal((2, 8, 8, c_in), np.float32)
    t = np.array([999, 250], np.int32)
    ctx = rng.standard_normal((2, 8, ctx_dim), np.float32)
    want = JU.apply(tree, jcfg, jnp.asarray(sample), jnp.asarray(t),
                    jnp.asarray(ctx))
    unet = module_from_tree(UNet2DConditionModel, port_cfg(jcfg), tree)
    if variant == "sd21_linear":
        proj = unet.down_blocks[0].attentions[0].proj_in
        assert isinstance(proj, torch.nn.Linear)
    else:
        assert unet.conv_in.weight.shape[1] == 9
    close(unet(nchw(sample), torch.from_numpy(t), torch.from_numpy(ctx)),
          want, DEEP_TOL)


def test_gelu_text_tower_matches_jax():
    """The OpenCLIP-H tower's traits at test width: gelu, 16 heads (of
    width 4 here), several layers, the final LayerNorm on the last."""
    jcfg = JC.CLIPTextConfig(vocab_size=500, hidden_size=64,
                             intermediate_size=256, num_layers=3,
                             num_heads=16, max_position_embeddings=8,
                             hidden_act="gelu")
    tree = perturb(JCT.init_clip_text(jax.random.PRNGKey(36), jcfg,
                                      jnp.float32), 37)
    ids = np.random.default_rng(38).integers(0, 500, (2, 8)).astype(np.int32)
    want = JCT.apply(tree, jcfg, jnp.asarray(ids))
    text = module_from_tree(CLIPTextModel, port_cfg(jcfg), tree)
    close(text(torch.from_numpy(ids).long()), want, BLOCK_TOL)


# --- weights round trip -----------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("which", ["unet", "controlnet", "vae", "text"])
def test_state_dict_round_trips_to_jax_tree(jbundle, which):
    if which == "controlnet":
        cfg, tree = jbundle.controlnets["sam"]
        cls, kw = ControlNetModel, {}
    else:
        cfg = getattr(jbundle, f"{which}_cfg")
        tree = getattr(jbundle, which)
        cls = {"unet": UNet2DConditionModel, "vae": AutoencoderKL,
               "text": CLIPTextModel}[which]
        kw = ({"embedding_modules": ("token_embedding", "position_embedding")}
              if which == "text" else {})
    module = module_from_tree(cls, port_cfg(cfg), tree)
    back = _flat(state_dict_to_tree(module.state_dict(), **kw))
    want = _flat(tree)
    assert sorted(back) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


# ---- memory layout (models/layout.py) --------------------------------------
# The same tiny models with every conv weight channels-last and channels-last
# inputs give the contiguous models' outputs: fp32 sums of the convs taken in
# other orders, 1e-5 absolute on outputs of magnitude ~1 (measured ~2e-6 for
# the UNet and 1e-5 for the VAE decoder's deeper stack).
LAYOUT_TOL = 1e-4


def _channels_last_copy(module):
    import copy
    from editanything_tpu_torch.models import layout
    out = copy.deepcopy(module)
    for m in out.modules():
        if isinstance(m, torch.nn.Conv2d):
            layout.relayout_(m.weight, True)
    return out


@pytest.fixture(scope="module")
def tiny_port_bundle():
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    return random_bundle(tiny=True, device="cpu", dtype=torch.float32,
                         controlnet_names=("sam",))


def test_unet_and_controlnet_match_in_channels_last(tiny_port_bundle):
    b = tiny_port_bundle
    unet, cn = b.unet, b.controlnets["sam"][1]
    unet_cl, cn_cl = _channels_last_copy(unet), _channels_last_copy(cn)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 16, 16, generator=g)
    ctx = torch.randn(2, 8, 32, generator=g)
    hint = torch.rand(2, 3, 128, 128, generator=g)
    t = torch.tensor([500, 20])
    cl = torch.channels_last
    with torch.no_grad():
        down, mid = cn(x, t, ctx, hint)
        want = unet(x, t, ctx, down_block_residuals=down,
                    mid_block_residual=mid)
        down_cl, mid_cl = cn_cl(x.contiguous(memory_format=cl), t, ctx,
                                hint.contiguous(memory_format=cl))
        got = unet_cl(x.contiguous(memory_format=cl), t, ctx,
                      down_block_residuals=down_cl, mid_block_residual=mid_cl)
    assert tk.is_channels_last(got)
    for a, c in zip(down + (mid,), down_cl + (mid_cl,)):
        assert (a - c).abs().max().item() <= LAYOUT_TOL
    assert (got - want).abs().max().item() <= LAYOUT_TOL


def test_vae_matches_in_channels_last(tiny_port_bundle):
    vae = tiny_port_bundle.vae
    vae_cl = _channels_last_copy(vae)
    g = torch.Generator().manual_seed(1)
    z = torch.randn(1, 4, 8, 8, generator=g)
    img = torch.rand(1, 3, 64, 64, generator=g) * 2 - 1
    cl = torch.channels_last
    with torch.no_grad():
        dec, dec_cl = vae.decode(z), vae_cl.decode(z.contiguous(memory_format=cl))
        enc = vae.encode(img)
        enc_cl = vae_cl.encode(img.contiguous(memory_format=cl))
    assert tk.is_channels_last(dec_cl)
    assert (dec - dec_cl).abs().max().item() <= LAYOUT_TOL
    for a, c in zip(enc, enc_cl):
        assert (a - c).abs().max().item() <= LAYOUT_TOL


@pytest.mark.parametrize("shape", [(6, 5, 3, 3), (8, 4, 1, 1), (4, 1, 3, 3)])
def test_relayout_keeps_storage_and_values(shape):
    """A conv weight relaid in place, both ways: the same ``data_ptr()``,
    the same values, the canonical strides of the layout; a view of a
    larger buffer (a state dict loaded by assignment) leaves its
    neighbours as they were."""
    from editanything_tpu_torch.models import layout
    buf = torch.randn(2 * int(np.prod(shape)) + 3,
                      generator=torch.Generator().manual_seed(2))
    ref = buf.clone()
    n = int(np.prod(shape))
    p = torch.nn.Parameter(buf[3:3 + n].view(shape))
    want = p.detach().clone()
    ptr = p.data_ptr()
    for cl in (True, False):
        assert layout.relayout_(p, cl)
        assert p.data_ptr() == ptr and torch.equal(p.detach(), want)
        fmt = torch.channels_last if cl else torch.contiguous_format
        assert p.is_contiguous(memory_format=fmt)
        assert not layout.relayout_(p, cl)
    assert torch.equal(buf[:3], ref[:3]) and torch.equal(buf[3 + n:],
                                                         ref[3 + n:])


@pytest.mark.parametrize("dtype,device_type,want", [
    (torch.bfloat16, "cuda", True), (torch.float16, "cuda", True),
    (torch.float32, "cuda", False), (torch.bfloat16, "cpu", False),
    (torch.float16, "cpu", False), (torch.bfloat16, "meta", False),
    (torch.float32, "meta", False)])
def test_layout_rule_is_half_precision_on_cuda(dtype, device_type, want):
    from editanything_tpu_torch.models import layout
    assert layout.channels_last_for(dtype, device_type) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bundle_keeps_meta_cpu_and_fp32_weights_nchw(dtype):
    """A bundle built on the meta device or the CPU, in fp32 or bf16, holds
    every conv weight NCHW; a weight laid channels-last by hand goes back to
    NCHW when the bundle moves, in its own storage."""
    from editanything_tpu_torch.models import layout
    from editanything_tpu_torch.pipelines.bundle import (ModelBundle,
                                                         random_bundle)
    cpu = random_bundle(tiny=True, device="cpu", dtype=dtype,
                        controlnet_names=("sam",))
    meta = ModelBundle(
        unet_cfg=cpu.unet_cfg, vae_cfg=cpu.vae_cfg, text_cfg=cpu.text_cfg,
        unet=UNet2DConditionModel(cpu.unet_cfg).to("meta", dtype),
        vae=AutoencoderKL(cpu.vae_cfg).to("meta", dtype), text=cpu.text,
        tokenizer=cpu.tokenizer,
        controlnets={"sam": (cpu.controlnets["sam"][0], ControlNetModel(
            cpu.controlnets["sam"][0]).to("meta", dtype))}, dtype=dtype)

    def convs(bundle):
        return [m.weight for net in (bundle.unet, bundle.vae,
                                     bundle.controlnets["sam"][1])
                for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    for bundle in (cpu, meta):
        assert all(w.is_contiguous() and w.stride() == layout._strides(
            w.shape, False) for w in convs(bundle))
    w = cpu.unet.conv_in.weight
    ptr, want = w.data_ptr(), w.detach().clone()
    layout.relayout_(w, True)
    assert not w.is_contiguous()
    cpu.to("cpu")
    w = cpu.unet.conv_in.weight
    assert w.is_contiguous() and w.data_ptr() == ptr
    assert torch.equal(w.detach(), want)
