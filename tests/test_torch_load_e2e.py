"""Checkpoint files on disk -> the port's loaders -> an edit, against the
JAX package's loaders and editor on the same files.

The files are tests/test_load_e2e.py's (its ``files`` fixture: a tiny
diffusers UNet, VAE, HF CLIP text tower with its ``position_ids`` buffer,
two ControlNets, an HF-layout safety checker, an official-layout SAM
``.pth``, a kohya LoRA and a diffusers TI ``.bin``) and
tests/test_ldm_ingest.py's (its ``cldm_ckpt``: a tiny cldm ``.ckpt`` with an
open_clip text tower, and its YAML). One ``process`` request through each
side loads the bundle with the LoRA merged at 0.5 and the checker on,
builds the ID map with the loaded SAM, swaps the "sam" ControlNet for the
second file, appends the TI embedding whose placeholder is in the prompt,
and captures its inputs (``EA_SAVE_INPUTS=1``); the ldm bundle runs one
edit. The JAX side runs on its plain references, and every random draw is
its own, handed to the port. Tolerances, those of tests/test_torch_edit.py:
final latents 1e-3 absolute, images 2 uint8 levels; the ID maps equal
except where an upscaled logit lies within 1e-5 of the threshold
(tests/test_torch_editor.py); the safety flags equal.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from editanything_tpu.checkpoints import ldm as JLDM
from editanything_tpu.checkpoints.convert import (load_torch_state_dict,
                                                  sam_to_tree)
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import safety as JS
from editanything_tpu.perception import amg as JA
from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines.bundle import load_bundle as jax_load_bundle
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu_torch.checkpoints import ldm as TLDM
from editanything_tpu_torch.models import safety as TS
from editanything_tpu_torch.perception import amg as TA
from editanything_tpu_torch.pipelines.bundle import load_bundle, load_sam
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.text.tokenizer import tiny_tokenizer

from test_ldm_ingest import (CN_CFG as LDM_CN_CFG, UNET_CFG as LDM_UNET_CFG,
                             VAE_CFG as LDM_VAE_CFG, _tiny_text_cfg,
                             cldm_ckpt)  # noqa: F401  (fixture)
from test_load_e2e import (CN_CFG, SAM_CFG, UNET_CFG, VAE_CFG,  # noqa: F401
                           files)
from test_torch_edit_modes import _decode, jax_draws
from test_torch_editor import AMG, _near_threshold
from test_torch_models import port_cfg
from test_torch_sam import port_sam_cfg

LATENT_TOL = 1e-3
IMAGE_LEVELS = 2
SEED = 3
STEPS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _text_cfg(tok):
    from editanything_tpu.models import config as JC
    return JC.CLIPTextConfig(
        vocab_size=len(tok.encoder), hidden_size=48, intermediate_size=96,
        num_layers=2, num_heads=4, max_position_embeddings=16,
        eos_token_id=tok.eos_id)


def _request():
    rng = np.random.RandomState(0)
    ref_mask = np.zeros((64, 64), np.uint8)
    ref_mask[8:40, 20:60] = 255
    return dict(image=rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
                mask=(np.mgrid[0:64, 0:64][0] > 32).astype(np.uint8) * 255,
                prompt="a photo of <new-obj> cat", n_prompt="dog",
                num_samples=2, image_resolution=64, detect_resolution=64,
                ddim_steps=STEPS, seed=SEED,
                ref_image=rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
                ref_mask=ref_mask, ref_textinv=True)


def _pipe_args(req, cond):
    """EditPipeline arguments of the edit ``process`` ran for `req`."""
    return dict(image=req["image"], mask=req["mask"], prompt=req["prompt"],
                negative_prompt=req["n_prompt"], condition_image=cond,
                num_samples=2, image_resolution=64, num_steps=STEPS,
                guidance_scale=9.0, control_scale=0.5, seed=SEED,
                ref_image=req["ref_image"],
                ref_mask=req["ref_mask"])


def test_loaded_files_process_matches_jax(files, tmp_path, monkeypatch):
    paths, sds, tok = files
    jb = jax_load_bundle(
        unet_path=paths["unet"], vae_path=paths["vae"],
        text_path=paths["text"], tokenizer=tok,
        controlnet_paths={"sam": paths["cn_sam"],
                          "inpaint": paths["cn_inpaint"]},
        unet_cfg=UNET_CFG, vae_cfg=VAE_CFG, text_cfg=_text_cfg(tok),
        controlnet_cfg=CN_CFG, safety_path=paths["safety"],
        safety_cfg=JS.tiny_vision_config(),
        lora_specs=[(paths["lora"], 0.5)], dtype=jnp.float32)
    jed = JaxEditor(jb, sam=(SAM_CFG, sam_to_tree(
        load_torch_state_dict(paths["sam"]))), tile_control="none",
        amg_config=JA.AMGConfig(**AMG))
    ttok = tiny_tokenizer(context_length=16)
    tb = load_bundle(
        unet_path=paths["unet"], vae_path=paths["vae"],
        text_path=paths["text"], tokenizer=ttok,
        controlnet_paths={"sam": paths["cn_sam"],
                          "inpaint": paths["cn_inpaint"]},
        unet_cfg=port_cfg(UNET_CFG), vae_cfg=port_cfg(VAE_CFG),
        text_cfg=port_cfg(_text_cfg(tok)), controlnet_cfg=port_cfg(CN_CFG),
        safety_path=paths["safety"], safety_cfg=TS.tiny_vision_config(),
        lora_specs=[(paths["lora"], 0.5)], dtype=torch.float32, device="cpu")
    sam_cfg = port_sam_cfg(SAM_CFG)
    ted = EditAnythingEditor(tb, sam=(sam_cfg, load_sam(
        paths["sam"], sam_cfg, device="cpu")), tile_control="none",
        amg_config=TA.AMGConfig(**AMG))
    inpaint = {k: v.clone() for k, v in
               tb.controlnets["inpaint"][1].state_dict().items()}
    req = _request()
    swap = dict(condition_model=paths["cn_inpaint"],
                ref_textinv_path=paths["ti_bin"])
    monkeypatch.setenv("EA_SAVE_INPUTS", "1")
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    _, want, (want_cond, _), _ = jed.process(**req, **swap)
    monkeypatch.chdir(tmp_path / "port")
    draws = jax_draws((2, 8, 8, 4), STEPS, SEED)
    _, got, (got_cond, _), _ = ted.process(**req, **swap, **draws)

    # what loaded, swapped and registered
    assert ted.current_condition_model == paths["cn_inpaint"]
    for k, v in tb.controlnets["sam"][1].state_dict().items():
        assert torch.equal(v, torch.from_numpy(sds["cn_inpaint"][k])), k
    for k, v in tb.controlnets["inpaint"][1].state_dict().items():
        assert torch.equal(v, inpaint[k]), k
    v0 = len(tok.encoder)
    assert ttok.placeholders == jb.tokenizer.placeholders == {
        "<new-obj>": [v0, v0 + 1]}
    np.testing.assert_array_equal(
        tb.text.embeddings.token_embedding.weight[v0:].detach().numpy(),
        sds["ti"])

    # the request: ID map, flags, images and, through the same edit, latents
    near = _near_threshold(jed, req["image"])
    np.testing.assert_array_equal(got_cond[~near], want_cond[~near])
    assert ted.pipe.last_nsfw.tolist() == jed.pipe.last_nsfw.tolist()
    diff = np.abs(np.stack(got).astype(np.int32)
                  - np.stack(want).astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and ted.last_nonfinite == 0
    want_lat = np.asarray(jed.pipe(**_pipe_args(req, want_cond),
                                   return_latents=True))
    got_lat = ted.pipe(**_pipe_args(req, want_cond), return_latents=True,
                       noise=draws["noise"])
    assert np.abs(want_lat).max() > 0.1
    np.testing.assert_allclose(got_lat, want_lat, atol=LATENT_TOL, rtol=0)

    # EA_SAVE_INPUTS: the same keys and values
    captured = [pickle.load(open(tmp_path / side / "input_data.pkl", "rb"))
                for side in ("jax", "port")]
    assert captured[0]["args"] == captured[1]["args"] == ()
    assert captured[0]["kwargs"].keys() == captured[1]["kwargs"].keys()
    for k, v in captured[0]["kwargs"].items():
        np.testing.assert_array_equal(np.asarray(captured[1]["kwargs"][k]),
                                      np.asarray(v), err_msg=k)


def test_ldm_bundle_edit_matches_jax(cldm_ckpt):
    ckpt, yaml_path, tok, _, _ = cldm_ckpt
    jb, _ = JLDM.load_ldm_bundle(
        yaml_path, ckpt, tokenizer=tok, control_name="sam",
        dtype=jnp.float32,
        overrides={"unet": LDM_UNET_CFG, "vae": LDM_VAE_CFG,
                   "text": _tiny_text_cfg(tok), "controlnet": LDM_CN_CFG})
    tb, cfgs = TLDM.load_ldm_bundle(
        yaml_path, ckpt, tokenizer=tiny_tokenizer(context_length=16),
        dtype=torch.float32, device="cpu",
        overrides={"unet": port_cfg(LDM_UNET_CFG),
                   "vae": port_cfg(LDM_VAE_CFG),
                   "text": port_cfg(_tiny_text_cfg(tok)),
                   "controlnet": port_cfg(LDM_CN_CFG)})
    assert cfgs["schedule"].prediction_type == "epsilon"
    assert list(tb.controlnets) == ["sam"] and tb.safety is None
    rng = np.random.RandomState(0)
    kw = dict(image=rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
              mask=(np.mgrid[0:64, 0:64][0] > 32).astype(np.uint8) * 255,
              prompt="a photo of a cat",
              condition_image=rng.randint(0, 255, (64, 64, 3)).astype(np.uint8),
              num_samples=1, image_resolution=64, num_steps=STEPS, seed=SEED)
    want_lat = np.asarray(JaxEditPipeline(jb, controls=("sam",))(
        **kw, return_latents=True))
    draws = jax_draws((1, 8, 8, 4), STEPS, SEED)
    pipe = EditPipeline(tb, controls=("sam",))
    got_lat = pipe(**kw, return_latents=True, noise=draws["noise"])
    got = pipe(**kw, noise=draws["noise"])
    assert np.abs(want_lat).max() > 0.1
    np.testing.assert_allclose(got_lat, want_lat, atol=LATENT_TOL, rtol=0)
    diff = np.abs(got.astype(np.int32) - _decode(jb, want_lat).astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and pipe.last_nonfinite == 0


def test_textinv_stage_writes_the_crop(tmp_path):
    """Without an embedding file the masked crop is staged as ref.png,
    which PIL reads back as the crop."""
    rng = np.random.RandomState(1)
    ref = rng.randint(0, 255, (40, 56, 3)).astype(np.uint8)
    mask = np.zeros((40, 56), np.uint8)
    mask[5:30, 9:50] = 255
    mask[12, 20] = 0
    crop = EditAnythingEditor._crop_masked_region(ref, mask)
    assert crop.shape == (25, 41, 3) and not crop[7, 11].any()
    editor = EditAnythingEditor.__new__(EditAnythingEditor)
    editor.textinv_stage_dir = str(tmp_path / "stage")
    assert not editor._load_or_stage_textinv(crop, str(tmp_path / "none.bin"))
    staged = np.asarray(Image.open(tmp_path / "stage" / "ref.png"))
    np.testing.assert_array_equal(staged, crop)
    np.testing.assert_array_equal(
        crop, JaxEditor._crop_masked_region(ref, mask))


def test_loading_imports_neither_jax_pil_safetensors_nor_yaml():
    """Every file family written and loaded, then a tiny process on the
    CPU, in a fresh interpreter: no module of jax, the JAX package, PIL,
    safetensors or yaml is loaded."""
    code = r'''
import os, sys, tempfile
import numpy as np, torch
from editanything_tpu_torch.checkpoints import ldm as LDM
from editanything_tpu_torch.checkpoints.safetensors_io import save_file
from editanything_tpu_torch.models.safety import tiny_vision_config
from editanything_tpu_torch.models.sam import SAMConfig
from editanything_tpu_torch.perception import AMGConfig
from editanything_tpu_torch.pipelines.bundle import (
    load_bundle, load_sam, random_bundle, random_safety_checker, random_sam)
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
d = tempfile.mkdtemp()
b = random_bundle(tiny=True, device="cpu")
other = random_bundle(tiny=True, device="cpu",
                      generator=torch.Generator().manual_seed(5))
p = lambda name: os.path.join(d, name)
save_file(b.unet.state_dict(), p("unet.safetensors"))
save_file(b.vae.state_dict(), p("vae.safetensors"))
save_file({"text_model." + k: v for k, v in b.text.state_dict().items()},
          p("text.safetensors"))
for name, (_, net) in b.controlnets.items():
    save_file(net.state_dict(), p(name + ".safetensors"))
save_file(other.controlnets["sam"][1].state_dict(), p("swap.safetensors"))
checker = random_safety_checker(tiny_vision_config(), device="cpu").model
save_file({("vision_model." + k if k.startswith("vision_model.") else k): v
           for k, v in checker.state_dict().items()}, p("safety.safetensors"))
save_file({"lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.lora_up.weight": torch.ones(32, 2),
           "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.lora_down.weight": torch.ones(2, 32),
           "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q.alpha": torch.tensor(1.0)},
          p("lora.safetensors"))
torch.save({"<new-obj>": torch.randn(2, 32)}, p("ti.bin"))
cfg = SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                global_attn_indexes=(1,), window_size=4, out_chans=16,
                prompt_embed_dim=16, decoder_mlp_dim=32)
torch.save(random_sam(cfg, device="cpu").state_dict(), p("sam.pth"))
torch.save({"state_dict": LDM.state_dicts_to_ldm(
    unet=b.unet.state_dict(), vae=b.vae.state_dict(),
    text=b.text.state_dict())}, p("sd.ckpt"))
ldm_config = {"model": {"params": {"unet_config": {"params": {
    "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
    "context_dim": 32, "num_heads": 2}}}}}
lb, _ = LDM.load_ldm_bundle(
    ldm_config, p("sd.ckpt"), tokenizer=b.tokenizer, dtype=torch.float32,
    device="cpu", overrides={"unet": b.unet_cfg, "vae": b.vae_cfg,
                             "text": b.text_cfg},
    controlnet_paths={"sam": p("sam.safetensors")})
assert lb.unet.conv_in.weight.shape == b.unet.conv_in.weight.shape
bundle = load_bundle(
    unet_path=p("unet.safetensors"), vae_path=p("vae.safetensors"),
    text_path=p("text.safetensors"), tokenizer=b.tokenizer,
    controlnet_paths={n: p(n + ".safetensors") for n in b.controlnets},
    unet_cfg=b.unet_cfg, vae_cfg=b.vae_cfg, text_cfg=b.text_cfg,
    safety_path=p("safety.safetensors"), safety_cfg=tiny_vision_config(),
    lora_specs=[(p("lora.safetensors"), 0.5)], dtype=torch.float32,
    device="cpu")
ed = EditAnythingEditor(bundle, sam=(cfg, load_sam(p("sam.pth"), cfg,
                                                   device="cpu")),
                        amg_config=AMGConfig(points_per_side=4,
                                             points_per_batch=16))
img = np.random.RandomState(0).randint(0, 255, (64, 64, 3)).astype(np.uint8)
mask = np.zeros((64, 64), np.uint8)
mask[10:50, 10:50] = 255
_, out, (cond, _), _ = ed.process(
    image=img, mask=None, prompt="a photo of <new-obj>", image_resolution=64,
    detect_resolution=64, ddim_steps=1, condition_model=p("swap.safetensors"),
    ref_image=img, ref_mask=mask, ref_textinv=True, ref_textinv_path=p("ti.bin"))
assert out[0].shape == (64, 64, 3) and len(ed.pipe.last_nsfw) == 1
assert [c["merged"] for _, _, c in bundle.lora_counts] == [1]
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "PIL", "editanything_tpu", "safetensors", "yaml"))
assert not bad, bad
'''
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
