"""The port's apps against the JAX package's: the command line, the
reference-call mapping, the Gradio UI's graph and the combined editors.

- ``reference_call_to_kwargs`` and ``is_reference_capture`` give what JAX's
  give on the cases of tests/test_editor.py:239-330.
- The UI: tests/test_ui.py's five graph tests on ``apps/ui.py``, through
  tests/fake_gradio.py, so they run without gradio installed.
- ``edit`` from a spec of files against JAX's CLI on the same files
  (tests/test_load_e2e.py's: a tiny diffusers UNet, VAE, HF text tower, two
  ControlNets, an HF safety checker, an official SAM ``.pth``, a kohya
  LoRA), JAX's configs and AMG points patched in where its CLI hard-codes
  them, the initial latents JAX's: the images within 2 uint8 levels.
- ``add-control``, ``transfer-control`` and ``convert-to-diffusers`` on
  tests/test_ldm_ingest.py's cldm file against JAX's CLI: the same keys,
  equal tensors (``add-control``'s freshly drawn hint convs aside: each
  package draws them from its own generator).
- Every other subcommand equal to the port's direct API call on the same
  files: ``generate``, ``sketch``, ``semantic``, ``replay``, ``text-edit``
  (GroundingDINO and VLPart), ``caption-data`` (BLIP-2),
  ``train-dreambooth --bundle-spec`` (a 9-channel UNet file), and
  ``train-controlnet`` / ``train-ti`` handing their trainers what their own
  ``main``s hand them.
"""

import dataclasses
import functools
import importlib
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import editanything_tpu.models.sam as JSAM
import editanything_tpu.pipelines as JP
import editanything_tpu.pipelines.editor as JED
import editanything_tpu.text.tokenizer as JTOK
import fake_gradio
from editanything_tpu.apps import cli as jcli
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import safety as JS
from editanything_tpu.perception import amg as JA
from editanything_tpu_torch.apps import cli
from editanything_tpu_torch.apps import demos
from editanything_tpu_torch.models import config as TC
from editanything_tpu_torch.models import safety as TS
from editanything_tpu_torch.models.blip2 import tiny_blip2_config
from editanything_tpu_torch.models.groundingdino import tiny_dino_config
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vlpart import tiny_vlpart_config
from editanything_tpu_torch.perception import amg as TA
from editanything_tpu_torch.pipelines import bundle as B
from editanything_tpu_torch.pipelines import editor as TED
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.pipelines.sketch import SketchPipeline
from editanything_tpu_torch.text.tokenizer import (tiny_bert_tokenizer,
                                                   tiny_gpt2_tokenizer,
                                                   tiny_tokenizer)
from editanything_tpu_torch.utils.image import read_image, write_png

from test_ldm_ingest import cldm_ckpt  # noqa: F401  (fixture)
from test_load_e2e import (CN_CFG, SAM_CFG, UNET_CFG, VAE_CFG,  # noqa: F401
                           files)
from test_torch_editor import AMG
from test_torch_load_e2e import _text_cfg
from test_torch_models import port_cfg
from test_torch_sam import port_sam_cfg
from test_ui import StubEditor, _handlers, _run_handlers, _values_for

IMAGE_LEVELS = 2
STEPS = 2
SEED = 3


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


def _image(seed, h=64, w=64):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


def _merges_file(path, tok):
    pairs = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(p) for p in pairs)
                + "\n")


def _asdict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.fixture(scope="module")
def spec(files, tmp_path_factory):
    """A bundle spec over tests/test_load_e2e.py's files, with the port's
    "configs" and "dtype" keys (JAX's CLI reads the keys it knows)."""
    paths, _, tok = files
    d = tmp_path_factory.mktemp("spec")
    _merges_file(str(d / "merges.txt"), tok)
    s = {"unet": paths["unet"], "vae": paths["vae"], "text": paths["text"],
         "tokenizer_merges": str(d / "merges.txt"),
         "controlnets": {"sam": paths["cn_sam"],
                         "inpaint": paths["cn_inpaint"]},
         "lora": [{"path": paths["lora"], "multiplier": 0.5}],
         "safety": paths["safety"], "sam": paths["sam"], "dtype": "float32",
         "configs": {"unet": _asdict(port_cfg(UNET_CFG)),
                     "vae": _asdict(port_cfg(VAE_CFG)),
                     "text": _asdict(port_cfg(_text_cfg(tok))),
                     "controlnet": _asdict(port_cfg(CN_CFG)),
                     "safety": _asdict(TS.tiny_vision_config()),
                     "sam": _asdict(port_sam_cfg(SAM_CFG))}}
    path = str(d / "spec.json")
    with open(path, "w") as f:
        json.dump(s, f)
    return path, s, d


@pytest.fixture()
def small_amg(monkeypatch):
    """Both editors' default AMG as tests/test_torch_editor.py's 4 x 4
    points with the filters open."""
    monkeypatch.setattr(JED, "AMGConfig", lambda: JA.AMGConfig(**AMG))
    monkeypatch.setattr(TED, "AMGConfig", lambda: TA.AMGConfig(**AMG))


def _run(argv):
    return cli.main([str(a) for a in argv])


# --- the reference-call mapping ----------------------------------------------

def _reference_args(img, mask=None, *, as_dict=False, brush_mask=None,
                    **over):
    """tests/test_editor.py:221-238's positional call."""
    source = {"image": img, "mask": brush_mask} if as_dict else img
    vals = dict(
        source_image=source, enable_all_generate=False, mask_image=mask,
        control_scale=0.5, enable_auto_prompt=False, a_prompt="best",
        n_prompt="bad", num_samples=1, image_resolution=64,
        detect_resolution=64, ddim_steps=2, guess_mode=False, scale=9.0,
        seed=5, eta=0.0, enable_tile=False, refine_alignment_ratio=0.95,
        refine_image_resolution=128, alpha_weight=0.5, use_scale_map=False,
        condition_model="EditAnything", ref_image=None,
        attention_auto_machine_weight=1.0, gn_auto_machine_weight=1.0,
        style_fidelity=0.5, reference_attn=True, reference_adain=True,
        ref_prompt=None, ref_sam_scale=None, ref_inpaint_scale=None,
        ref_auto_prompt=False, ref_textinv=False, ref_textinv_path=None,
        ref_scale=None)
    vals.update(over)
    return tuple(vals[k] for k in cli.REF_PROCESS_PARAMS)


def _reference_cases():
    img, ref = _image(21, 96, 96), _image(23, 96, 96)
    mask = np.zeros((96, 96), np.uint8)
    mask[20:70, 20:70] = 255
    brush = np.zeros((96, 96, 3), np.uint8)
    brush[10:30, 10:30] = 255
    full = np.full((96, 96, 3), 255, np.uint8)
    return {
        "positional": (_reference_args(img, mask), {}),
        "gradio dicts": (_reference_args(
            img, None, as_dict=True, brush_mask=brush,
            ref_image={"image": ref, "mask": full},
            attention_auto_machine_weight=0.7, gn_auto_machine_weight=0.3),
            {}),
        "kwargs override": (_reference_args(img), {"seed": 99,
                                                   "ddim_steps": 7}),
        "all generate": (_reference_args(
            img, None, as_dict=True, brush_mask=brush,
            enable_all_generate=True), {}),
        "every parameter": (_reference_args(
            img, np.zeros((96, 96), np.uint8), eta=0.7,
            condition_model="/tmp/cn.safetensors",
            ref_image={"image": ref, "mask": full}, ref_prompt="rp",
            ref_sam_scale=0.3, ref_inpaint_scale=0.2, ref_auto_prompt=True,
            ref_textinv=True, ref_textinv_path="/tmp/e.npy", ref_scale=0.4,
            use_scale_map=True, guess_mode=True, alpha_weight=0.25,
            enable_tile=True, refine_alignment_ratio=0.9,
            refine_image_resolution=256), {}),
        "plain ref image": (_reference_args(img, mask, ref_image=ref), {}),
    }


@pytest.mark.parametrize("case", list(_reference_cases()))
def test_reference_call_to_kwargs_matches_jax(case):
    args, kwargs = _reference_cases()[case]
    want = jcli.reference_call_to_kwargs(args, kwargs)
    got = cli.reference_call_to_kwargs(args, kwargs)
    assert cli.REF_PROCESS_PARAMS == jcli.REF_PROCESS_PARAMS
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_is_reference_capture_matches_jax():
    native = {"image": _image(30), "mask": np.zeros((64, 64)),
              "prompt": "x", "a_prompt": "best", "n_prompt": "bad",
              "num_samples": 1, "ddim_steps": 2, "seed": 5}
    cases = [((), native), (_reference_args(_image(31)), {}),
             ((), {"source_image": _image(32), "ddim_steps": 2}),
             ((), {"a_prompt": "x", "seed": 1}), ((), {})]
    for pos, kw in cases:
        assert cli.is_reference_capture(pos, kw) == \
            jcli.is_reference_capture(pos, kw)
    assert [cli.is_reference_capture(*c) for c in cases] == [
        False, True, True, True, False]


# --- the UI graph (tests/test_ui.py on the port) ------------------------------

@pytest.fixture()
def ui(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", fake_gradio)
    fake_gradio.Component.reset()
    import editanything_tpu_torch.apps.ui as ui_mod
    ui_mod = importlib.reload(ui_mod)
    yield ui_mod
    sys.modules.pop("gradio", None)
    importlib.reload(ui_mod)


def test_ui_three_tabs_three_run_buttons(ui):
    ui.create_demo(StubEditor())
    tabs = [c for c in fake_gradio.Component.registry
            if isinstance(c, fake_gradio.Tab)]
    assert len(tabs) == 3
    runs = _run_handlers()
    assert len(runs) == 3 and len(cli.REF_PROCESS_PARAMS) == 34
    assert sorted(h["inputs"][1].value for h in runs) == [False, False, True]


def test_ui_every_control_reaches_process(ui):
    editor = StubEditor()
    ui.create_demo(editor)
    brush = [h for h in _run_handlers() if h["inputs"][1].value is False][0]
    img = np.zeros((16, 16, 3), np.uint8)
    msk = np.zeros((16, 16), np.uint8)
    overrides = {
        "source_image": {"image": img, "mask": msk}, "mask_image": None,
        "control_scale": 0.7, "a_prompt": "pos", "n_prompt": "neg",
        "num_samples": 3, "image_resolution": 512, "detect_resolution": 256,
        "ddim_steps": 11, "guess_mode": True, "scale": 7.5, "seed": 42,
        "eta": 0.8, "enable_tile": False, "refine_alignment_ratio": 0.9,
        "refine_image_resolution": 1024, "alpha_weight": 0.0,
        "use_scale_map": True, "condition_model": "EditAnything",
        "ref_image": None, "attention_auto_machine_weight": 0.5,
        "gn_auto_machine_weight": 0.25, "style_fidelity": 0.1,
        "reference_attn": True, "reference_adain": False,
        "ref_prompt": "refp", "ref_sam_scale": 0.3, "ref_inpaint_scale": 0.2,
        "ref_auto_prompt": False, "ref_textinv": True,
        "ref_textinv_path": "/tmp/emb.npy", "ref_scale": 0.4}
    brush["fn"](*_values_for(ui, brush, overrides))
    kw = editor.calls[0]
    assert kw["eta"] == 0.8 and kw["sampler"] == "ddim"
    assert kw["control_scale"] == 0.7 and kw["use_scale_map"] is True
    assert kw["ref_textinv"] is True and kw["ref_textinv_path"] == "/tmp/emb.npy"
    assert kw["ref_sam_scale"] == 0.3 and kw["ref_inpaint_scale"] == 0.2
    assert kw["attention_auto_weight"] == 0.5 and kw["gn_auto_weight"] == 0.25
    assert kw["ddim_steps"] == 11 and kw["seed"] == 42
    assert kw["guess_mode"] is True and kw["condition_model"] == "EditAnything"
    np.testing.assert_array_equal(kw["mask"], msk)


def test_ui_click_select_and_clear_wiring(ui):
    editor = StubEditor()
    ui.create_demo(editor)
    selects = _handlers("select")
    assert len(selects) == 1 and len(selects[0]["inputs"]) == 4
    img = np.zeros((16, 16, 3), np.uint8)
    _, pts, _ = selects[0]["fn"](img, "Foreground Point", [], 256,
                                 fake_gradio.SelectData(index=(5, 6)))
    assert pts == [(5, 6, 1)] and editor.click_calls[0] == (5, 6, True, 256)
    _, pts2, _ = selects[0]["fn"](img, "Background Point", pts, 256,
                                  fake_gradio.SelectData(index=(1, 2)))
    assert pts2 == [(5, 6, 1), (1, 2, 0)]
    clears = [h for h in _handlers() if len(h["inputs"]) == 1
              and len(h["outputs"]) == 3]
    out = clears[0]["fn"](img)
    assert out[1] == [] and out[2] is None
    resets = [h for h in _handlers() if len(h["inputs"]) == 0
              and len(h["outputs"]) == 5]
    assert resets[0]["fn"]() == (None, [], None, None, None)


def test_ui_upload_snapshots_origin(ui):
    ui.create_demo(StubEditor())
    uploads = _handlers("upload")
    assert len(uploads) == 1
    img = np.ones((4, 4, 3), np.uint8)
    snap = uploads[0]["fn"](img)
    assert snap is not img
    np.testing.assert_array_equal(snap, img)


def test_ui_combined_app_two_tabs(ui):
    ui.create_combined_app({"Edit Anything": StubEditor(),
                            "Beauty": StubEditor()})
    items = [c for c in fake_gradio.Component.registry
             if isinstance(c, fake_gradio.TabItem)]
    assert len(items) == 2 and len(_run_handlers()) == 6


def test_ui_without_gradio_raises():
    import editanything_tpu_torch.apps.ui as ui_mod
    assert not ui_mod.HAS_GRADIO
    with pytest.raises(ImportError, match="gradio"):
        ui_mod.create_demo(StubEditor())


def test_presets_and_combined_editors_share_sam(files, spec):
    """CONFIG_DICT and DEMO_PRESETS as JAX's; the combined editors share
    one SAM and captioner, each bundle with its LoRA merged."""
    from editanything_tpu.apps import demos as jdemos
    assert demos.CONFIG_DICT == jdemos.CONFIG_DICT
    assert demos.DEMO_PRESETS == jdemos.DEMO_PRESETS
    paths = files[0]
    path = spec[0]
    plain, _ = cli._build_bundle(path, device="cpu")
    beauty, _ = cli._build_bundle(path, device="cpu")
    editors = demos.build_combined_editors(
        {"Edit Anything": plain, "Beauty": beauty}, sam=None,
        lora_specs={"Beauty": [(paths["lora"], 0.5)]})
    assert list(editors) == ["Edit Anything", "Beauty"]
    assert editors["Beauty"].bundle is beauty and editors["Beauty"].sam is None
    merged = [not torch.equal(a, b) for a, b in zip(
        plain.unet.parameters(), beauty.unet.parameters())]
    assert any(merged) and not all(merged)


# --- the command line ----------------------------------------------------------

def test_edit_matches_jax_cli(files, spec, tmp_path, monkeypatch, small_amg):
    paths, _, tok = files
    spec_path = spec[0]
    img = _image(5)
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[16:48, 16:48] = 255
    write_png(str(tmp_path / "img.png"), img)
    write_png(str(tmp_path / "mask.png"), mask)
    args = ["edit", "--bundle-spec", spec_path, "--image", tmp_path / "img.png",
            "--mask", tmp_path / "mask.png", "--prompt", "a red cat",
            "--resolution", 64, "--detect-resolution", 64, "--steps", STEPS,
            "--seed", SEED]
    # JAX's CLI, its hard-coded configs patched to the files' (SD1.5's and
    # ViT-B's there) and its tokenizer to the text tower's 16 positions
    monkeypatch.setattr(JP, "load_bundle", functools.partial(
        JP.load_bundle, unet_cfg=UNET_CFG, vae_cfg=VAE_CFG,
        text_cfg=_text_cfg(tok), controlnet_cfg=CN_CFG,
        safety_cfg=JS.tiny_vision_config(), dtype=jnp.float32))
    monkeypatch.setattr(JTOK, "CLIPTokenizer", functools.partial(
        JTOK.CLIPTokenizer, context_length=16))
    monkeypatch.setattr(JSAM, "SAMConfig", lambda: SAM_CFG)
    jcli.main([str(a) for a in args + ["--output", tmp_path / "jax"]])
    # the port's CLI, the initial latents JAX's (edit.py:176-183)
    noise = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(SEED))[0], (1, 8, 8, 4)))
    process = TED.EditAnythingEditor.process
    monkeypatch.setattr(TED.EditAnythingEditor, "process",
                        lambda self, **kw: process(self, **kw, noise=noise))
    _run(args + ["--output", tmp_path / "port", "--device", "cpu"])
    want = np.asarray(Image.open(tmp_path / "jax_0.png"))
    got = read_image(str(tmp_path / "port_0.png"))
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= IMAGE_LEVELS


def test_file_tools_match_jax_cli(cldm_ckpt, tmp_path):  # noqa: F811
    """add-control, transfer-control and convert-to-diffusers on the same
    files (tests/test_ldm_ingest.py:411-447)."""
    from editanything_tpu_torch.checkpoints.safetensors_io import load_file
    ckpt, _, _, _, full_sd = cldm_ckpt
    plain = {k: torch.tensor(np.asarray(v)) for k, v in full_sd.items()
             if not k.startswith("control_model.")}
    sd_path = str(tmp_path / "sd_plain.ckpt")
    torch.save({"state_dict": plain}, sd_path)
    out = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        d = tmp_path / side
        d.mkdir()
        main(["add-control", "--input", sd_path, "--output",
              str(d / "grafted.ckpt")])
        main(["transfer-control", "--base", sd_path, "--base-with-control",
              ckpt, "--new-base", sd_path, "--output", str(d / "moved.ckpt")])
        main(["convert-to-diffusers", "--input", ckpt, "--output",
              str(d / "cn.safetensors")])
        out[side] = [torch.load(str(d / f), weights_only=False)["state_dict"]
                     for f in ("grafted.ckpt", "moved.ckpt")]
        out[side].append(load_file(str(d / "cn.safetensors")))
    with pytest.raises(SystemExit, match="exists"):
        cli.main(["add-control", "--input", sd_path, "--output",
                  str(tmp_path / "port" / "grafted.ckpt")])
    for i, (want, got) in enumerate(zip(out["jax"], out["port"])):
        assert sorted(got) == sorted(want), i
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape and g.dtype == w.dtype, (i, k)
            drawn = i == 0 and k.startswith("control_model.input_hint_block")
            if drawn and w.abs().max() > 0:
                continue
            torch.testing.assert_close(g, w, atol=0, rtol=0,
                                       msg=lambda m: f"{i} {k}: {m}")


def test_generate_sketch_semantic_and_replay(spec, tmp_path, small_amg):
    spec_path = spec[0]
    cond, img = _image(7), _image(8)
    write_png(str(tmp_path / "cond.png"), cond)
    write_png(str(tmp_path / "img.png"), img)
    common = ["--bundle-spec", spec_path, "--resolution", 64, "--steps",
              STEPS, "--seed", SEED, "--prompt", "a photo of a cat",
              "--device", "cpu"]
    bundle, _ = cli._build_bundle(spec_path, device="cpu")
    editor, _ = cli._build_editor(spec_path, device="cpu")

    _run(["generate", "--condition", tmp_path / "cond.png", "--output",
          tmp_path / "gen"] + common)
    want = GenerationPipeline(bundle, controlnet="sam")(
        prompt="a photo of a cat", condition_image=cond, image_resolution=64,
        num_steps=STEPS, guidance_scale=9.0, control_scale=0.5, seed=SEED)
    np.testing.assert_array_equal(read_image(str(tmp_path / "gen_0.png")),
                                  want[0])

    _run(["sketch", "--sketch", tmp_path / "cond.png", "--output",
          tmp_path / "sk"] + common)
    want = SketchPipeline(bundle, controlnet="sam")(
        sketch=cond, prompt="a photo of a cat", image_resolution=64,
        num_steps=STEPS, guidance_scale=9.0, seed=SEED)
    np.testing.assert_array_equal(read_image(str(tmp_path / "sk_0.png")),
                                  want[0])

    _run(["semantic", "--image", tmp_path / "img.png", "--output",
          tmp_path / "sem"] + common)
    np.testing.assert_array_equal(read_image(str(tmp_path / "sem_0.png")),
                                  editor.get_sam_control(img))

    mask = np.zeros((64, 64), np.uint8)
    mask[10:40, 20:60] = 255
    ref_args = _reference_args(img, mask)
    with open(tmp_path / "input_data.pkl", "wb") as f:
        pickle.dump({"args": ref_args, "kwargs": {}}, f)
    _run(["replay", "--pickle", tmp_path / "input_data.pkl", "--output",
          tmp_path / "rep"] + common)
    _, want, _, _ = editor.process(**cli.reference_call_to_kwargs(ref_args))
    np.testing.assert_array_equal(read_image(str(tmp_path / "rep_0.png")),
                                  want[0])

    with pytest.raises(SystemExit):
        _run(["generate", "--condition", tmp_path / "cond.png", "--bogus"]
             + common)


def test_text_edit_and_caption_data(spec, tmp_path, small_amg):
    """text-edit with each detector and caption-data with BLIP-2, from tiny
    files in the port's layouts, against the port's direct calls."""
    from editanything_tpu_torch.perception.grounding import \
        TextGuidedEditPipeline
    _, s, _ = spec
    s = dict(s, configs=dict(s["configs"]))
    torch.save(B.random_groundingdino(tiny_dino_config(), device="cpu",
                                      seed=1).state_dict(),
               str(tmp_path / "dino.pth"))
    torch.save(B.random_vlpart(tiny_vlpart_config(), device="cpu",
                               seed=2).state_dict(), str(tmp_path / "vlp.pth"))
    torch.save(B.random_blip2(tiny_blip2_config(), device="cpu",
                              seed=3).state_dict(), str(tmp_path / "b2.pth"))
    bert = tiny_bert_tokenizer()
    with open(tmp_path / "vocab.txt", "w") as f:
        f.write("\n".join(sorted(bert.vocab, key=bert.vocab.get)) + "\n")
    gpt2 = tiny_gpt2_tokenizer()
    with open(tmp_path / "gpt2_vocab.json", "w") as f:
        json.dump(gpt2.encoder, f)
    pairs = sorted(gpt2.bpe_ranks, key=gpt2.bpe_ranks.get)
    with open(tmp_path / "gpt2_merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(p) for p in pairs))
    s.update(groundingdino=str(tmp_path / "dino.pth"),
             vlpart=str(tmp_path / "vlp.pth"), blip2=str(tmp_path / "b2.pth"),
             bert_vocab=str(tmp_path / "vocab.txt"),
             blip2_vocab=str(tmp_path / "gpt2_vocab.json"),
             blip2_merges=str(tmp_path / "gpt2_merges.txt"))
    s["configs"].update(groundingdino=_asdict(tiny_dino_config()),
                        vlpart=_asdict(tiny_vlpart_config()),
                        blip2=_asdict(tiny_blip2_config()))
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(s, f)
    img = _image(9)
    write_png(str(tmp_path / "img.png"), img)
    editor, _ = cli._build_editor(spec_path, device="cpu")
    common = ["--bundle-spec", spec_path, "--resolution", 64, "--steps",
              STEPS, "--seed", SEED, "--prompt", "a dog", "--device", "cpu"]
    for kind in ("groundingdino", "vlpart"):
        _run(["text-edit", "--image", tmp_path / "img.png", "--mask-prompt",
              "dog head", "--detector", kind, "--output",
              tmp_path / kind] + common)
        det, kw = cli._build_detector(s, kind, "cpu")
        _, want, _, _ = TextGuidedEditPipeline(editor, det, **kw)(
            image=img, mask_prompt="dog head", prompt="a dog",
            num_samples=1, image_resolution=64, ddim_steps=STEPS, scale=9.0,
            control_scale=0.5, seed=SEED)
        np.testing.assert_array_equal(
            read_image(str(tmp_path / f"{kind}_0.png")), want[0])

    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        Image.fromarray(_image(40 + i)).save(data / f"sa_{i}.jpg")
    _run(["caption-data", "--data-path", data, "--output",
          tmp_path / "data.txt"] + common)
    lines = (tmp_path / "data.txt").read_text().splitlines()
    want = [repr({"target": f"sa_{i}.jpg", "source": f"sa_{i}.json",
                  "prompt": editor.get_blip2_text(
                      read_image(str(data / f"sa_{i}.jpg")))})
            for i in range(2)]
    assert lines == want


def test_train_dreambooth_from_a_bundle_spec(files, spec, tmp_path):
    """``train-dreambooth --bundle-spec`` with a 9-channel UNet file trains
    what ``train()`` on ``_build_bundle``'s bundle trains."""
    _, s, _ = spec
    ucfg = dataclasses.replace(port_cfg(UNET_CFG), in_channels=9)
    unet = B.init_weights_(B._empty(UNet2DConditionModel, ucfg,
                                    torch.device("cpu"), torch.float32),
                           torch.Generator().manual_seed(6))
    from editanything_tpu_torch.checkpoints.safetensors_io import save_file
    save_file(dict(unet.state_dict()), str(tmp_path / "unet9.safetensors"))
    s = dict(s, unet=str(tmp_path / "unet9.safetensors"),
             configs=dict(s["configs"], unet=_asdict(ucfg)))
    s.pop("controlnets")
    spec_path = str(tmp_path / "spec9.json")
    with open(spec_path, "w") as f:
        json.dump(s, f)
    inst = tmp_path / "inst"
    inst.mkdir()
    for i in range(2):
        write_png(str(inst / f"i{i}.png"), _image(50 + i, 40, 40))
    args = ["--instance-data-dir", inst, "--instance-prompt",
            "a photo of a cat", "--max-train-steps", 2, "--resolution", 32,
            "--learning-rate", 1e-3, "--device", "cpu"]
    _run(["train-dreambooth", "--bundle-spec", spec_path, "--output-dir",
          tmp_path / "cli"] + args)
    from editanything_tpu_torch.train.train_dreambooth import train
    bundle, _ = cli._build_bundle(spec_path, device="cpu")
    assert bundle.unet_cfg.in_channels == 9
    train(instance_data_dir=str(inst), instance_prompt="a photo of a cat",
          output_dir=str(tmp_path / "api"), bundle=bundle, max_steps=2,
          resolution=32, lr=1e-3, device="cpu")
    got = torch.load(tmp_path / "cli" / "unet.pt", weights_only=True)
    want = torch.load(tmp_path / "api" / "unet.pt", weights_only=True)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert any(not torch.equal(w, unet.state_dict()[k])
               for k, w in want.items())


@pytest.mark.parametrize("name", ["train-controlnet", "train-ti"])
def test_train_subcommands_hand_over_to_the_trainers(name, monkeypatch):
    module = importlib.import_module(cli.TRAIN_PROGRAMS[name])
    target = "train" if name == "train-controlnet" else \
        "train_textual_inversion"
    calls = []

    def record(**kw):
        calls.append(kw)
        return None, None
    monkeypatch.setattr(module, target, record)
    argv = (["--data-path", "d", "--txt-path", "t", "--batch-size", "2",
             "--device", "cpu"] if name == "train-controlnet" else
            ["--train-data-dir", "d", "--max-train-steps", "3",
             "--device", "cpu"])
    cli.main([name] + argv)
    module.main(argv)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0]["device"] == "cpu"
