"""The command line: the reference's scripts, headless, on the port.

Counterpart of ``editanything_tpu/apps/cli.py``, subcommand for
subcommand:
  generate             sam2image.py (a condition map + text -> images)
  edit                 editany.py through ``EditAnythingEditor.process``
  sketch               sketch2image.py
  semantic             sam2semantic.py's condition map
  replay               editany_nogradio.py (a pickled ``process`` call)
  text-edit            sam2groundingdino_edit.py / sam2vlpart_edit.py
  caption-data         dataset_build.py (BLIP-2 captions -> data.txt)
  add-control          tools/tool_add_control_sd{15,21}.py
  transfer-control     tools/tool_transfer_control.py
  convert-to-diffusers tools/convert_controlnet_to_diffusers.py
  train-controlnet, train-dreambooth, train-ti: the trainers' own ``main``s.

Every model subcommand takes ``--bundle-spec``, a JSON file naming the
checkpoint files in the JAX package's format
  {"unet": ..., "vae": ..., "text": ..., "tokenizer_merges": ...,
   "controlnets": {"sam": ..., "inpaint": ..., "tile": ...},
   "lora": [{"path": ..., "multiplier": 1.0}, ...], "safety": ...,
   "sam": ..., "blip2": ..., "blip2_vocab": ..., "blip2_merges": ...,
   "groundingdino": ..., "bert_vocab": ..., "vlpart": ...}
and two keys of the port's: "dtype" ("bfloat16" by default, as
``load_bundle``) and "configs", field overrides of each model's config
({"unet": {"in_channels": 9}}, "vae", "text", "controlnet", "safety",
"sam", "blip2", "groundingdino", "vlpart"; nested configs take nested
objects), so SD2.1, the 9-channel inpaint UNet and
small test models load from files too. Without a "sam" override the SAM
variant (ViT-B, -L or -H) is read off the checkpoint, where JAX's CLI
builds ViT-B. ``--device`` (default ``cuda``) places the models; images
are read and written by ``utils/image.py`` (PNGs without PIL).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import pickle

import numpy as np
import torch

from editanything_tpu_torch.utils.image import read_image, write_png

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _load_image(path: str) -> np.ndarray:
    return read_image(path)


def _save_images(images, out_prefix: str):
    paths = []
    for i, img in enumerate(np.asarray(images)):
        p = f"{out_prefix}_{i}.png"
        write_png(p, img)
        paths.append(p)
    return paths


def _config(default, overrides):
    """`default` (a config dataclass) with the fields of `overrides` (a
    dict from JSON) replaced: nested configs recursively, lists as
    tuples."""
    if not overrides:
        return default
    fields = {}
    for key, value in overrides.items():
        current = getattr(default, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            value = _config(current, value)
        elif isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v
                          for v in value)
        fields[key] = value
    return dataclasses.replace(default, **fields)


def _spec(spec_path: str) -> dict:
    with open(spec_path) as f:
        return json.load(f)


def _dtype(spec) -> torch.dtype:
    return _DTYPES[spec.get("dtype", "bfloat16")]


def _build_bundle(spec_path: str, *, device="cuda"):
    """The spec's bundle through ``load_bundle`` (and its spec)."""
    from editanything_tpu_torch.models import config as C
    from editanything_tpu_torch.models.safety import CLIPVisionConfig
    from editanything_tpu_torch.pipelines.bundle import load_bundle
    from editanything_tpu_torch.text.tokenizer import CLIPTokenizer
    spec = _spec(spec_path)
    configs = spec.get("configs", {})
    ucfg = _config(C.sd15_unet(), configs.get("unet"))
    tcfg = _config(C.clip_vit_l() if ucfg.cross_attention_dim == 768
                   else C.openclip_vit_h(), configs.get("text"))
    tok = CLIPTokenizer(vocab_path=spec["tokenizer_merges"],
                        context_length=tcfg.max_position_embeddings)
    # kohya LoRAs: [{"path": ..., "multiplier": 1.0}, ...] or plain paths
    # (editany_lora.py:197-329)
    lora_specs = [(s["path"], s.get("multiplier", 1.0)) if isinstance(s, dict)
                  else (s, 1.0) for s in spec.get("lora", [])]
    bundle = load_bundle(
        unet_path=spec["unet"], vae_path=spec["vae"], text_path=spec["text"],
        tokenizer=tok, controlnet_paths=spec.get("controlnets", {}),
        unet_cfg=ucfg, vae_cfg=_config(C.VAEConfig(), configs.get("vae")),
        text_cfg=tcfg, controlnet_cfg=_config(C.ControlNetConfig(unet=ucfg),
                                              configs.get("controlnet")),
        safety_path=spec.get("safety"),
        safety_cfg=_config(CLIPVisionConfig(), configs.get("safety")),
        lora_specs=lora_specs, dtype=_dtype(spec), device=device)
    return bundle, spec


def _load_sam(spec, device):
    """SAM from its official file in fp32; its variant from the spec's
    "sam" config, else read off the width of its encoder."""
    from editanything_tpu_torch.checkpoints.convert import \
        load_torch_state_dict
    from editanything_tpu_torch.models import sam as SAM
    from editanything_tpu_torch.pipelines.bundle import module_from_state_dict
    sd = load_torch_state_dict(spec["sam"], device=device, dtype=torch.float32)
    override = spec.get("configs", {}).get("sam")
    if override:
        cfg = _config(SAM.SAMConfig(), override)
    else:
        width = sd["image_encoder.patch_embed.proj.weight"].shape[0]
        cfg = {c.embed_dim: c for c in (SAM.sam_vit_b(), SAM.sam_vit_l(),
                                        SAM.sam_vit_h())}[width]
    return cfg, module_from_state_dict(SAM.Sam, cfg, sd, device=device,
                                       dtype=torch.float32)


def _build_editor(spec_path: str, *, device="cuda"):
    """``EditAnythingEditor`` over the spec's bundle, with its SAM and its
    BLIP-2 captioner where the spec names them (and its spec)."""
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    bundle, spec = _build_bundle(spec_path, device=device)
    sam = captioner = None
    if spec.get("sam"):
        sam = _load_sam(spec, device)
    if spec.get("blip2"):
        from editanything_tpu_torch.models.blip2 import BLIP2Config
        from editanything_tpu_torch.pipelines.bundle import load_blip2
        from editanything_tpu_torch.pipelines.captioner import Captioner
        from editanything_tpu_torch.text.tokenizer import GPT2Tokenizer
        cfg = _config(BLIP2Config(), spec.get("configs", {}).get("blip2"))
        model = load_blip2(spec["blip2"], cfg, device=device,
                           dtype=_dtype(spec))
        tok = GPT2Tokenizer.from_files(spec["blip2_vocab"],
                                       spec["blip2_merges"])
        captioner = Captioner(model, tok)
    return EditAnythingEditor(bundle, sam=sam, captioner=captioner), spec


def cmd_generate(args):
    from editanything_tpu_torch.pipelines.generate import GenerationPipeline
    bundle, _ = _build_bundle(args.bundle_spec, device=args.device)
    pipe = GenerationPipeline(bundle, controlnet="sam")
    imgs = pipe(prompt=args.prompt, condition_image=_load_image(args.condition),
                negative_prompt=args.negative_prompt,
                num_samples=args.num_samples,
                image_resolution=args.resolution, num_steps=args.steps,
                guidance_scale=args.scale, control_scale=args.control_scale,
                guess_mode=args.guess_mode, seed=args.seed)
    print("\n".join(_save_images(imgs, args.output)))


def cmd_edit(args):
    editor, _ = _build_editor(args.bundle_spec, device=args.device)
    mask = _load_image(args.mask)[..., 0] if args.mask else None
    tile, results, _, prompt = editor.process(
        image=_load_image(args.image), mask=mask, prompt=args.prompt,
        n_prompt=args.negative_prompt, enable_auto_prompt=args.auto_prompt,
        enable_all_generate=args.mask is None, num_samples=args.num_samples,
        image_resolution=args.resolution,
        detect_resolution=args.detect_resolution, ddim_steps=args.steps,
        scale=args.scale, control_scale=args.control_scale, seed=args.seed,
        alignment_ratio=args.alignment_ratio, enable_tile=args.tile,
        refine_image_resolution=args.refine_resolution)
    print("prompt:", prompt)
    print("\n".join(_save_images(results, args.output)))
    if tile:
        print("\n".join(_save_images(np.stack(tile), args.output + "_tile")))


def cmd_sketch(args):
    from editanything_tpu_torch.pipelines.sketch import SketchPipeline
    bundle, _ = _build_bundle(args.bundle_spec, device=args.device)
    pipe = SketchPipeline(bundle, controlnet="sam")
    imgs = pipe(sketch=_load_image(args.sketch), prompt=args.prompt,
                use_scale_map=not args.no_scale_map,
                num_samples=args.num_samples,
                image_resolution=args.resolution, num_steps=args.steps,
                guidance_scale=args.scale, seed=args.seed)
    print("\n".join(_save_images(imgs, args.output)))


def cmd_semantic(args):
    editor, _ = _build_editor(args.bundle_spec, device=args.device)
    cond = editor.get_sam_control(_load_image(args.image))
    print("condition map saved:", _save_images(cond[None], args.output)[0])


# The reference's process() positional parameter order: a pickle captured
# from the reference UI stores all of these in data["args"]
# (@save_input_to_file, annotator/util.py:77-95; replayed as
# model.process(*args, **kwargs), editany_nogradio.py:14). Order from
# editany_lora.py:609-644.
REF_PROCESS_PARAMS = (
    "source_image", "enable_all_generate", "mask_image", "control_scale",
    "enable_auto_prompt", "a_prompt", "n_prompt", "num_samples",
    "image_resolution", "detect_resolution", "ddim_steps", "guess_mode",
    "scale", "seed", "eta", "enable_tile", "refine_alignment_ratio",
    "refine_image_resolution", "alpha_weight", "use_scale_map",
    "condition_model", "ref_image", "attention_auto_machine_weight",
    "gn_auto_machine_weight", "style_fidelity", "reference_attn",
    "reference_adain", "ref_prompt", "ref_sam_scale", "ref_inpaint_scale",
    "ref_auto_prompt", "ref_textinv", "ref_textinv_path", "ref_scale",
)

# the reference's names that EditAnythingEditor.process takes as they are
_DIRECT = ("enable_all_generate", "control_scale", "enable_auto_prompt",
           "a_prompt", "n_prompt", "num_samples", "image_resolution",
           "detect_resolution", "ddim_steps", "guess_mode", "scale", "seed",
           "eta", "enable_tile", "alpha_weight", "use_scale_map",
           "style_fidelity", "reference_attn", "reference_adain",
           "ref_prompt", "ref_auto_prompt", "ref_textinv", "ref_textinv_path",
           "ref_scale", "ref_sam_scale", "ref_inpaint_scale",
           "condition_model", "refine_alignment_ratio",
           "refine_image_resolution")
_RENAMED = {"attention_auto_machine_weight": "attention_auto_weight",
            "gn_auto_machine_weight": "gn_auto_weight"}


def reference_call_to_kwargs(ref_args, ref_kwargs=None) -> dict:
    """A reference-format ``process`` call (positionals in the
    editany_lora.py:609-644 order, plus reference-named kwargs) ->
    ``EditAnythingEditor.process``'s keywords. Gradio's image dicts
    ({"image", "mask"} of the brush widgets, editany_lora.py:652-656,
    704-706) are unpacked; eta above 0 selects DDIM, the only sampler that
    reads it (as in the reference)."""
    ref = dict(zip(REF_PROCESS_PARAMS, ref_args))
    ref.update({k: v for k, v in (ref_kwargs or {}).items()
                if k in REF_PROCESS_PARAMS})
    out = {}
    src = ref.get("source_image")
    if isinstance(src, dict):
        out["image"] = np.asarray(src["image"], np.uint8)
        brush_mask = src.get("mask")
    else:
        out["image"] = np.asarray(src, np.uint8)
        brush_mask = None
    mask = ref.get("mask_image")
    if mask is None and not ref.get("enable_all_generate", False):
        mask = brush_mask
    if mask is not None:
        mask = np.asarray(mask, np.uint8)
        if mask.ndim == 3:
            mask = mask[..., 0]
    out["mask"] = mask
    for k in _DIRECT:
        if ref.get(k) is not None:
            out[k] = ref[k]
    for k, native in _RENAMED.items():
        if ref.get(k) is not None:
            out[native] = ref[k]
    rimg = ref.get("ref_image")
    if isinstance(rimg, dict):
        out["ref_image"] = np.asarray(rimg["image"], np.uint8)
        if rimg.get("mask") is not None:
            out["ref_mask"] = np.asarray(rimg["mask"], np.uint8)
    elif rimg is not None:
        out["ref_image"] = np.asarray(rimg, np.uint8)
    if out.get("eta", 0.0):
        out.setdefault("sampler", "ddim")
    return out


def is_reference_capture(pos, kwargs) -> bool:
    """Whether a pickled call is in the reference's format: positionals,
    the reference's first parameter ``source_image``, or reference-named
    kwargs without the port's required ``image`` (the port's own
    ``EA_SAVE_INPUTS`` captures share many kwarg names with the reference,
    but always carry ``image`` and no positionals)."""
    return bool(pos) or "source_image" in kwargs or (
        "image" not in kwargs
        and any(k in REF_PROCESS_PARAMS for k in kwargs))


def cmd_replay(args):
    """Re-run a pickled ``process`` call (editany_nogradio.py:1-16), in the
    reference's capture format or the port's ``EA_SAVE_INPUTS`` one. The
    pickle runs code as it loads: replay only files you captured."""
    editor, _ = _build_editor(args.bundle_spec, device=args.device)
    with open(args.pickle, "rb") as f:
        data = pickle.load(f)
    pos = tuple(data.get("args", ()))
    kwargs = dict(data.get("kwargs", {}))
    if is_reference_capture(pos, kwargs):
        kwargs = reference_call_to_kwargs(pos, kwargs)
    _, results, _, prompt = editor.process(**kwargs)
    print("prompt:", prompt)
    print("\n".join(_save_images(results, args.output)))


def _build_detector(spec, kind: str, device):
    """The spec's VLPart or GroundingDINO detector and the
    ``prompt2mask`` thresholds of its reference script."""
    configs = spec.get("configs", {})
    if kind == "vlpart":
        from editanything_tpu_torch.models.vlpart import (VLPartConfig,
                                                          VLPartDetector)
        from editanything_tpu_torch.pipelines.bundle import load_vlpart
        from editanything_tpu_torch.text.tokenizer import CLIPTokenizer
        model = load_vlpart(spec["vlpart"],
                            _config(VLPartConfig(), configs.get("vlpart")),
                            device=device, dtype=_dtype(spec))
        tok = CLIPTokenizer(vocab_path=spec["tokenizer_merges"])
        return VLPartDetector(model, tok), dict(score_thresh=0.7)
    from editanything_tpu_torch.models.groundingdino import (
        DINOConfig, GroundingDINODetector)
    from editanything_tpu_torch.pipelines.bundle import load_groundingdino
    from editanything_tpu_torch.text.tokenizer import BertTokenizer
    model = load_groundingdino(
        spec["groundingdino"], _config(DINOConfig(),
                                       configs.get("groundingdino")),
        device=device, dtype=_dtype(spec))
    tok = BertTokenizer.from_file(spec["bert_vocab"])
    return (GroundingDINODetector(model, tok),
            dict(score_thresh=0.25, max_boxes=2))


def cmd_text_edit(args):
    """Text-grounded edit: the detector's boxes -> SAM masks -> the edit
    (sam2vlpart_edit.py / sam2groundingdino_edit.py)."""
    from editanything_tpu_torch.perception.grounding import \
        TextGuidedEditPipeline
    editor, spec = _build_editor(args.bundle_spec, device=args.device)
    det, kw = _build_detector(spec, args.detector, args.device)
    _, results, _, prompt = TextGuidedEditPipeline(editor, det, **kw)(
        image=_load_image(args.image), mask_prompt=args.mask_prompt,
        prompt=args.prompt, num_samples=args.num_samples,
        image_resolution=args.resolution, ddim_steps=args.steps,
        scale=args.scale, control_scale=args.control_scale, seed=args.seed)
    print("prompt:", prompt)
    print("\n".join(_save_images(results, args.output)))


def cmd_caption_data(args):
    """BLIP-2-caption every .jpg of a folder into data.txt
    (dataset_build.py:14-40)."""
    editor, _ = _build_editor(args.bundle_spec, device=args.device)
    names = sorted(n for n in os.listdir(args.data_path) if n.endswith(".jpg"))
    with open(args.output, "w") as f:
        for name in names:
            text = editor.get_blip2_text(
                _load_image(os.path.join(args.data_path, name)))
            f.write(repr({"target": name, "source": name[:-4] + ".json",
                          "prompt": text}) + "\n")
    print(f"wrote {len(names)} lines to {args.output}")


def cmd_add_control(args):
    """An SD checkpoint -> a cldm checkpoint with a grafted control branch
    (tools/tool_add_control_sd{15,21}.py:27-50)."""
    from editanything_tpu_torch.checkpoints.convert import \
        load_torch_state_dict
    from editanything_tpu_torch.checkpoints.ldm import add_control
    if os.path.exists(args.output):
        raise SystemExit(f"output {args.output} already exists")
    out = add_control(load_torch_state_dict(args.input), seed=args.seed,
                      hint_channels=args.hint_channels)
    n_ctrl = sum(k.startswith("control_model.") for k in out)
    torch.save({"state_dict": out}, args.output)
    print(f"wrote {args.output}: {n_ctrl} control_model keys grafted")


def cmd_transfer_control(args):
    """Offset-transfer a trained control to another base
    (tool_transfer_control.py:35-58)."""
    from editanything_tpu_torch.checkpoints.convert import \
        load_torch_state_dict
    from editanything_tpu_torch.checkpoints.ldm import transfer_control
    out = transfer_control(load_torch_state_dict(args.base),
                           load_torch_state_dict(args.base_with_control),
                           load_torch_state_dict(args.new_base))
    torch.save({"state_dict": out}, args.output)
    print(f"wrote {args.output}: {len(out)} keys")


def cmd_convert_to_diffusers(args):
    """A trained cldm checkpoint -> a diffusers-layout ControlNet
    ``.safetensors`` (tools/convert_controlnet_to_diffusers.py:80-91)."""
    from editanything_tpu_torch.checkpoints.ldm import \
        cldm_controlnet_to_diffusers_sd
    from editanything_tpu_torch.checkpoints.safetensors_io import save_file
    sd = cldm_controlnet_to_diffusers_sd(args.input,
                                         extract_ema=args.extract_ema)
    save_file({k: v.contiguous() for k, v in sd.items()}, args.output)
    print(f"wrote {args.output}: {len(sd)} tensors")


# the training programs, each with its own argparse ``main``
# (sam_train_sd21.py, tools/train_dreambooth_inpaint.py,
# utils/texutal_inversion.py)
TRAIN_PROGRAMS = {
    "train-controlnet": "editanything_tpu_torch.train.train_controlnet",
    "train-dreambooth": "editanything_tpu_torch.train.train_dreambooth",
    "train-ti": "editanything_tpu_torch.train.train_ti",
}


def main(argv=None):
    p = argparse.ArgumentParser("editanything-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--bundle-spec", required=True)
        sp.add_argument("--output", default="out")
        sp.add_argument("--prompt", default="")
        sp.add_argument("--negative-prompt", default="")
        sp.add_argument("--num-samples", type=int, default=1)
        sp.add_argument("--resolution", type=int, default=512)
        sp.add_argument("--steps", type=int, default=30)
        sp.add_argument("--scale", type=float, default=9.0)
        sp.add_argument("--control-scale", type=float, default=0.5)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda")

    g = sub.add_parser("generate")
    common(g)
    g.add_argument("--condition", required=True)
    g.add_argument("--guess-mode", action="store_true")
    g.set_defaults(fn=cmd_generate)

    e = sub.add_parser("edit")
    common(e)
    e.add_argument("--image", required=True)
    e.add_argument("--mask")
    e.add_argument("--auto-prompt", action="store_true")
    e.add_argument("--detect-resolution", type=int, default=1024)
    e.add_argument("--alignment-ratio", type=float)
    e.add_argument("--tile", action="store_true")
    e.add_argument("--refine-resolution", type=int, default=1024)
    e.set_defaults(fn=cmd_edit)

    s = sub.add_parser("sketch")
    common(s)
    s.add_argument("--sketch", required=True)
    s.add_argument("--no-scale-map", action="store_true")
    s.set_defaults(fn=cmd_sketch)

    m = sub.add_parser("semantic")
    common(m)
    m.add_argument("--image", required=True)
    m.set_defaults(fn=cmd_semantic)

    r = sub.add_parser("replay")
    common(r)
    r.add_argument("--pickle", default="input_data.pkl")
    r.set_defaults(fn=cmd_replay)

    t = sub.add_parser("text-edit")
    common(t)
    t.add_argument("--image", required=True)
    t.add_argument("--mask-prompt", required=True,
                   help="text describing the region, e.g. 'dog head'")
    t.add_argument("--detector", choices=("vlpart", "groundingdino"),
                   default="groundingdino")
    t.set_defaults(fn=cmd_text_edit)

    c = sub.add_parser("caption-data")
    common(c)
    c.add_argument("--data-path", required=True)
    c.set_defaults(fn=cmd_caption_data)

    ac = sub.add_parser("add-control")
    ac.add_argument("--input", required=True)
    ac.add_argument("--output", required=True)
    ac.add_argument("--seed", type=int, default=0)
    ac.add_argument("--hint-channels", type=int, default=3)
    ac.set_defaults(fn=cmd_add_control)

    tc = sub.add_parser("transfer-control")
    tc.add_argument("--base", required=True)
    tc.add_argument("--base-with-control", required=True)
    tc.add_argument("--new-base", required=True)
    tc.add_argument("--output", required=True)
    tc.set_defaults(fn=cmd_transfer_control)

    cd = sub.add_parser("convert-to-diffusers")
    cd.add_argument("--input", required=True)
    cd.add_argument("--output", required=True)
    cd.add_argument("--extract-ema", action="store_true")
    cd.set_defaults(fn=cmd_convert_to_diffusers)

    for name, module in TRAIN_PROGRAMS.items():
        sub.add_parser(name, add_help=False).set_defaults(train_module=module)

    args, extra = p.parse_known_args(argv)
    if getattr(args, "train_module", None):
        return importlib.import_module(args.train_module).main(extra)
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
