"""The system under test, built from a configuration file and drawn
weights: the port's modules through their constructors at the
configuration's widths (``parts/<part>.py``) and ``load_state_dict``, its
ModelBundle and its EditAnythingEditor. Only this module, the drivers,
the parts' ``port`` and the kernel entries' ``target`` import the port."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from port_bench import harness as H
from port_bench import weights as W
from port_bench.inputs import WordTokenizer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def libraries(run):
    """Build (or find in the checkout's build/) the port's native libraries
    that the cell runs, all compilers at once, before any thread of the
    port can ask for one; on the CPU, where the port runs its kernels'
    plain twins, only the host (C++) ones."""
    import editanything_tpu_torch
    from editanything_tpu_torch.core.build import build_libraries
    csrc = Path(editanything_tpu_torch.__file__).parent / "csrc"
    names = [n for n in run.traffic["libraries"]
             if run.device.type == "cuda" or (csrc / f"{n}.cc").exists()]
    build_libraries(names)


def fields_of(cls, d: dict):
    """The entries of `d` that dataclass `cls` has fields for (lists as
    tuples)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in d.items() if k in names}


def port_module(part: str, fields: dict, state=None):
    """The port's module of one part, holding `state` (strict), or on the
    meta device without one."""
    cls, cfg = H.part(part).port(fields)
    with torch.device("meta"):
        m = cls(cfg)
    if state is not None:
        m.load_state_dict(state, strict=True, assign=True)
    return cfg, m.eval()


def draw_state(run, part: str, tag: str):
    """The weights of one model of the run's configuration, in its dtype."""
    return W.model_weights(part, run.config["models"][part], run.seed, tag,
                           run.device, DTYPES[run.config["dtype"]])


def bundle(run, *, weights: bool = True, controlnets=("sam", "inpaint")):
    """The port's ModelBundle of the configuration's SD models, drawn from
    the seed (or on the meta device, never run, without `weights`)."""
    from editanything_tpu_torch.pipelines.bundle import ModelBundle
    m = run.config["models"]
    parts = {}
    for part in ("unet", "vae", "text"):
        parts[part] = port_module(part, m[part], draw_state(run, part, part)
                                  if weights else None)
    cns = {}
    for name in controlnets:
        cns[name] = port_module("controlnet", m["controlnet"], draw_state(
            run, "controlnet", "controlnet." + name) if weights else None)
    return ModelBundle(
        unet_cfg=parts["unet"][0], vae_cfg=parts["vae"][0],
        text_cfg=parts["text"][0], unet=parts["unet"][1],
        vae=parts["vae"][1], text=parts["text"][1],
        tokenizer=WordTokenizer(m["text"]["max_position_embeddings"]),
        controlnets=cns, dtype=DTYPES[run.config["dtype"]])


def amg_config(run):
    from editanything_tpu_torch.perception.amg import AMGConfig
    return AMGConfig(**fields_of(AMGConfig, run.config["amg"]))


def editor(run, *, sd_weights: bool = True):
    """EditAnythingEditor over the bundle and SAM, both drawn from the
    seed; with `sd_weights` False the SD models stay on the meta device
    (a SAM-only cell never runs them)."""
    from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
    sam_cfg, sam = port_module("sam", run.config["models"]["sam"],
                               draw_state(run, "sam", "sam"))
    return EditAnythingEditor(
        bundle(run, weights=sd_weights,
               controlnets=tuple(run.config["controlnets"])),
        sam=(sam_cfg, sam), amg_config=amg_config(run))
