"""The controls of ``correct``: the plain reference put in the program's
place, computed one precision lower than the configuration states, and
for training the planted faults, each compared with the fp32 reference by
the cell's own numbers at the cell's own sizes.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed and variant: edit and segment-everything
cells run the reference with every product in fp8 (e4m3, per-tensor
scales), the configuration stating bf16; the training cell runs it with
TF32 on (the configuration states fp32 with TF32 off) and with half of
each batch left out (the loss the mean over the rest). The benchmark's
runs never run this; its readings set the upper ends of the limits
(PERF.md). A driver that this file does not name brings its controls as
``CONTROLS`` (name -> (readings function, its variant)) in its own file.
Needs a CUDA device, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import build, harness as H, inputs  # noqa: E402
from port_bench.capture import rel_rms  # noqa: E402
from port_bench.reference import edit as RE  # noqa: E402
from port_bench.reference import nn as P  # noqa: E402


def make_run(cell: str, seed: int, device) -> H.Run:
    entry = H.workload(cell)
    return H.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                 device=device, entry=entry,
                 traffic=H.traffic(entry["traffic"]),
                 config=H.config(entry["config"]))


@torch.no_grad()
def sam_readings(run, lower: str) -> dict:
    from port_bench.drivers import sam as SD
    images = SD.draw_requests(run)
    keys, rows = SD.check_plan(run, 3 * run.config["amg"]["points_per_side"]
                               ** 2, SD.pixel_counts(run, images))
    sam, amg = SD.reference_sam(run)
    worst = {}
    for k in keys:
        img = images[k % len(images)]
        with P.fp32_exact():
            want = RE.sam_condition(sam, amg, img, run.device, rows=rows)
            with P.precision(lower):
                got = RE.sam_condition(sam, amg, img, run.device, rows=rows)
        SD.compare_sam(got, want, got["id_map"], worst)
    return worst


@torch.no_grad()
def edit_readings(run, lower: str) -> dict:
    from port_bench.drivers import edit as ED
    from port_bench.drivers import sam as SD
    t = run.traffic
    run.state["requests"] = ED.draw_requests(run)
    keys, rows = SD.check_plan(run, 3 * run.config["amg"]["points_per_side"]
                               ** 2)
    run.state["rows"] = rows
    models = ED.reference_models(run)
    kw = dict(steps=t["steps"], guidance=t["guidance"],
              control_scale=t["control_scale"])
    worst = {}
    for k in keys:
        req = ED.reference_request(run, run.state["requests"][k])
        with P.fp32_exact():
            want = RE.edit(models, req, run.device, **kw)
            with P.precision(lower):
                got = RE.edit(models, req, run.device, **kw)
        SD.compare_sam(got[0], want[0], got[0]["id_map"], worst)
        vals = {"latents_rel": rel_rms(got[1], want[1]),
                "image_mad": float(np.abs(got[2].astype(np.float64)
                                          - want[2]).mean())}
        for name, v in vals.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def train_batches(run, tmp):
    """The first check_steps batches as train() draws them: the port's
    batcher over the folder the driver writes, t and noise from a
    generator seeded with the run's seed."""
    from editanything_tpu_torch.data import SAMDataset, make_batcher
    t, cfg = run.traffic, run.config["train"]
    g = torch.Generator(run.device).manual_seed(run.seed % 2 ** 63)
    rng = np.random.default_rng([run.seed % 2 ** 63, 3])
    txt = inputs.sa1b_folder(os.path.join(tmp, "sa1b"), g, rng,
                             images=t["images"], hw=t["image_hw"],
                             masks=t["masks"], prompts=t["prompts"],
                             samples=t["samples"])
    seed = run.seed % 2 ** 31
    ds = SAMDataset(os.path.dirname(txt), txt, resolution=cfg["resolution"],
                    seed=seed)
    tok = inputs.WordTokenizer(
        run.config["models"]["text"]["max_position_embeddings"])
    gen = torch.Generator(run.device).manual_seed(seed)
    out, step = [], 0
    while len(out) < t["check_steps"]:
        for b in make_batcher(ds, batch_size=cfg["batch_size"],
                              seed=seed + step):
            r = cfg["resolution"] // 8
            tt = torch.randint(0, 1000, (cfg["batch_size"],), generator=gen,
                               device=run.device)
            noise = torch.randn((cfg["batch_size"], 4, r, r), generator=gen,
                                device=run.device)
            out.append({
                "jpg": torch.from_numpy(b["jpg"]).permute(0, 3, 1, 2)
                .to(run.device),
                "hint": torch.from_numpy(b["hint"]).permute(0, 3, 1, 2)
                .to(run.device),
                "ids": torch.from_numpy(tok(b["txt"], pad_to=77,
                                            truncate=True)).to(run.device),
                "t": tt, "noise": noise})
            step += 1
            if len(out) == t["check_steps"]:
                break
    return out


def train_readings(run, variant: str) -> dict:
    from port_bench import weights as W
    from port_bench.drivers import train as TD
    from port_bench.reference import train as RT
    m, dev = run.config["models"], run.device
    build.libraries(run)
    tmp = tempfile.mkdtemp(prefix="port_bench_control_")
    try:
        batches = train_batches(run, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def models():
        def ref(part, tag):
            return W.reference_model(part, m[part],
                                     build.draw_state(run, part, tag), dev)
        return {"unet": ref("unet", "unet"), "vae": ref("vae", "vae"),
                "text": ref("text", "text"),
                "controlnet": ref("controlnet",
                                  "controlnet.sam").requires_grad_(True)}
    lr = run.config["train"]["lr"]
    with P.fp32_exact():
        ref_models = models()
        p0 = {k: p.detach().clone()
              for k, p in ref_models["controlnet"].named_parameters()}
        want = RT.steps(ref_models, batches, lr=lr)
        del ref_models
        ctl = models()
        if variant == "tf32":
            with P.precision("tf32"):
                got = RT.steps(ctl, batches, lr=lr)
        else:
            half = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                    for b in batches]
            got = RT.steps(ctl, half, lr=lr)
    return TD.compare(got, want, p0, f" ({variant})")


# each driver's controls: name -> (readings function, its variant)
CONTROLS = {"train": {"tf32": (train_readings, "tf32"),
                      "half_batch": (train_readings, "half")},
            "edit": {"fp8": (edit_readings, "fp8")},
            "sam": {"fp8": (sam_readings, "fp8")}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        run = make_run(args.workload, seed, "cuda")
        driver = run.traffic["driver"]
        # a driver this file does not name brings its controls itself
        variants = (CONTROLS[driver] if driver in CONTROLS
                    else H.driver(driver).CONTROLS)
        for name, (fn, lower) in variants.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": name, "readings": fn(run, lower)}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
