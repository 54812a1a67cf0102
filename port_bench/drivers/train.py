"""Driver of ControlNet training: iterations of the port's ``train()``
itself (its batcher over an SA-1B-layout folder, its preprocessor, its
step with Adam and the EMA), one process standing for one rank of the
data-parallel job.

Set-up writes the folder under TMPDIR from the seed and starts
``train()``; its first ``warm_steps`` iterations are set-up too (the
first ``check_steps`` of them are the ones the reference follows), and
the window is the iterations after them, until ``--seconds`` have
passed. The benchmark's own hooks on the trainer module (its
CheckpointManager, preprocessor and step factories, the batcher) take the
copies the check needs, put spans around the calls into each layer, stop
``train()`` at the window's close and write no checkpoint.

Traffic parameters (``cells/<traffic>.json``): ``images``, ``image_hw``,
``masks`` and ``prompts`` of the folder, ``warm_steps``,
``check_steps``, ``check`` and its limits.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile

import numpy as np
import torch

from port_bench import build, inputs
from port_bench import weights as W
from port_bench.capture import Hooks, rel_rms
from port_bench.counts import models as CM
from port_bench.harness import WindowClosed


def host(t):
    """A copy of `t` on the host (a copy on the CPU too, where ``.cpu()``
    would hand back the tensor the trainer goes on to change in place)."""
    return t.detach().to("cpu", copy=True)


def install(run, hooks: Hooks):
    """The hooks on the trainer module; returns the dict they fill."""
    from editanything_tpu_torch import data as D
    from editanything_tpu_torch.train import train_controlnet as TC
    t = run.traffic
    n_check, warm = t["check_steps"], t["warm_steps"]
    cap = {"jpg": [], "ids": [], "hint": [], "t": [], "noise": [],
           "loss": [], "step": 0,
           "bad": torch.zeros((), dtype=torch.int64, device=run.device)}

    def preprocessor(orig):
        def make():
            fn = orig()

            def pre(vae, text, jpg, ids):
                with run.span("train_input"):
                    out = fn(vae, text, jpg, ids)
                if cap["step"] < n_check:
                    cap["jpg"].append(host(jpg))
                    cap["ids"].append(host(ids))
                    if cap["step"] == 0:
                        cap["latents"], cap["context"] = map(host, out)
                return out
            return pre
        return make

    def step_factory(orig):
        def make(*args, **kwargs):
            fn = orig(*args, **kwargs)

            def step(state, unet, batch, *, generator=None, t=None,
                     noise=None):
                if cap["step"] < n_check:
                    cap["hint"].append(host(batch["hint"]))
                    cap["t"].append(host(t))
                    cap["noise"].append(host(noise))
                with run.span("train_step"):
                    state, m = fn(state, unet, batch, generator=generator,
                                  t=t, noise=noise)
                if cap["step"] < n_check:
                    cap["loss"].append(float(m["loss"]))
                if run.in_window:
                    cap["bad"] += (~torch.isfinite(m["loss"])).to(torch.int64)
                cap["step"] += 1
                return state, m
            return step
        return make

    def batcher(orig):
        def make(*args, **kwargs):
            it = iter(orig(*args, **kwargs))
            while True:
                with run.span("train_input"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch
        return make

    class Checkpoints:
        """Saves nothing; copies the state after the checked steps, opens
        the window after the warm steps and closes it at the deadline."""

        def __init__(self, *args, **kwargs):
            pass

        def restore(self, state):
            return None

        def maybe_save(self, step, state):
            net = state.controlnet
            if step == 1:
                # an optimizer that kept no state reads as a zero gradient
                opt = state.optimizer.state
                cap["exp_avg"] = {
                    k: host(opt.get(p, {}).get("exp_avg", torch.zeros_like(p)))
                    for k, p in net.named_parameters()}
            if step == n_check:
                cap["params"] = {k: host(p) for k, p in
                                 net.named_parameters()}
                cap["ema"] = {k: host(p) for k, p in
                              state.ema.named_parameters()}
            if step == warm:
                run.begin_window()
            elif step > warm and run.unit_done():
                run.end_window()
                raise WindowClosed

        def save(self, step, state):
            return None

        def close(self):
            return None

    hooks.replace(TC, "make_preprocessor", preprocessor)
    hooks.replace(TC, "make_train_step", step_factory)
    hooks.replace(TC, "CheckpointManager", lambda orig: Checkpoints)
    hooks.replace(D, "make_batcher", batcher)
    return cap


def setup(run):
    t, cfg = run.traffic, run.config["train"]
    build.libraries(run)
    bundle = build.bundle(run, controlnets=("sam",))
    tmp = tempfile.mkdtemp(prefix="port_bench_train_")
    g = torch.Generator(run.device).manual_seed(run.seed % 2 ** 63)
    rng = np.random.default_rng([run.seed % 2 ** 63, 3])
    txt = inputs.sa1b_folder(os.path.join(tmp, "sa1b"), g, rng,
                             images=t["images"], hw=t["image_hw"],
                             masks=t["masks"], prompts=t["prompts"],
                             samples=t["samples"])
    hooks = Hooks()
    cap = install(run, hooks)
    run.state.update(bundle=bundle, tmp=tmp, hooks=hooks, cap=cap)
    run.state["train_kwargs"] = dict(
        data_path=os.path.dirname(txt), txt_path=txt,
        out_dir=os.path.join(tmp, "run"), bundle=bundle,
        batch_size=cfg["batch_size"], lr=cfg["lr"], max_steps=10 ** 9,
        resolution=cfg["resolution"], log_every=cfg["log_every"],
        image_every=10 ** 9, ckpt_every=10 ** 9, seed=run.seed % 2 ** 31,
        remat=cfg["remat"], use_ema=cfg["use_ema"], device=run.device)
    run.state["end_to_end"] = end_to_end


def end_to_end(run) -> dict:
    return {"train_iter_s": run.window_s / run.units}


def unit_flops(config: dict, traffic: dict) -> float:
    return CM.train_iteration_flops(config, traffic)


def window(run):
    from editanything_tpu_torch.train.train_controlnet import train
    try:
        train(**run.state["train_kwargs"])
    except WindowClosed:
        pass
    run.failed = int(run.state["cap"]["bad"])


def release(run):
    run.state["hooks"].undo()
    shutil.rmtree(run.state["tmp"], ignore_errors=True)
    run.state["bundle"] = run.state["train_kwargs"] = None


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(want[k].float().norm()) for k in keep}
    med = statistics.median(norms.values())
    return {k: abs(float(got[k].float().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep}


def compare(got: dict, want: dict, p0: dict, label: str = "") -> dict:
    """The numbers of a training check: `got` and `want` each hold the
    three steps' losses, the first step's preprocessor outputs and
    gradient, and the parameters and EMA after the last step; `p0` the
    parameters before the first. The first gradient is taken by its worst
    leaf; the change after three steps by its worst leaf, which a fault in
    any one leaf moves, and by its median leaf, which is steadier from seed
    to seed."""
    keys = list(p0)
    gnorm = {k: float(want["grad"][k].norm()) for k in keys}
    med = statistics.median(gnorm.values())
    # leaves whose gradient is nought to rounding move by round-off alone
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    grad = leaf_gaps(got["grad"], want["grad"], keys)
    update = leaf_gaps({k: got["params"][k] - p0[k] for k in moved},
                       {k: want["params"][k] - p0[k] for k in moved}, moved)
    ema = leaf_gaps({k: got["ema"][k] - p0[k] for k in moved},
                    {k: want["ema"][k] - p0[k] for k in moved}, moved)
    worst = {name: max(g.items(), key=lambda kv: kv[1])
             for name, g in (("update", update), ("ema", ema))}
    print(f"train check{label}: {len(keys) - len(moved)} of {len(keys)} "
          f"leaves left out of the change (reference gradient under 1e-3 of "
          f"the median leaf's): {sorted(set(keys) - set(moved))}; worst "
          f"leaves: {worst}", file=sys.stderr)
    n = got["latents"].shape[0]
    return {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in
                        zip(got["loss"], want["loss"])),
        "latents_rel": rel_rms(got["latents"], want["latents"][:n]),
        "context_rel": rel_rms(got["context"], want["context"][:n]),
        "grad_leaf": max(grad.values()),
        "update_leaf": worst["update"][1],
        "ema_leaf": worst["ema"][1],
        "update_median": statistics.median(update.values()),
        "ema_median": statistics.median(ema.values())}


@torch.no_grad()
def check(run):
    from port_bench.reference import nn as P
    from port_bench.reference import train as RT
    cap, m, dev = run.state["cap"], run.config["models"], run.device
    n = run.traffic["check_steps"]

    def ref(part, tag):
        return W.reference_model(part, m[part],
                                 build.draw_state(run, part, tag), dev)
    models = {"unet": ref("unet", "unet"), "vae": ref("vae", "vae"),
              "text": ref("text", "text"),
              "controlnet": ref("controlnet",
                                "controlnet.sam").requires_grad_(True)}
    p0 = {k: p.detach().clone() for k, p in
          models["controlnet"].named_parameters()}
    batches = [{k: cap[k][i].to(dev) for k in
                ("jpg", "hint", "ids", "t", "noise")} for i in range(n)]
    with P.fp32_exact(), torch.enable_grad():
        out = RT.steps(models, batches, lr=run.config["train"]["lr"])
    # Adam's first moment after one step is 0.1 of the first gradient
    got = {"loss": cap["loss"], "latents": cap["latents"].to(dev),
           "context": cap["context"].to(dev),
           "grad": {k: v.to(dev) / 0.1 for k, v in cap["exp_avg"].items()},
           "params": {k: v.to(dev) for k, v in cap["params"].items()},
           "ema": {k: v.to(dev) for k, v in cap["ema"].items()}}
    limits = run.traffic["check"]["limits"]
    for name, value in compare(got, out, p0).items():
        run.check(name, value, limits[name])
