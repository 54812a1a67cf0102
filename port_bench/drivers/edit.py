"""Driver of edit traffic: back-to-back ``EditAnythingEditor.process``
requests from one client with no condition map, so each runs SAM at
``detect_resolution``, the AMG and its ID map, then the inpaint edit
(``num_samples`` samples, ``steps`` UniPC steps, CFG ``guidance``, the SAM
ControlNet at ``control_scale``, the inpaint ControlNet at 1) and the VAE
decode to uint8.

Traffic parameters (``cells/<traffic>.json``): the image size, the
brush mask's share of the area ``mask_share`` [lo, hi), the prompt list
and the UI's added and negative prompts, the pool of requests cycled
through, ``check`` and its limits. Each request's image, mask, prompt and
initial noise are drawn from the seed.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from port_bench import build, inputs
from port_bench import weights as W
from port_bench.capture import SamCapture, rel_rms
from port_bench.counts import models as CM
from port_bench.drivers import sam as sam_driver


def draw_requests(run):
    t = run.traffic
    rng = np.random.default_rng([run.seed % 2 ** 63, 1])
    h, w = t["image_hw"]
    s = t["num_samples"]
    g = torch.Generator(run.device).manual_seed(run.seed % 2 ** 63)
    reqs = []
    for _ in range(t["pool"]):
        prompt = t["prompts"][rng.integers(len(t["prompts"]))]
        reqs.append({
            "image": inputs.photo(g, h, w),
            "mask": inputs.brush_mask(rng, h, w, *t["mask_share"]),
            "prompt": prompt,
            "noise": torch.randn((s, h // 8, w // 8, 4), generator=g,
                                 device=run.device),
            "seed": int(rng.integers(2 ** 31))})
    return reqs


def process_args(run, req) -> dict:
    t = run.traffic
    return dict(image=req["image"], mask=req["mask"], prompt=req["prompt"],
                a_prompt=t["a_prompt"], n_prompt=t["n_prompt"],
                num_samples=t["num_samples"],
                image_resolution=t["image_hw"][0],
                detect_resolution=t["detect_resolution"],
                ddim_steps=t["steps"], scale=t["guidance"],
                control_scale=t["control_scale"], seed=req["seed"],
                sampler="unipc", noise=req["noise"])


def setup(run):
    build.libraries(run)
    ed = build.editor(run)
    run.state["requests"] = draw_requests(run)
    keys, rows = sam_driver.check_plan(
        run, 3 * run.config["amg"]["points_per_side"] ** 2)
    cap = SamCapture(run, ed, rows.to(run.device))
    latents = {}

    def denoise(orig):
        def fn(*args, **kwargs):
            with run.span("denoise"):
                out = orig(*args, **kwargs)
            if cap.key is not None:
                latents[cap.key] = out.detach().float().clone()
            return out
        return fn
    cap.replace(ed.pipe, "run_denoise", denoise)
    cap.replace(ed, "get_sam_control",
                lambda orig: run.wrap(orig, "sam_phase"))
    run.state.update(editor=ed, keys=set(keys), rows=rows, outputs={},
                     capture=cap, latents=latents)
    for i in range(run.traffic["warmup"]):
        req = run.state["requests"][i % len(run.state["requests"])]
        ed.process(**process_args(run, req))
    run.state["end_to_end"] = end_to_end


def end_to_end(run) -> dict:
    # the card's busy seconds per request, over every request of the window
    return {"edit_gpu_s": float(np.mean(run.unit_busy))}


def unit_flops(config: dict, traffic: dict) -> float:
    return CM.edit_request_flops(config, traffic)


def window(run):
    ed, cap, reqs = (run.state[k] for k in ("editor", "capture", "requests"))
    run.begin_window()
    i = 0
    while True:
        cap.key = i if i in run.state["keys"] else None
        with run.device_unit():
            t0 = time.perf_counter()
            try:
                _, images, (cond, _), _ = ed.process(
                    **process_args(run, reqs[i % len(reqs)]))
                failed = bool(ed.last_nonfinite)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                images, failed = None, True
            lat = time.perf_counter() - t0
        if cap.key is not None and images is not None:
            run.state["outputs"][i] = (np.stack(images), cond)
        i += 1
        # the window holds at least the requests the check draws from
        if (run.unit_done(lat, failed)
                and i >= run.traffic["check"]["within"]):
            break
    cap.key = None
    run.end_window()


def release(run):
    run.state["capture"].undo()
    run.state["editor"] = None


def reference_models(run):
    m = run.config["models"]
    sam, amg = sam_driver.reference_sam(run)

    def ref(part, tag):
        return W.reference_model(part, m[part],
                                 build.draw_state(run, part, tag), run.device)
    return {"unet": ref("unet", "unet"),
            "controlnets": [ref("controlnet", "controlnet." + n)
                            for n in run.config["controlnets"]],
            "vae": ref("vae", "vae"), "text": ref("text", "text"),
            "sam": sam, "amg": amg}


def reference_request(run, req) -> dict:
    t = run.traffic
    tok = inputs.WordTokenizer(
        run.config["models"]["text"]["max_position_embeddings"])
    cond_ids, uncond_ids = tok.windows(f"{req['prompt']}, {t['a_prompt']}",
                                       t["n_prompt"])
    return {"image": req["image"], "mask": req["mask"], "cond_ids": cond_ids,
            "uncond_ids": uncond_ids,
            "noise": req["noise"].permute(0, 3, 1, 2),
            "resolution": t["image_hw"][0],
            "detect_resolution": t["detect_resolution"],
            "rows": run.state["rows"]}


@torch.no_grad()
def check(run):
    from port_bench.reference import edit as RE
    from port_bench.reference import nn as P
    t = run.traffic
    store = run.state["capture"].store
    done = [k for k in sorted(run.state["outputs"]) if k in store]
    models = reference_models(run)
    worst = {}
    with P.fp32_exact():
        for k in done:
            req = run.state["requests"][k % len(run.state["requests"])]
            sam_out, final, images = RE.edit(
                models, reference_request(run, req), run.device,
                steps=t["steps"], guidance=t["guidance"],
                control_scale=t["control_scale"])
            got_images, cond = run.state["outputs"][k]
            sam_driver.compare_sam(store[k], sam_out, cond, worst)
            vals = {"latents_rel": rel_rms(run.state["latents"][k], final),
                    "image_mad": float(np.abs(got_images.astype(np.float64)
                                              - images).mean())}
            for name, v in vals.items():
                worst[name] = max(worst.get(name, 0.0), v)
    limits = t["check"]["limits"]
    for name, value in worst.items():
        run.check(name, value, limits[name])
    run.check("unchecked", 0 if done else 1, 0)
