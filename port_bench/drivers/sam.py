"""Driver of segment-everything traffic: back-to-back
``EditAnythingEditor.get_sam_control`` requests from one client (SAM's
encoder at 1024^2 after the long side is resized and the rest padded,
the 32 x 32-point AMG, the ID map at the image's size).

Traffic parameters (``cells/<traffic>.json``): ``sizes`` [[h, w], ...],
each drawn equally often, the pool of ``pool`` images the requests cycle
through in an order drawn from the seed, ``check`` (how many requests the
reference checks, drawn from the first ``within``, and how many candidate
logits of each it compares) and the limits of the compared numbers.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from port_bench import build, inputs
from port_bench import weights as W
from port_bench.capture import SamCapture, rel_max, rel_rms
from port_bench.counts import models as CM


def draw_requests(run):
    t = run.traffic
    rng = np.random.default_rng([run.seed % 2 ** 63, 1])
    sizes = [tuple(s) for s in t["sizes"]]
    per = -(-t["pool"] // len(sizes))
    order = rng.permutation(np.repeat(np.arange(len(sizes)), per))[:t["pool"]]
    g = torch.Generator(run.device).manual_seed(run.seed % 2 ** 63)
    return [inputs.photo(g, *sizes[k]) for k in order]


def check_plan(run, n_candidates: int, sizes=None):
    """The requests the reference checks, drawn from the seed among the
    window's first ``within`` (with the first of the largest images among
    them when `sizes`, each request's pixel count, is given), and the
    candidates whose logits it compares."""
    c = run.traffic["check"]
    rng = np.random.default_rng([run.seed % 2 ** 63, 2])
    keys = sorted(rng.choice(c["within"], c["requests"], replace=False)
                  .tolist())
    if sizes is not None:
        first = sizes[:c["within"]]
        big = first.index(max(first))
        if not any(first[k] == first[big] for k in keys):
            keys = sorted(keys[:-1] + [big])
    rows = np.sort(rng.choice(n_candidates, c["logit_rows"], replace=False))
    return keys, torch.from_numpy(rows)


def pixel_counts(run, images):
    """Each window request's image size, in the order the window sends."""
    return [images[i % len(images)].shape[0] * images[i % len(images)].shape[1]
            for i in range(run.traffic["check"]["within"])]


def setup(run):
    build.libraries(run)
    ed = build.editor(run, sd_weights=False)
    run.state["images"] = draw_requests(run)
    keys, rows = check_plan(run, 3 * run.config["amg"]["points_per_side"] ** 2,
                            pixel_counts(run, run.state["images"]))
    run.state.update(editor=ed, keys=set(keys), rows=rows, outputs={})
    run.state["capture"] = SamCapture(run, ed, rows.to(run.device))
    # every size the traffic sends, `warmup` times each
    first = {img.shape: img for img in reversed(run.state["images"])}
    for _ in range(run.traffic["warmup"]):
        for img in first.values():
            ed.get_sam_control(img)
    run.state["end_to_end"] = end_to_end


def end_to_end(run) -> dict:
    return {"sam_p95_ms": 1e3 * float(np.percentile(run.latencies, 95))}


def unit_flops(config: dict, traffic: dict) -> float:
    return CM.sam_request_flops(config, traffic)


def window(run):
    ed, cap, images = (run.state[k] for k in ("editor", "capture", "images"))
    run.begin_window()
    i = 0
    while True:
        cap.key = i if i in run.state["keys"] else None
        t0 = time.perf_counter()
        try:
            cond = ed.get_sam_control(images[i % len(images)])
            failed = False
        except Exception:
            traceback.print_exc(file=sys.stderr)
            cond, failed = None, True
        lat = time.perf_counter() - t0
        if cap.key is not None and cond is not None:
            run.state["outputs"][i] = cond
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


def reference_sam(run):
    from port_bench.reference import sam as RS
    m = run.config["models"]["sam"]
    sam = W.reference_model("sam", m, build.draw_state(run, "sam", "sam"),
                            run.device)
    amg = RS.AMGConfig(**{k: v for k, v in run.config["amg"].items()
                          if k in RS.AMGConfig.__dataclass_fields__})
    return sam, amg


def compare_sam(got: dict, want: dict, cond: np.ndarray, worst: dict):
    """Fold one request's SAM numbers into `worst`."""
    vals = {"embedding_rel": rel_max(got["embedding"], want["embedding"]),
            "iou_abs": float((got["iou"] - want["iou"].float()).abs().max()),
            "logits_rel": rel_rms(got["logits"], want["logits"]),
            "id_map_px": float((cond != want["id_map"]).any(-1).sum())}
    for k, v in vals.items():
        worst[k] = max(worst.get(k, 0.0), v)


@torch.no_grad()
def check(run):
    from port_bench.reference import edit as RE
    from port_bench.reference import nn as P
    store = run.state["capture"].store
    done = [k for k in sorted(run.state["outputs"]) if k in store]
    sam, amg = reference_sam(run)
    worst = {}
    with P.fp32_exact():
        for k in done:
            img = run.state["images"][k % len(run.state["images"])]
            want = RE.sam_condition(sam, amg, img, run.device,
                                    rows=run.state["rows"])
            compare_sam(store[k], want, run.state["outputs"][k], worst)
    limits = run.traffic["check"]["limits"]
    for name, value in worst.items():
        run.check(name, value, limits[name])
    run.check("unchecked", 0 if done else 1, 0)
