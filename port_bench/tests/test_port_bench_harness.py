"""The harness as data: BENCHMARK.json against the benchmark's contract,
every file it names found by name, no module of JAX loaded, every cell run
end to end at a tiny size on the CPU, and each fault a cell can have,
planted under the timed path, turning ``correct`` false."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from port_bench import harness as H

NAME = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
           "0123456789_.-")
UNIT = NAME | set("/%")
BENCH = H.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def valid_name(s: str) -> bool:
    return (0 < len(s) <= 64 and set(s) <= NAME
            and (s[0].isalnum() or s[0] == "_"))


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # a full check fits 43200 s with 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_configs_and_cells():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert valid_name(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("port_bench/configs/")
        cfg = H.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(valid_name(k) for k in c["reduced"])
        assert 0 < len(c["why"]) <= 200 and 0 < len(c["source"]) <= 200
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert valid_name(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in names and 0 < len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        t = H.traffic(w["traffic"])
        assert H.driver(t["driver"]).setup
        assert t["check"]["limits"]
    assert used == names
    assert len(CELLS) == len(set(CELLS))


def test_metrics_entries():
    seen = set()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert valid_name(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert 0 < len(m["unit"]) <= 16 and set(m["unit"]) <= UNIT
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        # the moved metric is reported in every cell that reads this one
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", CELLS)
        assert callable(H.metric_reader(m["name"]))
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        e, layer = H.cell_metrics(cell)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert layer


def test_no_jax_in_harness_drivers_or_control():
    code = ("import sys; sys.path.insert(0, %r); "
            "import port_bench.run, port_bench.harness, port_bench.control, "
            "port_bench.drivers.edit, port_bench.drivers.sam, "
            "port_bench.drivers.train; "
            "from port_bench import harness as H; "
            "import editanything_tpu_torch.pipelines.editor, "
            "editanything_tpu_torch.train.train_controlnet; "
            "print(H.forbidden_modules())") % str(H.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import port_bench.reference.sd, port_bench.reference.sam, "
            "port_bench.reference.edit, port_bench.reference.train, "
            "port_bench.reference.image, port_bench.reference.nn, "
            "port_bench.counts.models, port_bench.counts.kernels; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('editanything_tpu_torch', 'editanything_tpu', 'jax', "
            "'jaxlib', 'flax')))") % str(H.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_exits_without_a_card_or_without_the_program(tmp_path):
    """No CUDA device: a non-zero exit and no result. A directory holding
    only BENCHMARK.json and port_bench/: the same."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    cmd = ["python3", "port_bench/run.py", "--workload", CELLS[0], "--seed",
           "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=H.REPO, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and "{" not in out.stdout
    shutil.copy(H.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(H.ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, tiny, monkeypatch):
    from port_bench import run as R
    run = tiny.run(cell)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    run.peak_bytes = 0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu")
    out = R.result(run)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    e2e, _ = H.cell_metrics(cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    # a metric from the device's trace profiles every unit of the window
    if any(m["source"] == "device_trace" for m in e2e):
        assert len(run.unit_busy) == run.units
        assert all(b > 0 for b in run.unit_busy)
    else:
        assert not run.unit_busy


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_spans(cell, tiny):
    run = tiny.run(cell, trace=1)
    assert run.correct, run.checks
    assert run.profile is not None and run.spans
    _, layer = H.cell_metrics(cell)
    read = {m["name"]: H.metric_reader(m["name"])(run) for m in layer}
    for name, value in read.items():
        if m_is_span(name):
            assert value is not None and value > 0, name


def m_is_span(name: str) -> bool:
    return name.split(".")[0].endswith("_ms")


def test_request_s_reads_the_units_after_the_profiled_ones(tiny):
    run = tiny.run("edit_ui", trace=1)
    assert not run.unit_busy
    after = run.latencies[run.prof_units:]
    assert after
    assert H.metric_reader("request_s.edit")(run) == sum(after) / len(after)


def test_traced_run_profiles_device_then_attribution(tiny):
    run = tiny.run("sam_amg", trace=1)
    n = run.traffic["trace"]["profile_units"]
    assert run.device_profile is not None and run.profile is not None
    assert run.prof_units == 2 * n and all(s > 0 for s in run.prof_s)
    # kernel shapes are recorded in the attribution sub-window alone:
    # n units' worth, the same calls in each unit
    assert run.entry_calls["D"] and run.entry_calls["C"]
    assert len(run.entry_calls["D"]) % n == 0


def test_metric_reader_falls_back_to_the_base_name():
    assert H.metric_reader("idle_share.anycell") is \
        H.metric_reader("idle_share.edit")
    assert H.metric_reader("roofline_B.train") is \
        H.metric_reader("roofline_B.edit")
    with pytest.raises(KeyError):
        H.metric_reader("no_such_metric.edit")


# -- a new cell, driver, metric, kernel entry and model part: files only ----

STUB_BENCH = {
    "workloads": [{"name": "stub_cell", "config": "toycfg",
                   "traffic": "stub_mix", "chips": 1, "why": "a stub"}],
    "end_to_end": [
        {"name": "stub_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["stub_cell"]},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": "program_span",
         "layer": "stub", "moves": "stub_s", "workloads": ["stub_cell"]}
        for n, u, b in (("toy_ms.stub", "ms", "lower"),
                        ("mfu.stub", "%", "higher"),
                        ("idle_share.stub", "%", "lower"),
                        ("roofline_Z.stub", "%", "higher"))]}

STUB_DRIVER = '''
import time

import torch

from port_bench import weights as W


def kernel(x):
    return x @ x.T


def setup(run):
    fields = run.config["models"]["toy"]
    state = W.model_weights("toy", fields, run.seed, "toy", run.device,
                            torch.float32)
    run.state["model"] = W.reference_model("toy", fields, state, run.device)
    run.state["x"] = torch.ones(run.traffic["rows"], fields["width"])
    run.state["end_to_end"] = lambda run: {
        "stub_s": sum(run.latencies) / len(run.latencies)}


def window(run):
    run.begin_window()
    while True:
        t0 = time.perf_counter()
        with run.span("toy"):
            y = kernel(run.state["model"](run.state["x"]))
        if run.unit_done(time.perf_counter() - t0):
            break
    run.state["y"] = y
    run.end_window()


def release(run):
    run.state["model"] = None


def check(run):
    fields = run.config["models"]["toy"]
    state = W.model_weights("toy", fields, run.seed, "toy", run.device,
                            torch.float32)
    h = run.state["x"] @ state["weight"].T + state["bias"]
    run.check("gap", float((run.state["y"] - h @ h.T).abs().max()), 1e-4)


def unit_flops(config, traffic):
    w, n = config["models"]["toy"]["width"], traffic["rows"]
    return 2.0 * n * w * w + 2.0 * n * n * w
'''

STUB_FILES = {
    "cells/stub_mix.json": json.dumps({
        "driver": "stub", "rows": 4, "trace": {"profile_units": 2},
        "check": {"limits": {"gap": 1e-4}}}),
    "configs/toycfg.json": json.dumps({
        "name": "toycfg", "dtype": "float32", "models": {"toy": {"width": 8}}}),
    "drivers/stub.py": STUB_DRIVER,
    "parts/toy.py": (
        "import torch\n\n\n"
        "def reference(fields):\n"
        "    return (lambda w: torch.nn.Linear(w, w)), fields['width']\n\n\n"
        "port = reference\n"),
    "entries/Z.py": (
        "import sys\n\n\n"
        "def target():\n"
        "    return sys.modules['port_bench.drivers.stub'], 'kernel'\n\n\n"
        "def shapes(x):\n    return tuple(x.shape)\n\n\n"
        "def bound_s(s):\n    return 2.0 * s[0] * s[0] * s[1] / 1e12\n"),
    "metrics/toy_ms.stub.py": (
        "from port_bench import harness as H\n\n\n"
        "def read(run):\n    return H.span_ms(run, 'toy')\n"),
}


@pytest.mark.parametrize("trace", [0, 1])
def test_new_driver_metric_entry_and_part_are_files_only(tmp_path, trace,
                                                         monkeypatch):
    """A cell with a driver, traffic, configuration, model part, kernel
    entry and metric reader that the harness has never seen, each a file
    in a folder of its own, runs end to end with no edit to the harness;
    the generic readers (mfu, idle_share, roofline_<kernel>) serve it."""
    from port_bench import run as R
    root = tmp_path / "port_bench"
    for rel, text in STUB_FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    for generic in ("mfu", "idle_share", "roofline_B"):
        text = (H.ROOT / "metrics" / f"{generic}.py").read_text()
        if generic == "roofline_B":
            generic, text = "roofline_Z", text.replace('"B"', '"Z"')
        (root / "metrics" / f"{generic}.py").write_text(text)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(STUB_BENCH))
    monkeypatch.setattr(H, "ROOT", root)
    monkeypatch.setattr(H, "REPO", tmp_path)
    kinds = ("drivers", "metrics", "entries", "parts")
    for name in [m for m in sys.modules
                 if m.split(".")[:2] in [["port_bench", k] for k in kinds]]:
        monkeypatch.delitem(sys.modules, name)
    before = set(sys.modules)
    try:
        args = types.SimpleNamespace(workload="stub_cell", seed=2 ** 31 + 5,
                                     seconds=0.3, trace=trace)
        run = R.execute(args, "cpu")
        assert run.correct, run.checks
        run.peak_bytes = 0
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu")
        out = R.result(run)
    finally:
        for name in set(sys.modules) - before:
            if name.split(".")[:2] in [["port_bench", k] for k in kinds]:
                del sys.modules[name]
    if trace:
        assert run.entry_calls["Z"] and run.unit_flops == 2.0 * (
            4 * 8 * 8 + 4 * 4 * 8)
        assert {"toy_ms.stub", "mfu.stub", "idle_share.stub"} <= \
            set(out["metrics"])
        # no device kernels on the CPU: the roofline finds nothing to read
        assert "roofline_Z.stub" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"stub_s", "setup_s"}


# -- faults under the timed path ------------------------------------------

def _unchanged_step(monkeypatch):
    from editanything_tpu_torch.samplers import unipc
    orig = unipc.unipc_step

    def step(schedule, state, out, ts, **kw):
        new, _ = orig(schedule, state, out, ts, **kw)
        return new._replace(sample=state.sample), state.sample
    monkeypatch.setattr(unipc, "unipc_step", step)


def _altered_images(monkeypatch):
    from editanything_tpu_torch.pipelines.generate import GenerationPipeline
    orig = GenerationPipeline.decode

    def decode(self, latents):
        imgs = orig(self, latents)
        return (imgs.astype("int16") + 16).clip(0, 255).astype("uint8")
    monkeypatch.setattr(GenerationPipeline, "decode", decode)


def _altered_iou(monkeypatch):
    from editanything_tpu_torch.perception import amg
    orig = amg.decode_candidates

    def decode(*args, **kwargs):
        logits, iou = orig(*args, **kwargs)
        return logits, iou + 0.05
    monkeypatch.setattr(amg, "decode_candidates", decode)


def _skipped_layer(monkeypatch):
    from editanything_tpu_torch.models import sam
    monkeypatch.setattr(sam.EncoderBlock, "forward", lambda self, x: x)


def _frozen_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _wrap_train_step(monkeypatch, change):
    from editanything_tpu_torch.train import train_controlnet as TC
    orig = TC.make_train_step

    def make(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def step(state, unet, batch, **kw):
            return change(fn, state, unet, batch, **kw)
        return step
    monkeypatch.setattr(TC, "make_train_step", make)


def _half_batch(monkeypatch):
    def change(fn, state, unet, batch, *, t, noise, **kw):
        h = t.shape[0] // 2
        return fn(state, unet, {k: v[:h] for k, v in batch.items()},
                  t=t[:h], noise=noise[:h], **kw)
    _wrap_train_step(monkeypatch, change)


def _altered_loss(monkeypatch):
    def change(fn, state, unet, batch, **kw):
        state, m = fn(state, unet, batch, **kw)
        return state, {**m, "loss": m["loss"] * 1.001}
    _wrap_train_step(monkeypatch, change)


FAULTS = {
    "edit_ui": {"unchanged_step": _unchanged_step,
                "altered_images": _altered_images},
    "sam_amg": {"altered_iou": _altered_iou,
                "skipped_layer": _skipped_layer},
    "train_b4": {"frozen_state": _frozen_state, "half_batch": _half_batch,
                 "altered_loss": _altered_loss},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS.get(c, {})])
def test_fault_is_incorrect(cell, fault, tiny, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    run = tiny.run(cell)
    assert not run.correct, run.checks


# -- the controls: the reference one precision lower, in the program's place

def _control_readings(cell, variant, tiny, device="cpu"):
    from port_bench import control as C
    entry, traffic, config = tiny.cell(cell)
    run = H.Run(cell=cell, seed=2 ** 31 + 23, seconds=0.0, trace=False,
                device=device, entry=entry, traffic=traffic, config=config)
    if traffic["driver"] == "train":
        return traffic, C.train_readings(run, variant)
    fn = C.edit_readings if traffic["driver"] == "edit" else C.sam_readings
    return traffic, fn(run, variant)


@pytest.mark.parametrize("cell,variant", [("edit_ui", "fp8"),
                                          ("sam_amg", "fp8"),
                                          ("train_b4", "half")])
def test_control_fails_a_number(cell, variant, tiny):
    traffic, readings = _control_readings(cell, variant, tiny)
    limits = traffic["check"]["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.cuda
def test_tf32_control_fails_a_number(cuda, tiny):
    traffic, readings = _control_readings("train_b4", "tf32", tiny, "cuda")
    limits = traffic["check"]["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings
