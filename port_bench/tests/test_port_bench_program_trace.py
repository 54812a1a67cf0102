"""The readers of the program's own spans and counters
(``metrics/launches_per_step.py``, ``step_idle_share.py``,
``host_syncs.py``) on synthetic profiles, and on a tiny traced run."""

from __future__ import annotations

import sys
import types

import pytest

from port_bench import harness as H
from port_bench import program_trace as PT

MS = 1_000_000


def kernel(start, end, launch, name="k"):
    return (name, start, end, launch)


def fake_run(kind, *, profile=None, device_profile=None, units=1):
    return types.SimpleNamespace(
        traffic={"driver": kind, "trace": {"profile_units": units}},
        profile=profile, device_profile=device_profile)


def use_events(monkeypatch, evs):
    monkeypatch.setattr(PT, "events", lambda: evs)


def test_a_graph_replay_counts_one_launch(monkeypatch):
    """Eight kernels of one replay share its launch: one launch a step;
    a kernel launched outside every step counts for none."""
    device = H.Profile([], {}, [], (0, 10 * MS))
    steps = [("denoise.step", 20 * MS, 30 * MS, 0),
             ("denoise.step", 40 * MS, 50 * MS, 0)]
    graph = [kernel(21 * MS + i, 21 * MS + i + 1, 21 * MS) for i in range(8)]
    graph += [kernel(41 * MS + i, 41 * MS + i + 1, 41 * MS) for i in range(8)]
    eager = [kernel(42 * MS, 43 * MS, 42 * MS), kernel(35 * MS, 36 * MS,
                                                        35 * MS)]
    prof = H.Profile(graph + eager, {}, [], (15 * MS, 60 * MS))
    use_events(monkeypatch, steps)
    read = H.metric_reader("launches_per_step.edit")
    assert read(fake_run("edit", profile=prof, device_profile=device)) == \
        (1 + 2) / 2
    # a training cell reads its own step span, and finds none here
    assert read(fake_run("train", profile=prof,
                         device_profile=device)) is None
    # a cell with no step span reads nothing
    assert read(fake_run("sam", profile=prof, device_profile=device)) is None


def test_known_gaps_give_a_known_idle_share(monkeypatch):
    """Step 1: kernels 1-3 and 5-7 ms after its start (launched inside
    it), the last ending at 7: 3 ms idle of 7. Step 2: one kernel from 0
    to 3 ms: none idle. A kernel launched before step 1 and running into
    it is not the step's."""
    s1, s2 = 10 * MS, 30 * MS
    kernels = [kernel(s1 + 1 * MS, s1 + 3 * MS, s1 + 1),
               kernel(s1 + 5 * MS, s1 + 7 * MS, s1 + 2),
               kernel(s1 - MS, s1 + 2 * MS, s1 - 2 * MS),
               kernel(s2, s2 + 3 * MS, s2)]
    device = H.Profile(kernels, {}, [], (0, 40 * MS))
    use_events(monkeypatch, [("train.step", s1, s1 + 9 * MS, 0),
                             ("train.step", s2, s2 + 5 * MS, 0),
                             ("train.forward", s1, s1 + 2 * MS, 1)])
    read = H.metric_reader("step_idle_share.train")
    run = fake_run("train", device_profile=device)
    assert read(run) == pytest.approx(100.0 * 3 / (7 + 3))


def test_syncs_outside_the_attribution_sub_window_do_not_count(
        monkeypatch):
    """Counters in the device-only sub-window, or after the attribution
    one, are not the attribution sub-window's; spans named sync.* are
    the waits, not the counts."""
    device = H.Profile([], {}, [], (0, 10 * MS))
    prof = H.Profile([], {}, [], (12 * MS, 30 * MS))
    use_events(monkeypatch, [
        ("sync.a", 5 * MS, 1), ("sync.a", 10 * MS, 1),
        ("sync.a", 11 * MS, 1), ("sync.b", 20 * MS, 2),
        ("sync.a", 30 * MS, 1), ("sync.a", 31 * MS, 1),
        ("amg.kept", 20 * MS, 5), ("sync.b", 20 * MS, 21 * MS, 0)])
    read = H.metric_reader("host_syncs.sam")
    assert read(fake_run("sam", profile=prof, device_profile=device,
                         units=2)) == (1 + 2 + 1) / 2


def test_a_program_without_the_module_reads_nothing(monkeypatch):
    """The parent of the change that adds the program's trace module runs
    these readers too: they return None and do not raise."""
    import editanything_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "editanything_tpu_torch.utils.trace",
                        None)
    assert PT.events() is None
    prof = H.Profile([kernel(1, 2, 1)], {}, [], (0, 10))
    run = fake_run("edit", profile=prof, device_profile=prof)
    for name in ("launches_per_step.edit", "step_idle_share.edit",
                 "host_syncs.edit"):
        assert H.metric_reader(name)(run) is None, name


def test_tiny_traced_edit_reads_its_syncs(tiny):
    """On the CPU the profile holds no kernel, so the launch and idle
    readers find nothing; the program's sync counters are there: each
    edit request makes the same 15 waits."""
    run = tiny.run("edit_ui", trace=1)
    assert run.correct, run.checks
    assert H.metric_reader("host_syncs.edit")(run) == 15
    assert H.metric_reader("launches_per_step.edit")(run) is None
    steps = PT.step_spans(run, PT.attribution_bounds(run))
    assert len(steps) == run.traffic["steps"] * run.traffic["trace"][
        "profile_units"]
