"""The port's tracer (sparf_tpu_torch/utils/tracing.py) on the CPU: off it
records nothing, under torch.profiler its records nest by parent and unit
and agree with the profiler's events on one clock, a tiny training step and
a tiny frame give the span tree of the layers, the launch and collective
counters live in it, and the benchmark's program_span readers read it."""
import dataclasses
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (two torch threads per worker)

from benchmark import harness
from sparf_tpu_torch.ops import fused_mlp as fm
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.utils import tracing


def _paths(rep, unit=None):
    """Counter of each record's path of names from its root."""
    out = Counter()
    for i, r in enumerate(rep.records):
        if unit is not None and r.unit != unit:
            continue
        names = []
        while i >= 0:
            names.append(rep.records[i].name)
            i = rep.records[i].parent
        out["/".join(reversed(names))] += 1
    return out


def test_off_records_nothing_and_returns_the_shared_noop():
    tracing.enable()
    tracing.disable()
    assert not tracing.is_on()
    s = tracing.span("step")
    assert s is tracing.span("mlp.forward") is tracing.wait("x")
    with s, tracing.span("mlp.forward"), tracing.wait("test_off"):
        pass
    tracing.count("test_off.counter", 2)
    rep = tracing.report()
    assert rep.records == [] and rep.units == {}
    # counters stay on
    assert rep.counts["test_off.counter"] >= 2


def test_decorated_function_keeps_its_name_and_records_each_call():
    @tracing.traced("frame")
    def render(x):
        """doc"""
        return x + 1

    assert render.__name__ == "render" and render.__doc__ == "doc"
    assert render(1) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        render(1)
        render(2)
    rep = tracing.report()
    assert [r.name for r in rep.records] == ["frame", "frame"] and rep.units == {"frame": 2}
    # the ops' own entry points are the decorated functions, under their names
    assert fm.nerf_apply_fused.__name__ == "nerf_apply_fused"


def test_records_nest_by_parent_and_unit_across_threads():
    def worker():
        with tracing.span("mlp.backward"), tracing.span("mlp.launch"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("render.chunk"):
            pass
        for _ in range(2):
            with tracing.span("step"):
                with tracing.span("step.losses"), tracing.wait("lr"):
                    pass
                with tracing.span("step.backward"):
                    th = threading.Thread(target=worker)
                    th.start()
                    th.join(timeout=30)
                    assert not th.is_alive()
    rep = tracing.report()
    assert rep.units == {"step": 2}
    steps = [i for i, r in enumerate(rep.records) if r.name == "step"]
    assert rep.records[0].unit is None and rep.records[0].parent == -1
    for u in steps:
        assert rep.records[u].unit == u
        assert _paths(rep, unit=u) == Counter({
            "step": 1, "step/step.losses": 1, "step/step.losses/wait": 1,
            "step/step.backward": 1, "step/step.backward/mlp.backward": 1,
            "step/step.backward/mlp.backward/mlp.launch": 1})
    main = rep.records[steps[0]].thread
    backward = [r for r in rep.records if r.name == "mlp.backward"]
    assert all(r.thread != main for r in backward)
    waits = [r for r in rep.records if r.name == "wait"]
    assert [r.site for r in waits] == ["lr", "lr"]
    for r in rep.records:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = rep.records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_a_new_window_drops_the_last():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("step"):
            pass
    # the window outlives its profiler, and spans off do not touch it
    with tracing.span("frame"):
        pass
    assert tracing.report().units == {"step": 1}
    assert tracing.report().units == {"step": 1}
    # a profiler that starts begins a window, with no span or report between
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("step"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("frame"):
            pass
    assert tracing.report().units == {"frame": 1}
    tracing.enable()
    try:
        assert tracing.report().records == [] and tracing.is_on()
        with tracing.span("step"):
            pass
        # enabled, the tracer is already on: a profiler keeps its window
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("frame"):
                pass
    finally:
        tracing.disable()
    assert tracing.report().units == {"step": 1, "frame": 1}


def test_a_windows_records_are_no_objects_the_gc_tracks():
    """The records are flat lists of ints and strings: spans add nothing to
    the garbage collector's work, however many a window holds."""
    import gc

    tracing.enable()
    try:
        gc.collect()
        before = len(gc.get_objects())
        for _ in range(2000):
            with tracing.span("step"), tracing.wait("gc"):
                pass
        after = len(gc.get_objects())
    finally:
        tracing.disable()
    assert after - before < 50
    assert not any(gc.is_tracked(x) for x in tracing._T.opens + tracing._T.ends)
    rep = tracing.report()
    assert rep.units == {"step": 2000} and len(rep.records) == 4000
    assert [r.site for r in rep.records[:2]] == [None, "gc"] and rep.records[1].parent == 0


def test_records_agree_with_the_profilers_events():
    """The shared clock: each record's start and end lie where the profiler's
    event of the same span does, to within the profiler's cost of a range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with tracing.span("step"):
                torch.ones(64, 64).sum()
                with tracing.span("mlp.launch"):
                    torch.ones(64, 64).sum()
    rep = tracing.report()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("step", "mlp.launch")), key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [r.name for r in rep.records]
    d_start = np.array([r.start_ns - e.start_ns() for r, e in zip(rep.records, events)])
    d_end = np.array([r.end_ns - e.end_ns() for r, e in zip(rep.records, events)])
    # another clock (the monotonic one, say) would sit days away
    assert np.abs(d_start).max() < 1e6 and np.abs(d_end).max() < 1e6
    assert np.median(np.abs(d_start)) < 20e3 and np.median(np.abs(d_end)) < 20e3


@pytest.fixture(scope="module")
def tiny_trainer():
    from sparf_tpu_torch.scripts import profile_step

    return profile_step.build_trainer(True, "float32", False, "cpu")


def test_a_training_step_gives_the_span_tree(tiny_trainer):
    from sparf_tpu_torch.scripts import profile_step

    tr = tiny_trainer
    it = profile_step.stage_iteration(tr, "fine")
    state = dataclasses.replace(tr.state, iteration=it, iteration_nerf=it)
    step = tr.get_step(it)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, tr.draws)
    rep = tracing.report()
    assert rep.units == {"step": 1}
    paths = _paths(rep)
    assert set(paths) >= {
        "step", "step/step.poses", "step/step.losses", "step/step.backward", "step/step.update",
        "step/step.losses/loss.photometric", "step/step.losses/loss.corres",
        "step/step.losses/loss.depth_cons", "step/step.losses/render.bundles",
        "step/step.losses/render.bundles/render.coarse",
        "step/step.losses/render.bundles/render.fine",
        "step/step.losses/render.bundles/render.composite",
        "step/step.losses/render.bundles/render.coarse/mlp.forward/mlp.encode",
        "step/step.losses/render.bundles/render.coarse/mlp.forward/mlp.launch",
        "step/step.backward/mlp.backward/mlp.launch"}
    # no mesh, no reduce; every span of the window is the step's
    assert "step/step.reduce" not in paths
    assert all(r.unit == 0 for r in rep.records)
    # one backward per forward that carried a gradient (the ones without a
    # weight layout for K3)
    packed = {r.parent for r in rep.records if r.name == "mlp.pack"}
    forwards = [i for i, r in enumerate(rep.records) if r.name == "mlp.forward"]
    assert paths["step/step.backward/mlp.backward"] == len(set(forwards) - packed) > 0


def test_a_frame_gives_the_span_tree(tiny_trainer):
    tr = tiny_trainer
    with profile(activities=[ProfilerActivity.CPU]):
        tr.render_full_image(tr.train_scene, 0, tr.train_scene["pose"][:1], True)
    rep = tracing.report()
    assert rep.units == {"frame": 1}
    paths = _paths(rep)
    n_chunks = paths["frame/render.chunk"]
    assert n_chunks == -(-tr.H * tr.W // int(tr.cfg.nerf.rand_rays))
    for level in ("coarse", "fine"):
        for part in ("mlp.encode", "mlp.pack", "mlp.launch"):
            assert paths[f"frame/render.chunk/render.{level}/mlp.forward/{part}"] == n_chunks
    assert paths["frame/render.chunk/render.composite"] == 2 * n_chunks


def test_profile_step_reports_the_set_up_and_the_spans(capsys):
    from sparf_tpu_torch.scripts import profile_step

    res = profile_step.main(["--tiny", "--steps", "2", "--device", "cpu", "--warmup", "1"])
    capsys.readouterr()
    assert not tracing.is_on()
    assert set(res["setup_ms"]) >= {"setup.config", "setup.scene", "setup.networks",
                                    "setup.optimizer", "setup.pools"}
    assert all(ms > 0 for ms in res["setup_ms"].values())
    spans = res["spans"]
    assert spans["step"]["calls_per_step"] == spans["step.backward"]["calls_per_step"] == 1.0
    assert spans["mlp.backward"]["calls_per_step"] > 0
    # the host blocks nowhere in a step: no wait by any site
    assert not [name for name in spans if name.startswith("wait")]
    assert all(row["idle_ms_per_step"] is None and row["self_ms_per_step"] >= 0
               for row in spans.values())
    # the steps' self times add up to no more than the traced window
    assert sum(row["self_ms_per_step"] for row in spans.values()) <= res["window_ms_per_step"]


def test_launch_counts_live_in_the_tracers_counters():
    assert not any(k.endswith("_LAUNCHES") for k in vars(fm))
    fm.reset_launch_counts()
    assert fm.launch_counts() == fm.launch_counts(bf16=True) == dict(K1=0, K2=0, K3=0, pack=0)
    fm._counted("K1", False)
    fm._counted("K1", False)
    fm._counted("K3", True)
    fm._counted("pack", True)
    assert fm.launch_counts() == dict(K1=2, K2=0, K3=0, pack=0)
    assert fm.launch_counts(bf16=True) == dict(K1=0, K2=0, K3=1, pack=1)
    assert tracing.counts("launch.") == {"K1": 2, "K3.bf16": 1, "pack.bf16": 1, **{
        k: 0 for k in tracing.counts("launch.") if k not in ("K1", "K3.bf16", "pack.bf16")}}
    fm.reset_launch_counts()
    assert fm.launch_counts() == fm.launch_counts(bf16=True) == dict(K1=0, K2=0, K3=0, pack=0)


def test_collective_bytes_live_in_the_tracers_counters():
    assert not hasattr(mesh_mod, "COLLECTIVE_BYTES")
    mesh_mod.reset_collective_bytes()
    assert mesh_mod.collective_bytes() == dict(all_reduce=0, broadcast=0, gather=0)
    mesh_mod._sent("all_reduce", 40)
    mesh_mod._sent("gather", 8)
    mesh_mod._sent("all_reduce", 2)
    assert mesh_mod.collective_bytes() == dict(all_reduce=42, broadcast=0, gather=8)
    assert tracing.counts("collective_bytes.")["all_reduce"] == 42
    mesh_mod.reset_collective_bytes()
    assert mesh_mod.collective_bytes() == dict(all_reduce=0, broadcast=0, gather=0)


# -------------------------------------------------------------------------
# the benchmark's program_span readers
# -------------------------------------------------------------------------

MS = 1_000_000


def _report(kind: str):
    """Two units of `kind`, times in ms. Unit 0 (0-10): mlp.forward 1-4 with a
    wait 2-3 inside, a wait 5-6, mlp.backward 7-9 on another thread; unit 1
    (20-30): mlp.launch 21-22. Per unit: wait 1, mlp 2.5, torch 6.5."""
    R = tracing.Record
    recs = [R(kind, -1, 0, 1, 0, 10 * MS), R("mlp.forward", 0, 0, 1, 1 * MS, 4 * MS),
            R("wait", 1, 0, 1, 2 * MS, 3 * MS, "x"), R("wait", 0, 0, 1, 5 * MS, 6 * MS, "y"),
            R("mlp.backward", 0, 0, 2, 7 * MS, 9 * MS),
            R(kind, -1, 5, 1, 20 * MS, 30 * MS), R("mlp.launch", 5, 5, 1, 21 * MS, 22 * MS),
            R("render.chunk", -1, None, 1, 40 * MS, 41 * MS)]
    return tracing.Report(recs, {kind: 2}, {})


READINGS = {"mlp_host_ms": 2.5, "torch_host_ms": 6.5, "host_wait_ms": 1.0}


@pytest.mark.parametrize("kind,unit", [("train", "step"), ("render", "frame")])
@pytest.mark.parametrize("metric", sorted(READINGS))
def test_program_span_readers_read_the_report(monkeypatch, metric, kind, unit):
    monkeypatch.setattr(tracing, "report", lambda: _report(unit))
    rec = dict(kind=kind, units=2, trace=dict(busy_s=1.0, window_s=2.0))
    assert harness.read_metric(f"{metric}.{kind}", rec) == pytest.approx(READINGS[metric])
    # the three parts add up to the unit span's length
    assert sum(harness.read_metric(f"{m}.{kind}", rec) for m in READINGS) == pytest.approx(10.0)
    # another cell kind's reader reads nothing here
    other = "render" if kind == "train" else "train"
    assert harness.read_metric(f"{metric}.{other}", rec) is None


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_program_span_readers_read_nothing_without_a_matching_report(monkeypatch, metric):
    monkeypatch.setattr(tracing, "report", lambda: _report("step"))
    traced = dict(kind="train", units=2, trace=dict(busy_s=1.0, window_s=2.0))
    assert harness.read_metric(f"{metric}.train", traced) is not None
    # another number of units than the window ran, or no trace
    assert harness.read_metric(f"{metric}.train", dict(traced, units=3)) is None
    assert harness.read_metric(f"{metric}.train", dict(traced, trace=None)) is None
    # a program without the tracer (an older checkout)
    import sparf_tpu_torch.utils

    monkeypatch.delattr(sparf_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "sparf_tpu_torch.utils.tracing", None)
    assert harness.read_metric(f"{metric}.train", traced) is None
