#!/usr/bin/env python
"""Profile the SPARF training step of the port: a torch.profiler trace of N
steps at one stage, device time by category, the busy and idle share of
the traced window, and the port's own spans (utils/tracing.py) over the
set-up and the traced steps (the counterpart of scripts/profile_step.py).

    python -m sparf_tpu_torch.scripts.profile_step [--stage fine|coarse] [--steps 10]
        [--dtype float32|bfloat16] [--merged] [--tiny] [--device cuda|cpu]

The step is the bench.py full shape (300x400 synthetic scene, 1024
photometric, 2x512 correspondence and 3x1024 depth-consistency rays, 128 +
128 samples, the 8x256 MLP, GT-depth correspondences) unless --tiny. It
prints a table of the device kernels by time, the set-up by span, a table of
the spans of the traced steps, then one JSON line: ms per step by category
(K1, K2's three parts, K3 and the weight layouts (k_pack, and k_wg_layout of
the bf16 K1 / K2) by kernel name, then GEMM, elementwise, reduction, sort,
memcpy, collective, other), the traced window per step and the share of it
in which the device ran a kernel; `setup_ms`, the set-up's spans
(`setup.config`, `setup.scene`, `setup.networks` with the initial poses,
`setup.optimizer`, `setup.pools`, `setup.kernels`: the kernel library's
build or load, in the first step) in ms; `spans`, per span name of the
traced steps (a wait by its site, `wait[<site>]`), its calls per step, its
host self time in ms per step (its length less its children's) and the
device's idle ms per step while it was the innermost open span (null on the
CPU); and `syncs_outside_wait_per_step`, the CUDA runtime's synchronisations
per traced step that no `wait` span holds (0 when every place where the host
blocks is named; null on the CPU).

On a CUDA device the categories sum device kernel events (DeviceType.CUDA);
the window is the host clock between the synchronisations before and after
the traced steps, so the idle share includes the host's gaps. On the CPU
(--device cpu, for the tests) there is no device trace: the categories sum
the self time of the CPU operators and the busy and idle shares are null.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from sparf_tpu_torch.utils import tracing

CATEGORIES = ("K1", "k2_backward", "k2_dw", "k2_reduce", "K3", "k_pack", "gemm", "elementwise",
              "reduction", "sort", "memcpy", "collective", "other")

# the CUDA runtime's records of a host that blocks on the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
         "cudaMemcpy2D")


def categorize(name: str) -> str:
    """The category of a kernel (or, on the CPU, operator) name."""
    n = name.lower()
    for key, cat in (("k1_forward", "K1"), ("k1_wg", "K1"), ("k2_backward", "k2_backward"),
                     ("k2_wg", "k2_backward"), ("k2_dw", "k2_dw"), ("k2_reduce", "k2_reduce"),
                     ("k3_forward", "K3"), ("k3_wg", "K3"), ("k_pack", "k_pack"),
                     ("k_wg_layout", "k_pack")):
        if key in n:
            return cat
    if any(k in n for k in ("nccl", "gloo", "all_reduce", "allreduce", "broadcast")):
        return "collective"
    if any(k in n for k in ("memcpy", "memset", "aten::copy_", "aten::to", "aten::clone")):
        return "memcpy"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "matmul", "aten::mm", "aten::bmm",
                            "aten::addmm", "aten::linear", "dot_kernel")):
        return "gemm"
    if "sort" in n:
        return "sort"
    if any(k in n for k in ("reduce", "aten::sum", "aten::mean", "aten::amax", "aten::amin",
                            "aten::max", "aten::min", "cumsum", "scan", "aten::norm",
                            "aten::linalg_vector_norm", "aten::all", "aten::any")):
        return "reduction"
    if any(k in n for k in ("elementwise", "vectorized", "unrolled", "aten::")):
        return "elementwise"
    return "other"


def build_trainer(tiny: bool, dtype: str, merged: bool, device: str):
    from sparf_tpu_torch.parallel.dryrun import FULL, TINY_GT
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    over = dict(TINY_GT if tiny else FULL)
    over["tpu"] = dict(compute_dtype=dtype, merged_render=merged)
    with tracing.span("setup.config"):
        cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
    return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_profile_"),
                          device=device, save_option=False)


def stage_iteration(trainer, stage: str) -> int:
    ratio = float(trainer.cfg.get("ratio_end_joint_nerf_pose_refinement") or 0.3)
    return 0 if stage == "coarse" else int(trainer.cfg.max_iter * (ratio + 0.05))


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _row(r) -> str:
    """A span's row in the table: a wait by its site, `wait[<site>]`."""
    return r.name if r.site is None else f"{r.name}[{r.site}]"


def _innermost(records) -> Tuple[List[int], List[Optional[str]]]:
    """Segments of the timeline, each named after the innermost span open in
    it (the latest to open of those open, on any thread): (starts, names)."""
    starts: List[int] = []
    names: List[Optional[str]] = []
    stack: List[Tuple[int, str]] = []

    def emit(t: int):
        name = stack[-1][1] if stack else None
        if not names or names[-1] != name:
            starts.append(t)
            names.append(name)

    for r in sorted(records, key=lambda r: (r.start_ns, -r.end_ns)):
        while stack and stack[-1][0] <= r.start_ns:
            emit(stack.pop()[0])
        stack.append((r.end_ns, _row(r)))
        emit(r.start_ns)
    while stack:
        emit(stack.pop()[0])
    return starts, names


def span_table(records: Dict, steps: int, idle_ns: Optional[List[Tuple[int, int]]]) -> Dict:
    """Per span name (a wait by its site) of `records` (tracing.Record by its
    index in the report): calls, host self ms (length less the children's)
    and, given the device's idle intervals, the idle ms while it was the
    innermost open span; all per step."""
    child_ns: Dict[int, int] = defaultdict(int)
    for r in records.values():
        if r.parent >= 0:
            child_ns[r.parent] += r.end_ns - r.start_ns
    rows: Dict[str, Dict] = defaultdict(lambda: dict(calls=0, self_ns=0, idle_ns=0))
    for i, r in records.items():
        row = rows[_row(r)]
        row["calls"] += 1
        row["self_ns"] += r.end_ns - r.start_ns - child_ns[i]
    if idle_ns is not None:
        starts, names = _innermost(records.values())
        for s, e in idle_ns:
            k = max(bisect.bisect_right(starts, s) - 1, 0)
            while k < len(starts) and starts[k] < e:
                seg_end = starts[k + 1] if k + 1 < len(starts) else e
                if names[k] is not None:
                    rows[names[k]]["idle_ns"] += min(e, seg_end) - max(s, starts[k])
                k += 1
    return {n: dict(calls_per_step=v["calls"] / steps, self_ms_per_step=v["self_ns"] / 1e6 / steps,
                    idle_ms_per_step=None if idle_ns is None else v["idle_ns"] / 1e6 / steps)
            for n, v in sorted(rows.items(), key=lambda kv: -kv[1]["self_ns"])}


def profile(trainer, stage: str, steps: int, warmup: int = 2) -> Dict:
    """Trace `steps` steps of the stage after `warmup`; returns the summary
    (the per-kernel table under "kernels"). The spans are read from the
    tracer's report: set-up is covered when tracing was enabled before the
    trainer was built."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    cuda = trainer.device.type == "cuda"
    it = stage_iteration(trainer, stage)
    state = dataclasses.replace(trainer.state, iteration=it, iteration_nerf=it)
    step = trainer.get_step(it)

    def sync():
        if cuda:
            with tracing.wait("profile_step.sync"):
                torch.cuda.synchronize(trainer.device)

    for _ in range(warmup):
        state, stats = step(state, trainer.draws)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=activities) as prof:
        traced_from = time.time_ns()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, stats = step(state, trainer.draws)
        sync()
        window_us = (time.perf_counter() - t0) * 1e6
        traced_to = time.time_ns()
    by_cat: Dict[str, float] = dict.fromkeys(CATEGORIES, 0.0)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if cuda != on_device:
            continue
        us = e.time_range.elapsed_us() if cuda else e.self_cpu_time_total
        if cuda:
            intervals.append((e.time_range.start, e.time_range.end))
        by_cat[categorize(e.name)] += us
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
    busy = _busy_us(intervals) if cuda else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:30]
    rep = tracing.report()
    setup_ms: Dict[str, float] = defaultdict(float)
    for r in rep.records:
        if r.name.startswith("setup.") and r.end_ns is not None:
            setup_ms[r.name] += (r.end_ns - r.start_ns) / 1e6
    traced = {i: r for i, r in enumerate(rep.records) if r.end_ns is not None
              and r.unit is not None and traced_from <= r.start_ns and r.end_ns <= traced_to}
    idle = unwaited = None
    if cuda:
        raw = prof.profiler.kineto_results.events()
        # the device's idle intervals inside the window, on the clock of the spans (the
        # profiler's synchronisation records are no device work)
        busy_ns = sorted((e.start_ns(), e.end_ns()) for e in raw
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and not e.name().endswith(" Sync") and e.name() != "Stream Wait Event")
        idle, prev = [], traced_from
        for s, e in busy_ns + [(traced_to, traced_to)]:
            if s > prev:
                idle.append((prev, min(s, traced_to)))
            prev = max(prev, e)
        # host synchronisations of the traced steps that no `wait` span holds
        cpu = [e for e in raw if e.device_type() == torch.autograd.DeviceType.CPU]
        waits = [(e.start_thread_id(), e.start_ns(), e.end_ns()) for e in cpu if e.name() == "wait"]

        def held(e) -> bool:
            return any(t == e.start_thread_id() and s <= e.start_ns() and e.end_ns() <= f
                       for t, s, f in waits)

        unwaited = sum(1 for e in cpu if e.name() in SYNCS
                       and traced_from <= e.start_ns() <= traced_to and not held(e)) / steps
    return dict(
        device=torch.cuda.get_device_name(trainer.device) if cuda else "cpu",
        platform="cuda" if cuda else "cpu", stage=stage, iteration=it, steps=steps,
        dtype=str(trainer.cfg.tpu.get("compute_dtype", "float32")),
        merged_render=bool(trainer.cfg.tpu.get("merged_render")),
        loss=float(stats["all"]),
        ms_per_step={k: v / 1e3 / steps for k, v in by_cat.items()},
        window_ms_per_step=window_us / 1e3 / steps,
        busy_share=None if busy is None else busy / window_us,
        idle_share=None if busy is None else 1.0 - busy / window_us,
        setup_ms=dict(setup_ms), spans=span_table(traced, steps, idle),
        syncs_outside_wait_per_step=unwaited,
        kernels=[dict(name=n[:120], ms_per_step=v[0] / 1e3 / steps, calls=v[1]) for n, v in top])


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", default="fine", choices=["fine", "coarse"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--merged", action="store_true", help="cfg.tpu.merged_render = True")
    ap.add_argument("--tiny", action="store_true", help="the 24x32, 4x64-MLP step, 16 rays")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tracing.enable()
    try:
        trainer = build_trainer(args.tiny, args.dtype, args.merged, args.device)
        res = profile(trainer, args.stage, args.steps, args.warmup)
    finally:
        tracing.disable()
    for k in res["kernels"]:
        print(f"  {k['ms_per_step']:9.3f} ms/step  x{k['calls']:<5d} {k['name']}")
    for name, ms in sorted(res["setup_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.1f} ms  {name}")
    print(f"  {'calls/step':>10} {'self ms/step':>12} {'idle ms/step':>12}  span")
    for name, row in res["spans"].items():
        idle = "-" if row["idle_ms_per_step"] is None else f"{row['idle_ms_per_step']:.3f}"
        print(f"  {row['calls_per_step']:10.1f} {row['self_ms_per_step']:12.3f} {idle:>12}  {name}")
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}), flush=True)
    return res


if __name__ == "__main__":
    main()
