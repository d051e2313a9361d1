"""The traced window: torch.profiler over the steps or frames of a run,
reduced to what the per-layer metrics read.

  - `mlp_ranges` wraps the MLP op's entry points in `record_function`
    ranges from the benchmark's own side: the forward entry
    (`nerf_apply_fused`, which launches K1, or K3 on packed weights) and
    the autograd function's backward (K2). A device operation belongs to
    the op when it was launched inside such a range, whatever its name.
  - `reduce` reads the profiler's raw events: busy time is the union of
    every device operation's interval (the arithmetic of
    sparf_tpu_torch/scripts/profile_step.py's `_busy_us`, copied), device
    time is split between the op and the rest, and the breakdown lists the
    longest device operations and the idle gaps by the innermost host
    range open while the device waited.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

MLP_RANGE = "bench::mlp"
STEP_RANGE = "bench::step"


def is_device_op(e) -> bool:
    """A kernel, copy or set on the device: not the profiler's device-side
    mirror of a host range (named as the range) or a synchronisation record."""
    from torch.autograd import DeviceType

    name = e.name()
    return (e.device_type() == DeviceType.CUDA and name not in (MLP_RANGE, STEP_RANGE)
            and not name.endswith(" Sync") and name != "Stream Wait Event")


def is_launch(e) -> bool:
    """A host record of the CUDA runtime or driver (cudaLaunchKernel, cuLaunchKernelEx,
    cudaMemcpyAsync, ...): its correlation id is that of the device operation it starts."""
    return e.name().startswith("cu")


def busy_ns(intervals: List[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is not None and e <= end:
            continue
        busy += e - (s if end is None else max(s, end))
        end = e
    return busy


@contextlib.contextmanager
def mlp_ranges() -> Iterator[bool]:
    """Wrap the MLP op's entry points in MLP_RANGE while the block runs;
    yields False (and wraps nothing) when an entry point is gone."""
    from torch.profiler import record_function

    from sparf_tpu_torch.ops import fused_mlp

    fn = getattr(fused_mlp, "nerf_apply_fused", None)
    cls = getattr(fused_mlp, "FusedMLPFunction", None)
    bwd = getattr(cls, "backward", None) if cls is not None else None
    if fn is None or bwd is None:
        yield False
        return

    def forward(*args, **kwargs):
        with record_function(MLP_RANGE):
            return fn(*args, **kwargs)

    def backward(ctx, *grads):
        with record_function(MLP_RANGE):
            return bwd(ctx, *grads)

    fused_mlp.nerf_apply_fused = forward
    cls.backward = staticmethod(backward)
    try:
        yield True
    finally:
        fused_mlp.nerf_apply_fused = fn
        cls.backward = staticmethod(bwd)


class _Ranges:
    """Host ranges of one name, per thread, for containment tests."""

    def __init__(self, spans: List[Tuple[int, int, int]]):
        self.by_thread: Dict[int, Tuple[List[int], List[int]]] = {}
        per: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for tid, s, e in spans:
            per[tid].append((s, e))
        for tid, lst in per.items():
            lst.sort()
            # ranges of one name on one thread do not nest here: merge overlaps
            merged: List[List[int]] = []
            for s, e in lst:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self.by_thread[tid] = ([m[0] for m in merged], [m[1] for m in merged])

    def contains(self, tid: int, t: int) -> bool:
        starts, ends = self.by_thread.get(tid, ([], []))
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]


def _innermost_timeline(events) -> Tuple[List[int], List[str]]:
    """Segments of one thread's timeline, each named after the innermost
    host range open in it: (segment starts, names); "" where none is."""
    evs = sorted(events, key=lambda x: (x[0], -x[1]))
    starts: List[int] = []
    names: List[str] = []
    stack: List[Tuple[int, str]] = []

    def emit(t: int):
        name = stack[-1][1] if stack else ""
        if names and names[-1] == name:
            return
        starts.append(t)
        names.append(name)

    for s, e, name in evs:
        while stack and stack[-1][0] <= s:
            t = stack.pop()[0]
            emit(t)
        stack.append((e, name))
        emit(s)
    while stack:
        t = stack.pop()[0]
        emit(t)
    return starts, names


def _span(e) -> Tuple[int, int]:
    return e.start_ns(), e.end_ns()


def reduce(prof, window_s: float, units: int, mlp_wrapped: bool) -> Dict:
    """What the per-layer readers need from a finished profiler `prof` over a
    window of `window_s` seconds holding `units` steps or frames. Device
    operations are kernels, copies and sets (the profiler's device-side
    mirrors of host ranges and its synchronisation records are not). A
    device operation is the MLP op's when the host call that launched it (the
    CUDA runtime or driver record of the same correlation) ran inside an
    MLP_RANGE on its thread."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, cpu = [], []
    for e in events:
        if is_device_op(e):
            device.append(e)
        elif e.device_type() == DeviceType.CPU:
            cpu.append(e)
    spans = {id(e): _span(e) for e in device + cpu}
    mlp = _Ranges([(e.start_thread_id(), *spans[id(e)]) for e in cpu if e.name() == MLP_RANGE])
    launch_of = {e.correlation_id(): e for e in cpu if is_launch(e)}

    intervals, by_name = [], defaultdict(int)
    mlp_ns = other_ns = unlinked = 0
    for k in device:
        s, e = spans[id(k)]
        intervals.append((s, e))
        by_name[k.name()] += e - s
        host = launch_of.get(k.correlation_id())
        if host is None:
            unlinked += e - s
            other_ns += e - s
        elif mlp.contains(host.start_thread_id(), spans[id(host)][0]):
            mlp_ns += e - s
        else:
            other_ns += e - s
    busy = busy_ns(intervals)

    # idle gaps inside the window, named by the innermost host range on the
    # thread that ran the steps
    steps = [e for e in cpu if e.name() == STEP_RANGE]
    gaps: Dict[str, int] = defaultdict(int)
    if steps and intervals:
        tid = steps[0].start_thread_id()
        t0, t1 = min(spans[id(e)][0] for e in steps), max(spans[id(e)][1] for e in steps)
        starts, names = _innermost_timeline(
            [(*spans[id(e)], e.name()) for e in cpu
             if e.start_thread_id() == tid and spans[id(e)][1] > spans[id(e)][0]])
        merged: List[List[int]] = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        prev_end = t0
        for s, e in merged + [[t1, t1]]:
            gs, ge = max(prev_end, t0), min(s, t1)
            if ge > gs:
                i = bisect.bisect_right(starts, (gs + ge) // 2) - 1
                gaps[(names[i] if i >= 0 else "") or "(no host range)"] += ge - gs
            prev_end = max(prev_end, e)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        busy_s=busy / 1e9, window_s=window_s, units=units,
        device_s=sum(by_name.values()) / 1e9,
        mlp_device_s=(mlp_ns / 1e9) if mlp_wrapped and mlp_ns > 0 else None,
        other_device_s=other_ns / 1e9, unlinked_device_s=unlinked / 1e9,
        n_device_ops=len(device),
        breakdown=dict(device_ops=[[n[:120], v / 1e9] for n, v in top_ops],
                       idle_gaps=[[n[:120], v / 1e9] for n, v in top_gaps]))


