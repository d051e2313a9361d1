"""Host time per unit by the program's own spans, for the program_span readers.

The program's tracer (sparf_tpu_torch/utils/tracing.py) records spans while
the traced window's profiler runs; a unit is one `step` (kind "train") or
one `frame` (kind "render"). Within each unit's span, on the wall clock,
every instant goes to one of three parts: `wait` when a `wait` span (the
host blocked on the device) of the unit covers it, on any thread; else
`mlp` when an `mlp.*` span (the MLP op's host side) covers it; else `torch`
(the renderer, sampling, losses and Adam: Python and PyTorch's own ops).
The three add up to the unit span's length.

`split_ms` returns None, and never raises, when the record has no trace,
when the program has no tracer (an older checkout), or when the tracer's
last window counts another number of units than the run's window did.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

UNIT = {"train": "step", "render": "frame"}


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is not None and e <= end:
            continue
        total += e - (s if end is None else max(s, end))
        end = e
    return total


def _clip(intervals: List[Tuple[int, int]], s0: int, e0: int) -> List[Tuple[int, int]]:
    return [(max(s, s0), min(e, e0)) for s, e in intervals if min(e, e0) > max(s, s0)]


def split_ms(rec: Dict) -> Optional[Dict[str, float]]:
    """{"mlp", "torch", "wait"}: host milliseconds per unit of the run's window."""
    if rec.get("trace") is None or rec.get("kind") not in UNIT:
        return None
    try:
        from sparf_tpu_torch.utils import tracing
    except ImportError:
        return None
    rep = tracing.report()
    kind = UNIT[rec["kind"]]
    n = int(rec["units"])
    if n <= 0 or rep.units.get(kind, 0) != n:
        return None
    unit_span: Dict[int, Tuple[int, int]] = {}
    waits: Dict[int, List[Tuple[int, int]]] = {}
    mlps: Dict[int, List[Tuple[int, int]]] = {}
    for i, r in enumerate(rep.records):
        if r.end_ns is None or r.unit is None:
            continue
        if r.unit == i:
            if r.name != kind:
                return None
            unit_span[i] = (r.start_ns, r.end_ns)
        elif r.name == "wait":
            waits.setdefault(r.unit, []).append((r.start_ns, r.end_ns))
        elif r.name.startswith("mlp."):
            mlps.setdefault(r.unit, []).append((r.start_ns, r.end_ns))
    if len(unit_span) != n:
        return None
    total = dict(mlp=0, torch=0, wait=0)
    for u, (s0, e0) in unit_span.items():
        w = _clip(waits.get(u, []), s0, e0)
        wait_ns = _union_ns(w)
        covered = _union_ns(w + _clip(mlps.get(u, []), s0, e0))
        total["wait"] += wait_ns
        total["mlp"] += covered - wait_ns
        total["torch"] += (e0 - s0) - covered
    return {k: v / 1e6 / n for k, v in total.items()}
