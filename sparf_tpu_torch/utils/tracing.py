"""Spans and counters of the port: where the host's time goes, layer by layer.

A span marks a stretch of host time at a layer boundary: `span(name)` is a
context manager, and `traced(name)` a decorator whose every call is one span.
`wait(site)` is the span `wait` around a place where the host blocks on the
device (a synchronise, `.item()`, `float(t)`, a copy that the device has to
finish first); the report keeps its site. `count(name, n)` adds to a
counter. `report()` reads spans and counters back.

Off by default. Spans record while a torch profiler records (its Python
flag, torch.autograd.profiler._is_profiler_enabled) or between `enable()`
and `disable()`; otherwise `span` and `wait` return one shared no-op, at the
cost of a flag read. Counters always count: they are integer adds.

On, a span does two things:
  - it keeps a record in memory: name, parent record, unit, thread, start
    and end, stamped by time.time_ns(), the Unix clock the profiler gives
    its events on (each record agrees with the profiler's event of the same
    span to within a few microseconds). The records are flat lists of ints
    and strings, which Python's garbage collector does not track, so a
    window's spans add nothing to its collections;
  - while a profiler records, it opens a host range of the same name
    (torch._C._profiler._RecordFunctionFast, a function-scope range: the
    profiler mirrors user-scope ranges, such as record_function's, as
    device-side events, and function-scope ones not).

Units: a span named in UNITS (`step`, one training iteration; `frame`, one
rendered image) opened while no unit is open starts a unit; every span that
opens until it closes carries its id, on any thread (the autograd engine
runs the backward on a thread of its own; such a span's parent is the
innermost span open on the unit's thread).

Windows: the report covers the last window the tracer was on. A window
begins when something turns the tracer on: `enable()`, or a profiler that
starts while the tracer is not enabled (the tracer wraps torch's
torch.autograd.profiler._run_on_profiler_start to see it). The records of
the window before are dropped then, and not before: a report read after the
profiler stopped still holds its window.

The spans, by layer (PERF.md section 3): `step` (training/engine.py) with
`step.poses`, `step.losses`, `step.backward`, `step.reduce` (with a mesh),
`step.update`; `loss.<builder>` (a loss builder's own host work, each time
it resumes; training/trainer.py); `frame` and `render.chunk`
(training/trainer.py, models/renderer.py); `render.bundles`,
`render.coarse`, `render.fine`, `render.composite` (models/renderer.py);
`mlp.forward`, `mlp.backward`, `mlp.encode`, `mlp.pack`, `mlp.launch`
(ops/fused_mlp.py); `wait`, wherever the host blocks in a step or a frame;
`setup.scene`, `setup.networks`, `setup.optimizer`, `setup.pools`
(training/trainer.py), `setup.kernels` (ops/_build.py), `setup.config`
(scripts/profile_step.py). No name starts with "cu", which the benchmark's
trace reserves for the CUDA runtime's records. The counters:
`launch.<kernel>[.bf16]` (ops/fused_mlp.py), `collective_bytes.<kind>`
(parallel/mesh.py).
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

UNITS = ("step", "frame")
_OPEN = 7   # values per opened span in a window's `opens`: see _Tracer.begin_window


class Record(NamedTuple):
    """One span: `parent` is the index of its parent record in the report
    (-1 for none), `unit` the index of its unit's own record (None outside a
    unit), `thread` threading.get_ident() of the thread that ran it,
    `end_ns` None while it is open, `site` a wait's site."""

    name: str
    parent: int
    unit: Optional[int]
    thread: int
    start_ns: int
    end_ns: Optional[int]
    site: Optional[str] = None


class Report(NamedTuple):
    """The last window's spans (`records`, in the order they opened),
    the units it counted by kind (`units`: {"step": n, "frame": m}) and every
    counter (`counts`)."""

    records: List[Record]
    units: Dict[str, int]
    counts: Dict[str, int]


class _Tracer:
    """The process's spans and counters: the module's functions act on one."""

    def __init__(self):
        self.explicit = False
        self.counts: Dict[str, int] = {}
        self.lock = threading.Lock()
        self.begin_window()

    def begin_window(self) -> None:
        # `opens` takes index, name, parent, unit, thread, start and site of
        # each span as it opens, `ends` index and end as it closes: one
        # list.extend of a tuple each, which no other thread interleaves
        self.opens: list = []
        self.ends: list = []
        self.counter = itertools.count()
        self.stacks: Dict[int, List[int]] = {}   # per thread, its open spans
        self.units: Dict[str, int] = {}
        self.unit: Optional[int] = None
        self.unit_stack: Optional[List[int]] = None


_T = _Tracer()


def _watch_profiler_start() -> None:
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None:
        return

    def on_profiler_start():
        start()
        if not _T.explicit:
            _T.begin_window()

    _profiler._run_on_profiler_start = on_profiler_start


_watch_profiler_start()


class _Noop:
    """What `span` and `wait` return while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_RANGE = None   # torch._C._profiler._RecordFunctionFast, imported by the first span on


class _Span:
    __slots__ = ("name", "site", "rf", "index", "stack", "starts_unit", "ends")

    def __init__(self, name: str, site: Optional[str] = None):
        self.name, self.site = name, site

    def __enter__(self):
        # the profiler stamps a range's start at the end of its __enter__ and
        # its end inside its __exit__: the record takes the time after the one
        # and the middle of the other
        global _RANGE
        if _profiler._is_profiler_enabled:
            if _RANGE is None:
                from torch._C._profiler import _RecordFunctionFast as _RANGE
            self.rf = _RANGE(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        start = time.time_ns()
        t = _T
        thread = threading.get_ident()
        stack = t.stacks.get(thread)
        if stack is None:
            stack = t.stacks[thread] = []
        parent = stack[-1] if stack else t.unit_stack[-1] if t.unit_stack else -1
        index = next(t.counter)
        self.starts_unit = t.unit is None and self.name in UNITS
        if self.starts_unit:
            t.units[self.name] = t.units.get(self.name, 0) + 1
            t.unit, t.unit_stack = index, stack
        t.opens.extend((index, self.name, parent, t.unit, thread, start, self.site))
        stack.append(index)
        self.index, self.stack, self.ends = index, stack, t.ends

    def __exit__(self, *exc):
        self.stack.pop()
        if self.starts_unit:
            _T.unit, _T.unit_stack = None, None
        if self.rf is None:
            self.ends.extend((self.index, time.time_ns()))
        else:
            t0 = time.time_ns()
            self.rf.__exit__(None, None, None)
            self.ends.extend((self.index, (t0 + time.time_ns()) // 2))
        return False


def span(name: str):
    """A span named `name` (a context manager), or the shared no-op while
    tracing is off."""
    if _T.explicit or _profiler._is_profiler_enabled:
        return _Span(name)
    return _NOOP


def traced(name: str):
    """A decorator: every call of the function is one span named `name`."""

    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return decorate


def wait(site: str):
    """The span `wait` around a place where the host blocks on the device,
    or the shared no-op while tracing is off."""
    if _T.explicit or _profiler._is_profiler_enabled:
        return _Span("wait", site)
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _T.lock:
        _T.counts[name] = _T.counts.get(name, 0) + n


def counts(prefix: str = "") -> Dict[str, int]:
    """The counters whose name starts with `prefix`, by the rest of their name."""
    with _T.lock:
        return {k[len(prefix):]: v for k, v in _T.counts.items() if k.startswith(prefix)}


def reset_counts(prefix: str = "") -> None:
    """Set the counters whose name starts with `prefix` to 0 (they stay listed)."""
    with _T.lock:
        for k in _T.counts:
            if k.startswith(prefix):
                _T.counts[k] = 0


def enable() -> None:
    """Record spans from now on, with or without a profiler; begins a new window."""
    _T.begin_window()
    _T.explicit = True


def disable() -> None:
    """Record spans only while a profiler records (the default)."""
    _T.explicit = False


def is_on() -> bool:
    return _T.explicit or _profiler._is_profiler_enabled


def report() -> Report:
    """The last window's spans, its units and every counter."""
    t = _T
    units = dict(t.units)
    ends = t.ends[:]
    opens = t.opens[:]
    end_of = dict(zip(ends[0::2], ends[1::2]))
    rows = sorted(zip(*[iter(opens)] * _OPEN))
    records = [Record(name, parent, unit, thread, start, end_of.get(index), site)
               for index, name, parent, unit, thread, start, site in rows]
    return Report(records, units, counts())
