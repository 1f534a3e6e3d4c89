"""Spans at the port's layer boundaries, on the profiler's clock.

A span names one stretch of the host's work at a layer boundary: a served
dispatch and its parts (`serving/pipeline.py`), a model stage
(`models/occdepth.py`, `models/unet3d.py`), a phase of a train or eval
step (`training/step.py`).  It is active while a `torch.profiler` session
runs, or inside `recording()`.  An active span

  * opens `torch.profiler.record_function(name)`: a profiler trace shows
    it as a host event on the same clock as the kernels, memsets and
    copies, so device idle time can be put down to what the host was doing;
  * appends a `Record` to a ring of the last `CAPACITY` spans: its name,
    the id of its unit (every span under one root, a dispatch or a step,
    shares the root's id), its parent's index, its host start and end
    (`time.perf_counter_ns`) and, once CUDA is initialised, a pair of
    timing events recorded on the current stream at entry and exit.

A span does nothing while `torch.compile` or `torch.export` traces the
program or a CUDA graph is being captured.  Inactive, it costs one flag
check and one call into the profiler's C state, and returns one shared
null context.

The model runs each stage through `call(name, fn, *args)`, the stage in
its span, unless its caller passes another runner of that signature: the
serving pipeline's replays each stage as a CUDA graph
(`serving/pipeline.py`).  `counts` says how often that path engages; it
counts whether or not spans are active.

    with tracing.recording():
        ...                                 # run the program
    torch.cuda.synchronize()
    for r in tracing.records():
        print(r.name, r.unit, r.end_ns - r.start_ns, r.device_ms)
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 65536

_NULL = contextlib.nullcontext()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_indices = itertools.count()
_units = itertools.count()
_local = threading.local()  # each thread's open spans
_recording = 0
_profiling = torch._C._autograd._profiler_enabled

counts: collections.Counter = collections.Counter()
"""Serving dispatches by path and stage graphs by event, since the process
started (a reader takes differences, or clears it):
`serve.graph_dispatches` and `serve.eager_dispatches` (dispatches served
by stage-graph replays and eagerly), `serve.graph_captures` and
`serve.graph_replays` (stage graphs captured and replayed, the replay
right after each capture included)."""


class Record:
    """One span.  `index` numbers spans in the order they opened;
    `parent` is the index of the span it opened inside (None for a root);
    `unit` is its root's id."""

    __slots__ = ("name", "index", "parent", "unit", "start_ns", "end_ns",
                 "_events", "_ms")

    def __init__(self, name: str, parent: Optional["Record"],
                 unit: Optional[int]):
        self.name = name
        self.index = next(_indices)
        self.parent = None if parent is None else parent.index
        if unit is None:
            unit = next(_units) if parent is None else parent.unit
        self.unit = unit
        self.start_ns = self.end_ns = None
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if torch.cuda.is_initialized() else None)
        self._ms = None

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms from the entry event to the exit event, any device
        idle between them included; None without CUDA events or until the
        exit event has completed."""
        if self._ms is None and self._events and self.end_ns is not None:
            start, end = self._events
            if end.query():
                self._ms = start.elapsed_time(end)
        return self._ms


class _Span:
    __slots__ = ("name", "unit", "record", "_function")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self) -> Record:
        stack = _open()
        rec = Record(self.name, stack[-1] if stack else None, self.unit)
        self.record = rec
        self._function = torch.profiler.record_function(self.name)
        self._function.__enter__()
        stack.append(rec)
        _ring.append(rec)
        if rec._events:
            rec._events[0].record()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if rec._events:
            rec._events[1].record()
        _open().pop()
        self._function.__exit__(*exc)
        return False


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def span(name: str, unit: Optional[int] = None):
    """A context manager around one stretch of the program named `name`.
    Entered, it gives the span's `Record` when active and None otherwise.
    A span opened with no span open on its thread is a root and takes a new
    unit id, unless `unit` gives one (a readout names the dispatch whose
    result it reads)."""
    if not (_recording or _profiling()):
        return _NULL
    if torch.compiler.is_compiling() or _capturing():
        return _NULL
    return _Span(name, unit)


def call(name: Optional[str], fn, *args):
    """`fn(*args)` inside the span `name` (outside any for None): a stage
    of the model run eagerly."""
    if name is None:
        return fn(*args)
    with span(name):
        return fn(*args)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def records() -> List[Record]:
    """The recorded spans, oldest first; the ring is kept."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


def device_ms() -> Dict[str, List[float]]:
    """{span name: the device ms of each of its recorded spans, in the
    order they opened}; call after the device has finished their work."""
    out: Dict[str, List[float]] = {}
    for r in _ring:
        if r.device_ms is not None:
            out.setdefault(r.name, []).append(r.device_ms)
    return out
