"""Spans and counters at the port's layer boundaries, kept in memory.

A span is a named stretch of host time: its ``perf_counter_ns`` start and
end, the index of the span it opened inside (-1 for none) and its
attributes (a request's spans carry its ``rid``). ``count(name, n)`` adds
``n`` to a counter of the innermost open span. ``interval`` records a
stretch that nests in nothing, such as a request's wait in the queue.
``summary()`` reduces the record to per-name counts, total and self
milliseconds (a span less the spans opened inside it) and counters.

When it records: while a ``torch.profiler`` session records on this
thread, or inside ``recording()``. While the profiler records, each
``span`` also opens ``torch.profiler.record_function(name)``, so it lies
on the profiler's timeline beside the device's work. An ``inner`` span,
for the stretches inside a model's forward (a layer's attention, its
FFN, the MoE dispatch's phases, the head: tens a decode step), records on
the host's clock alone: under the profiler, a range each slows the host
that enqueues the step by more than the stretch is worth.
Otherwise a span site costs one flag read and returns a shared no-op: no
``record_function``, no clock read, no span object.

It never synchronises with the device, recording or not: spans read the
host's clock, and counters take Python numbers that the caller computes
from shapes. Inside ``collecting()`` counts go to the block's own dict
instead, recording or not: a captured CUDA graph's counts, which each of
its replays adds again with ``count``.

The record is the process's own, one thread's at a time: spans are opened
from layers (the kernels' wrappers, the dispatch) that take no recorder
argument, as the profiler they follow is the thread's own.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import torch

_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class Span:
    """One recorded span or interval."""
    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "counts",
                 "_index", "_range", "_annotate")

    def __init__(self, name: str, attrs: dict, annotate: bool = True):
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = None
        self.parent = -1
        self.counts: Optional[Dict[str, int]] = None
        self._range = None
        self._annotate = annotate

    def __enter__(self) -> "Span":
        self.parent = _open[-1] if _open else -1
        self._index = len(_spans)
        _open.append(self._index)
        _spans.append(self)
        if self._annotate and _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if _open and _open[-1] == self._index:
            _open.pop()
        return False


class _Off:
    """The shared no-op span of a site that does not record."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_spans: List[Span] = []
_open: List[int] = []            # indices of the open spans, innermost last
_loose: Dict[str, int] = {}      # counts made with no span open
_forced = 0                      # depth of ``recording()``
_collectors: List[Dict[str, int]] = []   # open ``collecting()`` blocks


def enabled() -> bool:
    """Whether spans and counters record here and now."""
    return _forced > 0 or _profiling()


def span(name: str, **attrs):
    """A context manager: the span ``name`` while recording, else a no-op."""
    if not (_forced or _profiling()):
        return _OFF
    return Span(name, attrs)


def inner(name: str):
    """A context manager: the span ``name``, without a profiler range,
    while recording, else a no-op."""
    if not (_forced or _profiling()):
        return _OFF
    return Span(name, {}, annotate=False)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span, or of the
    innermost ``collecting()`` block."""
    if _collectors:
        c = _collectors[-1]
        c[name] = c.get(name, 0) + n
        return
    if not (_forced or _profiling()):
        return
    if _open:
        sp = _spans[_open[-1]]
        if sp.counts is None:
            sp.counts = {}
        counts = sp.counts
    else:
        counts = _loose
    counts[name] = counts.get(name, 0) + n


def interval(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record ``[start_ns, end_ns)`` (``perf_counter_ns``) as ``name``,
    nested in no span and holding none."""
    if not (_forced or _profiling()):
        return
    sp = Span(name, attrs)
    sp.start_ns, sp.end_ns = start_ns, end_ns
    _spans.append(sp)


def reset() -> None:
    """Forget everything recorded."""
    _spans.clear()
    _open.clear()
    _loose.clear()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record inside the block, profiler or not. The outermost block
    starts a new record, which stays readable after the block."""
    global _forced
    if not _forced:
        reset()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


@contextlib.contextmanager
def collecting() -> Iterator[Dict[str, int]]:
    """Collect the counts made inside the block into the dict it yields,
    recording or not, instead of into the record: a captured CUDA graph's
    counts, which each replay then adds with ``count``."""
    got: Dict[str, int] = {}
    _collectors.append(got)
    try:
        yield got
    finally:
        _collectors.pop()


def records() -> List[Span]:
    """The recorded spans and intervals, in the order they opened."""
    return list(_spans)


def summary() -> dict:
    """``{"spans": {name: {"count", "total_ms", "self_ms", "counters"}},
    "counters": {name: sum}}`` over the closed spans. A span's
    ``counters`` include those of the spans opened inside it; the top
    level ``counters`` sum every count once."""
    n = len(_spans)
    inner_ns = [0] * n
    inclusive: List[Dict[str, int]] = [dict(s.counts or ()) for s in _spans]
    for i in range(n - 1, -1, -1):          # a span follows its parent
        s = _spans[i]
        if s.parent < 0:
            continue
        if s.end_ns is not None:
            inner_ns[s.parent] += s.end_ns - s.start_ns
        up = inclusive[s.parent]
        for k, v in inclusive[i].items():
            up[k] = up.get(k, 0) + v
    out: Dict[str, dict] = {}
    totals = dict(_loose)
    for i, s in enumerate(_spans):
        for k, v in (s.counts or {}).items():
            totals[k] = totals.get(k, 0) + v
        if s.end_ns is None:
            continue
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "counters": {}})
        ns = s.end_ns - s.start_ns
        row["count"] += 1
        row["total_ms"] += ns * 1e-6
        row["self_ms"] += (ns - inner_ns[i]) * 1e-6
        for k, v in inclusive[i].items():
            row["counters"][k] = row["counters"].get(k, 0) + v
    return {"spans": out, "counters": totals}
