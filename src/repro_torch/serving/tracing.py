"""Spans of the serving path's host work: where a serve call's time goes.

Off by default.  While off, a span boundary costs one check of the
module flag: no clock read, no allocation.  ``enable()`` turns it on;
every span then records ``(name, t0_ns, t1_ns, parent, call, n)`` in one
in-memory list, read and cleared by ``take()``:

- ``t0_ns``/``t1_ns``: ``time.perf_counter_ns()`` at the span's start and
  end, the host clock a device trace can be tied to;
- ``parent``: the index in the same ``take()`` of the enclosing span (-1
  for none), kept per thread; ``bind`` carries it into a worker thread;
- ``call``: the id of the outermost span's call (a ``Cluster.serve``),
  shared by every span inside it;
- ``n``: the span's count (requests, rows or ids).

The spans (each in the module named):

- ``cluster.serve`` (``cluster.py``): one ``Cluster.serve``, n requests;
- ``broker.serve`` (``broker.py``): one shard's batch, n requests;
- ``broker.route``: hashing, topic routing, bucket padding, freshness
  arrays and admission, up to the fused call;
- ``broker.stage``: the request arrays and the fill plan copied to the
  device, n padded requests;
- ``broker.launch``: issuing the serve step (host time only);
- ``broker.fetch``: the step's outputs copied back, the host blocked on
  the device;
- ``broker.miss``: the back-end dispatch of a batch's distinct misses, n
  ids;
- ``backend.call`` (``launch/serve.py::lm_backend``): one back-end call, n
  rows asked for; inside it ``backend.tokens`` (the token windows),
  ``backend.stage`` (the copies into the inputs of the call's graphs),
  a ``backend.replay`` for each graph (its launch, host side; n the
  graph's rows) and ``backend.fetch`` (the ids gathered and copied back:
  the wait on the device).

No span goes to ``torch.profiler`` or NVTX: the profiler would count
their ranges among the device's activity.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional, Tuple

Span = Tuple[str, int, int, int, int, int]

_on = False
_records: list = []
_local = threading.local()
_calls = itertools.count()


class _Record:
    """One span, open until its ``t1`` is set; a context manager that
    ends it."""

    __slots__ = ("name", "t0", "t1", "parent", "call", "n")

    def __init__(self, name: str, parent: Optional["_Record"], n: int):
        self.name, self.parent, self.n, self.t0, self.t1 = name, parent, int(n), 0, 0
        self.call = next(_calls) if parent is None else parent.call

    def __enter__(self) -> "_Record":
        return self

    def __exit__(self, *exc) -> bool:
        end(self)
        return False


class _Off:
    """What ``span`` returns while tracing is off."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> List[Span]:
    """The spans recorded since the last ``take()``, in order of opening,
    and clear them.  Call it between serve calls: a span still open reads
    ``t1_ns`` 0."""
    global _records
    recs, _records = _records, []
    index = {id(r): i for i, r in enumerate(recs)}
    return [(r.name, r.t0, r.t1, index.get(id(r.parent), -1), r.call, r.n) for r in recs]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def begin(name: str, n: int = 0) -> Optional[_Record]:
    """Open a span in this thread (None while tracing is off)."""
    if not _on:
        return None
    stack = _stack()
    rec = _Record(name, stack[-1] if stack else None, n)
    _records.append(rec)
    stack.append(rec)
    rec.t0 = time.perf_counter_ns()
    return rec


def end(rec: Optional[_Record]) -> None:
    """Close ``rec``, and any span a raise left open inside it."""
    if rec is None:
        return
    t = time.perf_counter_ns()
    stack = _stack()
    if rec in stack:
        _unwind(stack, rec, t)
    rec.t1 = t


def span(name: str, n: int = 0):
    """``with span(name, n):`` records the block as a span."""
    return begin(name, n) if _on else _OFF


def _unwind(stack: list, rec: _Record, t: int) -> None:
    while stack:
        top = stack.pop()
        if top is rec:
            return
        if not top.t1:
            top.t1 = t


def bind(fn):
    """``fn`` to run in another thread as a child of the span open in this
    one (``fn`` itself while tracing is off or no span is open)."""
    if not _on:
        return fn
    stack = _stack()
    if not stack:
        return fn
    parent = stack[-1]

    def bound(*args, **kwargs):
        mine = _stack()
        mine.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            _unwind(mine, parent, time.perf_counter_ns())

    return bound
