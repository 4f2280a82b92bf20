"""Spans and launch counters inside the serving and model path.

Tracing is on exactly while a ``torch.profiler`` runs; there is no flag.

* Off, :func:`span` returns one shared no-op object: one C call and a
  branch, nothing allocated, no attribute computed.  That object is
  falsy, so a caller computes an attribute that costs work only under
  ``if sp:``.
* On, a span opens a profiler range (``_RecordFunctionFast``, a C++
  record function), so it lands in the profiler's trace as a ``cpu_op``
  of its name on the clock of the CUDA kernels and copies, and appends a
  record to a bounded in-memory store: name, span id, parent id, request
  id, ``time.perf_counter_ns()`` at start and end, and attributes.  The
  range adds less than half of what ``torch.profiler.record_function``
  (a ``user_annotation``, entered and left through two dispatched ops)
  adds to a traced step.

The parent of a span is the innermost span open on its thread; a root
span takes a fresh request id and its children inherit it.  The store
holds the latest profiled stretch: the first span recorded after one that
was skipped with the profiler off clears it.  Past :data:`MAX_RECORDS` it
drops the oldest records and counts them (:func:`dropped`).

:func:`spans` returns the records and :func:`reset` clears them;
:func:`launches` reads the kernel wrappers' own launch counters.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional

import torch

__all__ = ["MAX_RECORDS", "span", "spans", "dropped", "reset", "launches"]

#: records the store holds; past it the oldest are dropped
MAX_RECORDS = 65536

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_store: collections.deque = collections.deque()
_dropped = 0
# a span was skipped with the profiler off: the next one recorded clears
_skipped = False
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _Off:
    """The shared span of a run without a profiler: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    """One recorded span; its record once entered."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "attrs", "_count", "_before", "_fn")

    def __init__(self, name: str, count_launches: bool):
        self.name, self._count = name, count_launches
        self.attrs: dict = {}
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        global _dropped, _skipped
        if _skipped:
            _store.clear()
            _dropped, _skipped = 0, False
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_span_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_request_ids)
        stack.append(self)
        while len(_store) >= MAX_RECORDS:
            _store.popleft()
            _dropped += 1
        _store.append(self)
        self._before = launches() if self._count else None
        self._fn = _range(self.name)
        self._fn.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        self._fn = None
        _local.stack.pop()
        if self._before is not None:
            after = launches()
            self.attrs["launches"] = {k: n - self._before.get(k, 0)
                                      for k, n in after.items()
                                      if n != self._before.get(k, 0)}
            self._before = None
        return False


def span(name: str, count_launches: bool = False):
    """A context manager around one layer's work.  With
    ``count_launches`` the span gets the attribute ``launches``: the
    change in :func:`launches` over it, nonzero entries only (counted only
    while tracing is on)."""
    global _skipped
    if not _profiling():
        _skipped = True
        return _OFF
    return _Span(name, count_launches)


def spans() -> list:
    """The store's records, oldest first, as dicts: ``name``, ``id``,
    ``parent`` (None for a root), ``request``, ``start_ns``, ``end_ns``
    (None while open) and ``attrs``."""
    return [dict(name=r.name, id=r.id, parent=r.parent, request=r.request,
                 start_ns=r.start_ns, end_ns=r.end_ns, attrs=dict(r.attrs))
            for r in list(_store)]


def dropped() -> int:
    """Records dropped past :data:`MAX_RECORDS` since the store was last
    cleared."""
    return _dropped


def reset() -> None:
    """Clear the store."""
    global _dropped, _skipped
    _store.clear()
    _dropped, _skipped = 0, False


def launches() -> dict:
    """``{wrapper: launches, (wrapper, route): launches}`` from the six
    kernel wrappers' own ``.launches`` and ``.launches_by_route``
    counters (launches on the card; the plain versions count none)."""
    from tgp_tpu_torch.ops.kernels import bmm, sddmm, segment_spmm

    out = {}
    for fn in (segment_spmm.spmm_csr, segment_spmm.segment_sum_sorted,
               segment_spmm.sorted_segment_sum,
               segment_spmm.banded_sorted_spmm, bmm.bmm,
               sddmm.banded_sddmm):
        out[fn.__name__] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            out[(fn.__name__, route)] = n
    return out
