"""Spans and counters of the port's host path, kept in memory.

A *span* times one block of host work where it happens: ``with
span("fleet.pad"): ...``.  A *counter* adds up work that is too fine to
be a span (one copy, one summary): calls, seconds and bytes.

Tracing is off by default.  Off, :func:`span` checks a flag and the
profiler's state and returns a shared null context (no allocation, no
clock, no profiler call), and :func:`count` returns at once.  It is on after :func:`enable`, until
:func:`disable`, and whenever a ``torch.profiler`` session is capturing,
so a profiled run records without any other switch.  On, a span stores
a :class:`Record`: its name, start and end (``time.perf_counter_ns``),
the span that encloses it on this thread, the grid it belongs to (the
id a ``fleet.run`` span hands out, shared by every span under it) and
its attributes.  While a profiler is capturing, a span is also a
``torch.profiler.record_function`` range, so the profiler's trace places
the host's work on the same clock as the device's kernels and copies.

The set-up spans (:func:`setup_span`: the kernel libraries' build and
load, ``FleetRunner.build``) record whether tracing is on or off: they
run a few dozen times a process, and before any profiler starts.

Everything stays in memory until :func:`reset`; :func:`totals` sums
spans and counters by name.  The names:

=====================  =======  ==========================================
name                   kind     where
=====================  =======  ==========================================
``fleet.run``          span     ``FleetRunner.run``: a grid (new grid id)
``fleet.launch``       span     ``FleetRunner._launch``: one cost class;
                                attrs ``cost_class``, ``n_sims``, ``m``,
                                ``k``, ``device_s``
``fleet.stage``        counter  each launch's staged host batch
                                (``fleet.runner._stage``): its bytes and
                                the seconds its allocation took
                                (page-locked for a card)
``fleet.pad``          span     the sims' ``SimState.pad_to`` into the
                                staged batch in ``_launch``
``fleet.stack``        span     ``fleet.engine.stack``
``fleet.h2d``          counter  the field copies in ``stack``, one call
                                a field; on a card, the seconds run to
                                the copies' completion
``fleet.kernel.wait``  span     CUDA only: ``unstack`` waits for the
                                batch's stream before its first copy
``fleet.unstack``      span     ``fleet.engine.unstack``
``fleet.d2h``          counter  each ``.cpu()`` in ``unstack``
``results.summary``    counter  each ``FleetResult.summary``
``results.rss``        counter  each ``rss_mb()`` read in ``summary``
``fleet.build``        set-up   ``FleetRunner.build``; attr ``sim``
``kernels.build``      set-up   ``kernels.build.build_all``; attr
                                ``built`` (whether ``nvcc`` ran)
``kernels.load``       set-up   ``kernels.build.library``'s first load of
                                a library; attrs ``library``, ``built``
=====================  =======  ==========================================
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: every span and counter name the port records
NAMES = ("fleet.run", "fleet.launch", "fleet.stage", "fleet.pad",
         "fleet.stack", "fleet.h2d", "fleet.kernel.wait", "fleet.unstack",
         "fleet.d2h", "results.summary", "results.rss",
         "fleet.build", "kernels.build", "kernels.load")

_enabled = False
# True while a torch.profiler session captures (~0.2 us a call)
_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_grids = itertools.count(1)
_records: List["Record"] = []
_totals: Dict[str, List] = {}       # name -> [count, seconds, bytes]


class Record(NamedTuple):
    """One finished span."""

    span_id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]           # span_id of the enclosing span
    grid: Optional[int]
    attrs: Dict[str, object]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def enable() -> None:
    """Record spans and counters until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording (a capturing profiler still turns tracing on)."""
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans and counters record now."""
    return _enabled or _profiling()


class _NullSpan:
    """What :func:`span` returns while tracing is off: one shared,
    false object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "new_grid", "span_id", "parent", "grid",
                 "start_ns", "_range")

    def __init__(self, name: str, new_grid: bool, attrs: Dict) -> None:
        self.name = name
        self.attrs = attrs
        self.new_grid = new_grid
        self._range = None

    def set(self, **attrs) -> None:
        """Add attributes, e.g. ones known only at the block's end."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.span_id = next(_ids)
        self.parent = outer.span_id if outer is not None else None
        self.grid = next(_grids) if self.new_grid else \
            (outer.grid if outer is not None else None)
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        rec = Record(self.span_id, self.name, self.start_ns, end,
                     self.parent, self.grid, self.attrs)
        with _lock:
            _records.append(rec)
            _add(self.name, 1, rec.seconds, 0)
        return False


def _stack() -> List[_Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(name: str, n: int, seconds: float, nbytes: int) -> None:
    tot = _totals.get(name)
    if tot is None:
        tot = _totals[name] = [0, 0.0, 0]
    tot[0] += n
    tot[1] += seconds
    tot[2] += nbytes


def span(name: str, /, new_grid: bool = False, **attrs):
    """A context manager that records the block as span ``name`` while
    tracing is on (the shared null context otherwise).  ``new_grid``
    gives the span, and every span under it, a fresh grid id.  The
    object it yields is false when off; ``set(**attrs)`` adds
    attributes."""
    if not (_enabled or _profiling()):
        return _NULL
    return _Span(name, new_grid, attrs)


def setup_span(name: str, /, **attrs):
    """A span that records whether tracing is on or off: set-up work
    that runs a few times a process."""
    return _Span(name, False, attrs)


def count(name: str, n: int = 1, seconds: float = 0.0,
          bytes: int = 0) -> None:
    """Add ``n`` calls, ``seconds`` and ``bytes`` to counter ``name``
    while tracing is on."""
    if not (_enabled or _profiling()):
        return
    with _lock:
        _add(name, n, seconds, bytes)


def totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "seconds", "bytes"}}`` of every span and
    counter recorded since the last :func:`reset`."""
    with _lock:
        return {k: {"count": c, "seconds": s, "bytes": b}
                for k, (c, s, b) in _totals.items()}


def records() -> List[Record]:
    """The finished spans since the last :func:`reset`, in the order
    they ended."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Forget every record and total (the on/off state stays)."""
    with _lock:
        _records.clear()
        _totals.clear()
