"""Named spans of the port's phases, on the profiler's clock.

    from marl_hideandseek_torch.utils import tracing

    with tracing.span("env.step"):
        ...

``span(name)`` marks one phase of the program: an update, a rollout step's
forward, an env step, a reset, a host read of a device value. Tracing is on
in two cases, and off otherwise:

- while a ``torch.profiler`` profile records: each span opens a host range
  of its name in the profiler's trace, beside the kernels it launches
  (``export_chrome_trace`` shows the nesting), and adds a record to this
  process's store, which ``take()`` reads;
- inside ``recording()``: the spans go to that scope's own store, read by
  its ``take()``, and never reach the process's store.

Off, ``span`` returns one shared object that does nothing: no allocation,
no profiler call and no CUDA call. On, a span records the host clock
(``time.perf_counter_ns``) at entry and exit and, once CUDA is in use, a
pair of timing events on the current stream from a reused pool. It adds no
synchronize and no device work. The events resolve into device-clock
milliseconds only when the store is read (``take``: synchronize, resolve,
clear).

The profiler's range is ``torch._C._profiler._RecordFunctionFast``: a
function-scope host range, so the trace holds no device-side annotation
for it and the device's busy time counts kernels and copies only.

A host read (``int(t)``, ``t.tolist()``, a boolean index) makes the host
wait for the card, and so does a copy of a host constant to the card
(``torch.tensor(c, device=...)``: PyTorch synchronizes the stream after a
copy from pageable memory). Each such statement on a timed path sits in a
span named ``host_read.<site>``: the spans' count is the number of syncs,
their host time the wait. On the CPU they mark the same statements, which
wait for nothing there. ``tools/span_audit.py`` finds them on the card.

Spans nest by time on one thread: a record names the span that was open
around it (``parent``). The stores hold at most ``CAP`` records; past
that the oldest are dropped and counted (``Taken.dropped``).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

CAP = 1 << 16            # records a store keeps before dropping the oldest

_RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    """One resolved span: its name, the enclosing span's name (None at
    the top), the host clock at entry and exit (ns), and the device clock
    between its events (ms; None where CUDA was not in use)."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Taken(NamedTuple):
    """What ``take`` read: the spans in the order they closed, and how
    many older ones the cap dropped."""

    spans: List[Span]
    dropped: int


_POOL: List[torch.cuda.Event] = []


def _event_pair():
    """Two timing events from the pool, or None before CUDA is in use."""
    if not torch.cuda.is_initialized():
        return None
    while len(_POOL) < 2:
        _POOL.append(torch.cuda.Event(enable_timing=True))
    return _POOL.pop(), _POOL.pop()


def _recycle(events) -> None:
    if events is not None:
        _POOL.extend(events)


class Store:
    """The records of one scope: closed spans as (name, parent, start,
    end, events), the names of the spans open now, and the count dropped
    by the cap."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.records = collections.deque()
        self.open: List[str] = []
        self.dropped = 0

    def add(self, record) -> None:
        if len(self.records) >= self.cap:
            _recycle(self.records.popleft()[4])
            self.dropped += 1
        self.records.append(record)

    def take(self) -> Taken:
        """The records so far, resolved (a synchronize first if any holds
        events); the store is left empty."""
        records, dropped = list(self.records), self.dropped
        self.records.clear()
        self.dropped = 0
        if any(r[4] is not None for r in records):
            torch.cuda.synchronize()
        spans = [Span(name, parent, t0, t1,
                      ev[0].elapsed_time(ev[1]) if ev is not None else None)
                 for name, parent, t0, t1, ev in records]
        for r in records:
            _recycle(r[4])
        return Taken(spans, dropped)


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
_PROCESS = Store()
_scope: Optional[Store] = None       # the innermost recording()


class _On:
    __slots__ = ("name", "store", "parent", "start", "events", "range")

    def __init__(self, name: str, store: Store):
        self.name = name
        self.store = store

    def __enter__(self):
        store = self.store
        self.parent = store.open[-1] if store.open else None
        store.open.append(self.name)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        self.events = _event_pair()
        if self.events is not None:
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.store.open.pop()
        self.store.add((self.name, self.parent, self.start, end,
                        self.events))
        return False


def span(name: str):
    """A context manager marking the phase ``name`` (see the module's
    docstring); a shared no-op while tracing is off."""
    store = _scope
    if store is None:
        if not _profiler._is_profiler_enabled:
            return _OFF
        store = _PROCESS
    return _On(name, store)


@contextlib.contextmanager
def recording(cap: int = CAP) -> Iterator[Store]:
    """Record every span of the body into a store of its own (whether a
    profiler runs or not); read it with the store's ``take()``."""
    global _scope
    outer, store = _scope, Store(cap)
    _scope = store
    try:
        yield store
    finally:
        _scope = outer


def take() -> Taken:
    """The process's records (the spans of profiled stretches outside any
    ``recording()``) since the last ``take``, resolved; clears them."""
    return _PROCESS.take()
