"""Spans and counters of the port's own layers.

A span names an extent of host time: ``with span("train.forward"): ...``.
It is recorded only inside :func:`recording`; anywhere else it costs one
flag check and returns a shared null context. A record is
``(name, id, parent, start_ns, end_ns)``:

- ``id``: the train step's count or the stream batch's dispatch number;
  a span given none takes its enclosing span's, so every span of one step
  or one batch shares it;
- ``parent``: the index of the enclosing span's record in the same list,
  or None at the top;
- ``start_ns`` / ``end_ns``: ``time.time_ns()``, the clock ``torch.profiler``
  gives its trace start on, so a record lines up with a profiler trace:
  ``(start_ns - prof.profiler.kineto_results.trace_start_ns()) / 1000`` is
  the record's start in the trace's microseconds. ``end_ns`` is None for a
  span still open when the recording ended.

Spans are recorded on the thread that opened the recording; other threads
record nothing. A span is no ``torch.profiler.record_function``: it draws
nothing on the device timeline and launches nothing.

Counters (:func:`count`, :func:`counters`) always count, as the kernel
wrappers' ``launches*`` counters do. :func:`host_read` is a read of a device
value into a Python float, which waits for the device to reach it: counted
in ``host_reads`` and, while recording, spanned under its own name.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional


class Record(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int]


class Recording:
    """What one :func:`recording` collected: ``records`` (:class:`Record`,
    in the order the spans opened) and ``counts``, each counter's growth
    over the recording (complete once the ``with`` block has left)."""

    def __init__(self):
        self.records: List[Record] = []
        self.counts: Dict[str, int] = {}
        self._open: List[list] = []  # records as lists while they are filled
        self._stack: List[int] = []
        self._thread = threading.get_ident()


_active: Optional[Recording] = None
_NULL = contextlib.nullcontext()
_counters: Dict[str, int] = {}


class _Span:
    __slots__ = ("rec", "name", "id", "index")

    def __init__(self, rec: Recording, name: str, id: Optional[int]):
        self.rec, self.name, self.id = rec, name, id

    def __enter__(self):
        rec = self.rec
        if threading.get_ident() != rec._thread:
            self.index = None
            return
        parent = rec._stack[-1] if rec._stack else None
        if self.id is None and parent is not None:
            self.id = rec._open[parent][1]
        self.index = len(rec._open)
        rec._open.append([self.name, self.id, parent, time.time_ns(), None])
        rec._stack.append(self.index)

    def __exit__(self, *exc):
        if self.index is not None:
            self.rec._open[self.index][4] = time.time_ns()
            self.rec._stack.pop()
        return False


def span(name: str, id: Optional[int] = None):
    """A context manager that records ``name`` over its extent while a
    :func:`recording` is active (module docstring)."""
    if _active is None:
        return _NULL
    return _Span(_active, name, id)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Records every span opened on this thread within the block. Nested
    recordings each collect their own extent."""
    global _active
    outer, rec = _active, Recording()
    before = dict(_counters)
    _active = rec
    try:
        yield rec
    finally:
        _active = outer
        rec.records = [Record(*r) for r in rec._open]
        rec.counts = {k: v - before.get(k, 0) for k, v in _counters.items()
                      if v != before.get(k, 0)}


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value since the process started."""
    return dict(_counters)


def host_read(x, name: str) -> float:
    """``float(x)``, counted in ``host_reads`` and spanned as ``name``."""
    count("host_reads")
    if _active is None:
        return float(x)
    with _Span(_active, name, None):
        return float(x)
