"""The benchmark's own spans around the calls into each layer, and the
reduction of a profiler trace to device times.

A span (:class:`Spans`) is a ``torch.profiler.record_function`` range with
the same name, plus a host-clock duration per call and the growth of the
port's launch counters over the call (:func:`counter_sources`: every
``launches*`` counter of the kernel wrappers, found by walking
``mmrp_tpu_torch.ops``). :func:`reduce_profile` turns a ``torch.profiler``
run into:

- ``busy_s``: the union of the intervals in which a kernel, copy or set ran
  on the device, within the traced window;
- the device time of the kernels launched inside each span (those that
  start inside the span's range on the device timeline);
- completeness. A span's occurrences that made the same wrapper calls
  (the same counter growth) have to hold the same number of the port's
  kernels (``mmrp::``) and of kernels in all, and at least one of the
  port's where a counter grew; every occurrence on the host has its range
  on the device. Without spans the trace's totals are held to those that
  the caller expects (a train step traced alone, times the steps). A trace
  that lost events reports no device metric.
"""

from __future__ import annotations

import contextlib
import importlib
import pkgutil
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mmrp_bench.work import is_collective, is_port_kernel, kind_of


def counter_sources(package: str = "mmrp_tpu_torch.ops") -> Dict[str, Tuple[object, str]]:
    """{"module.function.attribute": (function, attribute)} for every launch
    counter of the port: an int attribute named ``launches*`` of a function
    defined in a module of ``package``. A module that is gone or does not
    import is skipped."""
    pkg = importlib.import_module(package)
    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        try:
            mod = importlib.import_module(f"{package}.{info.name}")
        except Exception:  # noqa: BLE001 - a module that does not import has no counter
            continue
        for name, obj in sorted(vars(mod).items()):
            if not callable(obj) or getattr(obj, "__module__", None) != mod.__name__:
                continue
            for attr, value in sorted(getattr(obj, "__dict__", {}).items()):
                if attr.startswith("launches") and type(value) is int:
                    out[f"{info.name}.{name}.{attr}"] = (obj, attr)
    return out


def counts(counters: Dict[str, Tuple[object, str]]) -> Tuple[int, ...]:
    return tuple(getattr(obj, attr) for obj, attr in counters.values())


def growth(before: Sequence[int], after: Sequence[int]) -> Tuple[int, ...]:
    return tuple(b - a for a, b in zip(before, after))


def is_copy(name: str) -> bool:
    """A copy or set, which may run on another stream inside a span's range."""
    return name.startswith("Memcpy") or name.startswith("Memset")


class Spans:
    """Host-clock durations and counter growth per span name; each span is
    also a profiler range of the same name."""

    def __init__(self, counters: Optional[Dict] = None):
        self.host: Dict[str, List[float]] = defaultdict(list)
        self.calls: Dict[str, List[Tuple[int, ...]]] = defaultdict(list)
        self.counters = counters or {}

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        c0 = counts(self.counters)
        t0 = time.perf_counter()
        with record_function(name):
            yield
        self.host[name].append(time.perf_counter() - t0)
        self.calls[name].append(growth(c0, counts(self.counters)))

    def wrap(self, fn: Callable, name: str) -> Callable:
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def wrap_method(self, obj, attr: str, name: str) -> None:
        """Replace ``obj.attr`` (a bound method, or a module's forward) by
        its spanned version on this instance."""
        setattr(obj, attr, self.wrap(getattr(obj, attr), name))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def is_annotation(name: str, span_names: Sequence[str]) -> bool:
    """A span's range as the profiler draws it on the device timeline (from
    the first to the last kernel linked to it), not an operation."""
    return name in span_names or name.startswith("bench.") or name.startswith("train.")


def reduce_profile(prof, span_names: Sequence[str], window: Optional[Tuple[str, int, int]],
                   spans: Optional[Spans] = None,
                   expect: Optional[Tuple[int, int]] = None) -> dict:
    """Device times from a finished ``torch.profiler.profile``.

    ``window``: (marker span, first, last): the traced window runs from the
    start of the ``first``-th occurrence of the marker span to the start of
    its ``last``-th (host timestamps, the trace's clock); None: from the
    first device operation to the end of the last. ``spans``: the spans
    whose occurrences in this trace are held to each other (the module
    docstring). ``expect``: (the port's kernels, device operations) the
    whole trace has to hold.

    A kernel belongs to a span occurrence when it starts inside that
    occurrence's range on the device timeline. The profiler links library
    kernels to the operation that launched them, but not the port's kernels,
    which the library launches from outside any operation; every span here
    starts and ends with library work, so its device range holds all of its
    kernels.
    """
    import bisect

    from torch.autograd import DeviceType

    events = list(prof.events())
    dev_all = [e for e in events if e.device_type == DeviceType.CUDA]
    device = [e for e in dev_all if not is_annotation(e.name, span_names)]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    if window is None:
        lo, hi = min(a for a, _ in intervals), max(b for _, b in intervals)
    else:
        marker, first, last = window
        starts = sorted(e.time_range.start for e in cpu if e.name == marker)
        lo, hi = starts[first], starts[last]
    busy = _union(_clip(intervals, lo, hi))
    busy_us = sum(b - a for a, b in busy)

    by_kind: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    port_events, nonport_s = 0, 0.0
    for e in device:
        s = (e.time_range.end - e.time_range.start) / 1e6
        by_kind[kind_of(e.name)] += s
        by_name[e.name] += s
        if is_port_kernel(e.name):
            port_events += 1
        elif not is_collective(e.name):
            nonport_s += s

    device.sort(key=lambda e: e.time_range.start)
    kstart = [e.time_range.start for e in device]
    span_device: Dict[str, float] = {}
    span_counts: Dict[str, List[Tuple[int, int]]] = {}
    for name in span_names:
        ranges = sorted((e.time_range.start, e.time_range.end) for e in dev_all
                        if e.name == name)
        secs, found = 0.0, []
        for a, b in ranges:
            inside = device[bisect.bisect_left(kstart, a):bisect.bisect_right(kstart, b)]
            secs += sum(k.time_range.end - k.time_range.start for k in inside) / 1e6
            found.append((sum(is_port_kernel(k.name) for k in inside),
                          sum(not is_copy(k.name) for k in inside)))
        span_device[name], span_counts[name] = secs, found

    why = []
    if spans is not None:
        for name in span_names:
            calls, found = spans.calls.get(name, []), span_counts[name]
            if len(calls) != len(found):
                why.append(f"{name}: {len(found)} device ranges for {len(calls)} calls")
                continue
            groups: Dict[Tuple[int, ...], set] = defaultdict(set)
            for call, got in zip(calls, found):
                groups[call].add(got)
            for call, got in groups.items():
                if len(got) > 1 or (any(call) and min(p for p, _ in got) == 0):
                    why.append(f"{name}: (port kernels, kernels) {sorted(got)} for one call set")
    if expect is not None and expect != (port_events, len(device)):
        why.append(f"(port kernels, device operations) {(port_events, len(device))}, "
                   f"expected {expect}")
    gaps = idle_gaps(busy, lo, hi, cpu, span_names)
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6, "complete": not why,
            "incomplete_why": why, "span_device_s": span_device, "span_counts": span_counts,
            "port_events": port_events, "device_events": len(device),
            "nonport_device_s": nonport_s, "kind_device_s": dict(by_kind),
            "top_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": gaps}


def kinds_line(red: dict) -> str:
    """The trace's device seconds by kind of kernel (``work.KINDS``), for the log."""
    return ", ".join(f"{k} {v:.4f} s" for k, v in sorted(red["kind_device_s"].items(),
                                                            key=lambda kv: -kv[1]))


def idle_gaps(busy, lo, hi, cpu, span_names) -> List[Tuple[str, float]]:
    """The device's idle time in the window, summed by what the host was
    doing when each gap began: the innermost benchmark span open then, else
    "host outside the spans"; the 10 largest."""
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
             if edges[i + 1] > edges[i]]
    opened = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                     if is_annotation(e.name, span_names)),
                    key=lambda t: t[0])
    out: Dict[str, float] = defaultdict(float)
    for a, b in holes:
        inner = [t for t in opened if t[0] <= a < t[1]]
        name = min(inner, key=lambda t: t[1] - t[0])[2] if inner else "host outside the spans"
        out[name] += (b - a) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
