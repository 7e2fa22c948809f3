"""The reduction of a profiler trace: a span's occurrences that made the same
wrapper calls hold the same kernels, or the trace lost events and reports
no device metric; the busy time is a union of intervals, not a sum."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from mmrp_bench import trace

PORT = "void mmrp::(anonymous namespace)::qkv_kernel<false>(P)"
LIB = "nvjet_tst_128x128"


def ev(name, a, b, device=True):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           time_range=SimpleNamespace(start=a, end=b))


def fake(occurrences, drop=None):
    """Each occurrence of span "bench.s": its device range with a library kernel,
    two port kernels and a library kernel; ``drop``: (occurrence, kernel)
    lost."""
    events = []
    for i in range(occurrences):
        t = 100 * i
        events.append(ev("bench.s", t, t + 40))
        kernels = [ev(LIB, t, t + 10), ev(PORT, t + 10, t + 20), ev(PORT, t + 20, t + 30),
                   ev(LIB, t + 30, t + 40), ev("Memcpy HtoD (Pageable -> Device)", t + 5, t + 6)]
        if drop and drop[0] == i:
            del kernels[drop[1]]
        events += kernels
    return SimpleNamespace(events=lambda: events)


def spans_with(calls):
    s = trace.Spans()
    s.calls["bench.s"] = list(calls)
    return s


def test_a_complete_trace():
    red = trace.reduce_profile(fake(3), ["bench.s"], None, spans_with([(2,)] * 3))
    assert red["complete"], red["incomplete_why"]
    assert red["port_events"] == 6 and red["span_counts"]["bench.s"] == [(2, 4)] * 3
    assert red["busy_s"] == pytest.approx(120e-6)  # 3 x 40 us: the copy overlaps, the gaps idle
    assert red["window_s"] == pytest.approx(240e-6)
    assert red["nonport_device_s"] == pytest.approx(63e-6)
    line = trace.kinds_line(red)
    assert "K3 q/k/v GEMM 0.0001 s" in line and "library GEMMs 0.0001 s" in line


@pytest.mark.parametrize("lost", [1, 0, 4])
def test_an_occurrence_that_lost_a_kernel_makes_the_trace_incomplete(lost):
    red = trace.reduce_profile(fake(3, drop=(1, lost)), ["bench.s"], None, spans_with([(2,)] * 3))
    assert red["complete"] is (lost == 4)  # a copy may run on another stream


def test_a_missing_occurrence_or_call_set_makes_the_trace_incomplete():
    assert not trace.reduce_profile(fake(2), ["bench.s"], None, spans_with([(2,)] * 3))["complete"]
    # one occurrence made other calls: it is held to no other
    assert trace.reduce_profile(fake(2), ["bench.s"], None, spans_with([(2,), (3,)]))["complete"]


def test_a_trace_held_to_expected_totals():
    assert trace.reduce_profile(fake(2), [], None, expect=(4, 10))["complete"]
    assert not trace.reduce_profile(fake(2, drop=(0, 2)), [], None, expect=(4, 10))["complete"]
