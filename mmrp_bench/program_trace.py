"""The program's own spans (``mmrp_tpu_torch/utils/trace.py``) lined up with
a profiler trace: each idle gap of the device put down to the innermost span
open on the host when it began, and the per-layer numbers that gives.

    python3 -m mmrp_bench.program_trace --workload <cell> --seed <n> [--out FILE]

runs a cell's set-up as its file in ``drivers/`` does, then, on the card:

- the cost of recording (:func:`paired_cost`): train steps one at a time,
  or blocks of stream batches, timed on the host clock with recording off
  and on in turns (off, on, on, off, ...), and one empty span's host time;
- a traced stretch inside ``trace.recording()``, as ``drivers/`` traces it:
  the traffic's ``trace_steps`` train steps under a profiler of device
  activity alone, or its ``trace_batches`` batch periods under a profiler of
  host and device activity with the benchmark's spans installed.

It prints one JSON line: the idle gaps by span, :data:`READERS`' numbers,
the clock check of the train step's reads (:func:`clock_violations`) and
the cost; ``--out`` writes it with every record and gap.

A record's times are ``time.time_ns()``; ``start_ns - trace_start_ns`` of
the profile over 1000 puts it on the trace's microseconds
(:func:`on_profile`).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from mmrp_bench import harness
from mmrp_bench.trace import _clip, _union, is_annotation

OUTSIDE = "host outside the spans"
READS = ("train.read_losses", "train.read_norm")


def on_profile(records, trace_start_ns: int) -> List[list]:
    """``[name, id, parent, start_us, end_us]`` per record, on the trace's
    microseconds; a record still open when the recording ended is left out
    (its children keep their parent's index)."""
    return [[r.name, r.id, r.parent, (r.start_ns - trace_start_ns) / 1e3,
             (r.end_ns - trace_start_ns) / 1e3] for r in records if r.end_ns is not None]


def device_ops(events, span_names: Sequence[str] = ()) -> List[Tuple[float, float, str, int]]:
    """(start, end, name, correlation id) of every device operation of a
    profile's events, by start; the spans' own ranges are no operation."""
    from torch.autograd import DeviceType

    ops = [(e.time_range.start, e.time_range.end, e.name, e.id) for e in events
           if e.device_type == DeviceType.CUDA and not is_annotation(e.name, span_names)]
    return sorted(ops)


def launches(events) -> Dict[int, float]:
    """{correlation id: host time of the launch}: the CUDA runtime's calls
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) in a profile of host
    activity, which share their operation's correlation id."""
    from torch.autograd import DeviceType

    return {e.id: e.time_range.start for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("cu")}


def holes(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] in which no device operation ran."""
    busy = _union(_clip([(a, b) for a, b, _, _ in ops], lo, hi))
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def attribute(gaps, opened) -> List[list]:
    """``[start, end, name]`` per gap: the innermost (shortest) of
    ``opened`` ((start, end, name) host extents) open when it began."""
    out = []
    for a, b in gaps:
        inner = [t for t in opened if t[0] <= a < t[1]]
        out.append([a, b, min(inner, key=lambda t: t[1] - t[0])[2] if inner else OUTSIDE])
    return out


def summary(attributed, top: int = 10) -> List[list]:
    """Idle seconds by name, the ``top`` largest first."""
    by: Dict[str, float] = {}
    for a, b, name in attributed:
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def clock_violations(records: List[list], ops, tol_us: float = 50.0) -> List[dict]:
    """The train step's reads against the device: a read's span ends once its
    copy to the host has landed, and nothing the host issues after it can
    start before it ends. For every ``train.read_*`` span, its copy (the last
    device-to-host copy that starts before the span's end) ends no later than
    ``tol_us`` after the span's end, and the next device operation starts no
    earlier than ``tol_us`` before it."""
    starts = [o[0] for o in ops]
    bad = []
    for name, sid, _, s, e in records:
        if name not in READS:
            continue
        i = bisect.bisect_left(starts, e) - 1
        while i >= 0 and "DtoH" not in ops[i][2]:
            i -= 1
        if i < 0:
            bad.append({"span": name, "id": sid, "end": e, "why": "no copy before its end"})
            continue
        late = ops[i][1] - e
        early = e - ops[i + 1][0] if i + 1 < len(ops) else float("-inf")
        if late > tol_us or early > tol_us:
            bad.append({"span": name, "id": sid, "end": e, "copy_ends_after": late,
                        "next_starts_before": early})
    return bad


def first_ops(records: List[list], ops, launch: Dict[int, float], lo: float,
              hi: float) -> Dict[int, float]:
    """{batch: queue us} for each ``stream.dispatch`` starting in [lo, hi):
    from the span's start to the device start of the first operation whose
    launch falls inside the span."""
    out = {}
    for name, sid, _, s, e in records:
        if name != "stream.dispatch" or not lo <= s < hi:
            continue
        mine = [o[0] for o in ops if s <= launch.get(o[3], -1.0) <= e]
        if mine:
            out[sid] = min(mine) - s
    return out


# --- the per-layer numbers, each from a layer_data dict holding "program" ---

def _prog(data) -> Optional[dict]:
    return data.get("program") if data else None


def sync_idle_ms_train(data) -> Optional[float]:
    """Device idle a traced step in gaps that opened while a read of the
    losses or of the gradient norm was the innermost span, ms."""
    p = _prog(data)
    if p is None or "steps" not in p:
        return None
    return sum(b - a for a, b, name in p["idle_gaps"] if name in READS) / 1e3 / p["steps"]


def issue_ms_train(data) -> Optional[float]:
    """Host time a traced step in ``train.step`` less its read spans, ms."""
    p = _prog(data)
    if p is None or "steps" not in p:
        return None
    recs = p["records"]
    total = sum(e - s for name, _, _, s, e in recs if name == "train.step")
    reads = sum(e - s for name, _, _, s, e in recs if name in READS)
    return (total - reads) / 1e3 / p["steps"]


def host_reads_train(data) -> Optional[float]:
    """Reads of a device value to the host a traced step."""
    p = _prog(data)
    if p is None or "steps" not in p:
        return None
    return p["counts"].get("host_reads", 0) / p["steps"]


def queue_ms_stream(data) -> Optional[float]:
    """Mean over the traced batches of the time from a batch's dispatch to
    the device start of its first operation, ms."""
    p = _prog(data)
    if p is None or not p.get("queue_us"):
        return None
    return statistics.fmean(p["queue_us"].values()) / 1e3


READERS = {"sync_idle_ms.train": sync_idle_ms_train, "issue_ms.train": issue_ms_train,
           "host_reads.train": host_reads_train, "queue_ms.stream": queue_ms_stream}


# --- on the card ------------------------------------------------------------

def train_program(rec, prof, steps: int) -> dict:
    """``program`` of a traced stretch of ``steps`` train steps under a
    profiler of device activity alone: the window runs from the first device
    operation to the end of the last, as ``drivers/train.py``'s."""
    records = on_profile(rec.records, prof.profiler.kineto_results.trace_start_ns())
    ops = device_ops(prof.events())
    lo, hi = ops[0][0], max(o[1] for o in ops)
    gaps = attribute(holes(ops, lo, hi), [(s, e, n) for n, _, _, s, e in records])
    return {"records": records, "counts": rec.counts, "steps": steps, "idle_gaps": gaps,
            "idle_by_span": summary(gaps), "window_us": hi - lo,
            "clock_violations": clock_violations(records, ops)}


def stream_program(rec, prof, span_names, n: int) -> dict:
    """``program`` of the stream's traced stretch (a profiler of host and
    device activity): the window runs from the 3rd loader hand-over to the
    (n+3)-th, as ``drivers/stream.py``'s; gaps go to the innermost of the
    benchmark's spans and the program's."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    records = on_profile(rec.records, prof.profiler.kineto_results.trace_start_ns())
    ops = device_ops(events, span_names)
    marks = sorted(e.time_range.start for e in events
                   if e.device_type == DeviceType.CPU and e.name == "bench.yield")
    lo, hi = marks[2], marks[2 + n]
    opened = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CPU and is_annotation(e.name, span_names)]
    opened += [(s, e, name) for name, _, _, s, e in records]
    gaps = attribute(holes(ops, lo, hi), opened)
    launch = launches(events)
    return {"records": records, "counts": rec.counts, "batches": n, "idle_gaps": gaps,
            "idle_by_span": summary(gaps), "window_us": hi - lo,
            "queue_us": first_ops(records, ops, launch, lo, hi),
            "ops_launched": sum(o[3] in launch for o in ops), "ops": len(ops)}


# timed with recording off and on in turns: train steps, stream blocks
TRAIN_COST_STEPS = 120
STREAM_COST_BLOCKS, STREAM_BLOCK = 16, 24


def _turns(n: int) -> List[bool]:
    """off, on, on, off, off, on, ...: recording on in half of ``n`` blocks."""
    return [(i % 4) in (1, 2) for i in range(n)]


def paired_cost(values: Sequence[float], lower_better: bool) -> dict:
    """The cost of recording from ``values`` timed in :func:`_turns`: per
    turn of four (off, on, on, off), the on pair against the off pair, as a
    share (positive: recording costs); their median and quartiles, which a
    drift of the host's speed across turns does not move."""
    sign = 1 if lower_better else -1
    d = [sign * ((q[1] + q[2]) / (q[0] + q[3]) - 1)
         for q in (values[i:i + 4] for i in range(0, len(values) - 3, 4))]
    return {"median": statistics.median(d), "quartiles": statistics.quantiles(d, n=4),
            "turns": len(d)}


def span_cost_us(n: int = 20000) -> float:
    """Host microseconds of one empty span while recording."""
    from mmrp_tpu_torch.utils import trace

    with trace.recording():
        t = time.perf_counter()
        for _ in range(n):
            with trace.span("cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6


def run_train(ctx) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmrp_bench import gen
    from mmrp_bench.drivers.train import make_ring
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step
    from mmrp_tpu_torch.utils import trace

    tr = ctx.traffic
    model, w = harness.build_model(ctx, tr.get("model_overrides"))
    del w
    tcfg = Config(**tr["train_config"])
    state = init_train_state(model, tcfg, seed=tcfg.seed, total_steps=tr["total_steps"],
                             kg_dim=tr["kg_dim"])
    state.params["kg_proj"].copy_(gen.kg_proj(ctx.config["fusion"]["joint_dim"],
                                              tr["kg_dim"], ctx.seed, ctx.device))
    ring, _, pw = make_ring(ctx)
    step = make_train_step(model, tcfg, pw)
    R, i = len(ring), 0
    for _ in range(tr["reference_steps"] + tr["warmup_steps"]):
        step(state, ring[i % R])
        i += 1
    torch.cuda.synchronize()
    times = []
    for on in _turns(TRAIN_COST_STEPS):
        with trace.recording() if on else contextlib.nullcontext():
            t = time.perf_counter()
            step(state, ring[i % R])
            times.append((time.perf_counter() - t) * 1e3)
        i += 1
    steps = tr["trace_steps"]
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for j in range(steps):
                step(state, ring[(i + j) % R])
            torch.cuda.synchronize()
    out = train_program(rec, prof, steps)
    out["cost"] = {"step_ms": times, **paired_cost(times, lower_better=True)}
    return out


def run_stream(ctx) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmrp_bench import gen
    from mmrp_bench.drivers.stream import SPANS, Feed, install_spans, make_ring
    from mmrp_bench.trace import Spans, counter_sources
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
    from mmrp_tpu_torch.serve.stream import StreamingPipeline
    from mmrp_tpu_torch.utils import trace

    tr, cfg = ctx.traffic, ctx.config
    model, w = harness.build_model(ctx)
    del w
    g = gen.gallery(tr["gallery"]["rows"], tr["gallery"]["dim"], ctx.seed, ctx.device)
    engine = RetrievalEngine(g.cpu().numpy(), [str(i) for i in range(g.shape[0])],
                             device=ctx.device)
    del g
    thr = gen.thresholds(cfg["num_classes"], *tr["thresholds"], ctx.seed)
    ring, _ = make_ring(ctx)
    pipe = StreamingPipeline(model, engine, None, thr, K=tr["K"])
    for _ in pipe.run(iter(ring[: tr["warmup_batches"]]), depth=tr["depth"]):
        pass
    torch.cuda.synchronize()
    rates = []
    for on in _turns(STREAM_COST_BLOCKS):
        with trace.recording() if on else contextlib.nullcontext():
            t = time.perf_counter()
            for _ in pipe.run(Feed(ring, count=STREAM_BLOCK), depth=tr["depth"]):
                pass
            rates.append(STREAM_BLOCK * tr["batch"] / (time.perf_counter() - t))
    spans = Spans(counter_sources())
    install_spans(spans, pipe, model, engine)
    for _ in pipe.run(iter(ring[:2]), depth=tr["depth"]):
        pass
    n = tr["trace_batches"]
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in pipe.run(Feed(ring, count=n + 4, marker=True), depth=tr["depth"]):
                pass
            torch.cuda.synchronize()
    out = stream_program(rec, prof, SPANS, n)
    out["cost"] = {"pairs_per_s": rates, **paired_cost(rates, lower_better=False)}
    return out


def main(argv=None) -> int:
    from mmrp_bench.run import cache_env, card_note

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", help="a file for the line with every record and gap")
    args = ap.parse_args(argv)
    cache_env(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 3
    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    ctx = harness.Ctx(cell=cell["name"], config=harness.config_file(bench, cell["config"]),
                      traffic=harness.traffic_file(cell["traffic"]),
                      limits=harness.limits_file(cell["name"]), seed=args.seed, seconds=0.0,
                      trace=True, device="cuda", log=lambda s: print(s, file=sys.stderr))
    prog = (run_train if ctx.traffic["driver"] == "train" else run_stream)(ctx)
    data = {"program": prog}
    line = {"workload": cell["name"], "seed": args.seed, "card": card_note(),
            "metrics": {k: f(data) for k, f in READERS.items() if f(data) is not None},
            "idle_by_span": prog["idle_by_span"], "span_cost_us": span_cost_us(),
            **{k: prog[k] for k in ("cost", "window_us", "counts", "clock_violations",
                                    "ops_launched", "ops") if k in prog}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**line, "program": prog}))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
