"""Where the device time of one flagship forward goes, per Swin route.

    python -m mmrp_tpu_torch.profile_forward [--batch 8 64] [--out FILE]

On one CUDA device: builds the flagship model (Swin-B 224 px, ClinicalBERT
dims, 5 fusion layers at 1024) in bf16 from a seeded init, once on the
default Swin route and once on the K1 + K2 route (``whole_block=False``) with
the same weights. For each route and batch (text length 64) it prints the
forward time without the profiler (median of 10 CUDA-event timings), then
profiles 5 forwards after 3 warm-ups with ``torch.profiler`` and sums the
device time of every kernel by kind: the attention phase of the Swin blocks
(``attention_kernel<32>``, head dim 32) and of BERT / fusion (other head
dims), the K1 / K3 projection epilogue, K2, the whole-block MLP epilogue,
library GEMMs of the plain layers, and everything else (copies, casts,
elementwise). Device busy is the sum over kernels; the idle share is set
against the unprofiled forward time, since the profiler's own host cost
stretches the profiled wall time. A kind whose launch count is not a whole
multiple of the forwards marks a trace that lost events (``complete`` false).
One JSON line per (route, batch) goes to stdout and to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType

from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.utils.convert import init_params

KINDS = (  # (kind, test on the kernel name), first match wins
    ("swin attention phase", lambda n: "attention_kernel<32>" in n),
    ("bert/fusion attention phase", lambda n: "attention_kernel" in n),
    ("K1/K3 projection epilogue", lambda n: "proj_epilogue_kernel" in n),
    ("K2 ln_mlp", lambda n: "ln_mlp_kernel" in n),
    ("whole-block MLP epilogue", lambda n: "block_mlp_kernel" in n),
    ("library GEMMs", lambda n: any(k in n.lower() for k in ("gemm", "cutlass", "xmma",
                                                             "nvjet", "sm90_", "cublas"))),
    ("other (copies, casts, elementwise)", lambda n: True),
)


def kind_of(name: str) -> str:
    return next(kind for kind, match in KINDS if match(name))


def forward_ms(fwd, args, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fwd(*args)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fwd(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile(fwd, args, reps: int = 5) -> dict:
    for _ in range(3):
        fwd(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fwd(*args)
        torch.cuda.synchronize()
    kinds = {kind: [0.0, 0] for kind, _ in KINDS}
    first, last = None, None
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        agg = kinds[kind_of(evt.name)]
        agg[0] += us / 1e3 / reps
        agg[1] += 1
        first = evt.time_range.start if first is None else min(first, evt.time_range.start)
        last = evt.time_range.end if last is None else max(last, evt.time_range.end)
    busy = sum(ms for ms, _ in kinds.values())
    return {"busy_ms": busy, "profiled_span_ms": (last - first) / 1e3 / reps if first else None,
            "complete": all(n % reps == 0 for _, n in kinds.values()),
            "kinds": {k: {"ms": ms, "launches": n / reps} for k, (ms, n) in kinds.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = MultiModalConfig.flagship()
    whole = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev).eval()
    init_params(whole, seed=0)
    k1k2 = MultiModalRetrievalModel(
        dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, whole_block=False)),
        dtype=torch.bfloat16, device=dev).eval()
    k1k2.load_state_dict(whole.state_dict())
    gen = torch.Generator(device=dev).manual_seed(1)
    lines = []
    for batch in args.batch:
        inputs = (torch.rand((batch, 224, 224, 3), generator=gen, device=dev),
                  torch.randint(0, cfg.text.vocab_size, (batch, 64), generator=gen,
                                device=dev),
                  torch.ones((batch, 64), dtype=torch.int64, device=dev))
        for route, model in (("whole", whole), ("k1k2", k1k2)):
            fwd = serving_forward(model)
            ms = forward_ms(fwd, inputs)
            rec = {"card": card, "route": route, "batch": batch, "forward_ms": ms,
                   **profile(fwd, inputs)}
            rec["idle_share_vs_unprofiled"] = 1.0 - rec["busy_ms"] / ms
            print(f"route {route} batch {batch}: forward {ms:.3f} ms, busy "
                  f"{rec['busy_ms']:.3f} ms, profiled span {rec['profiled_span_ms']:.3f} ms"
                  + ("" if rec["complete"] else " (the trace lost events)"), flush=True)
            for kind, v in rec["kinds"].items():
                print(f"  {kind:36s} {v['ms']:9.3f} ms {v['ms'] / rec['busy_ms']:6.1%} "
                      f"{v['launches']:7.1f} launches", flush=True)
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
