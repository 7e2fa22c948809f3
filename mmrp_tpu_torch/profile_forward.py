"""Where the device time of one flagship forward, or train step, goes.

    python -m mmrp_tpu_torch.profile_forward [--batch 8 64] [--text-len 64 512] [--out FILE]
    python -m mmrp_tpu_torch.profile_forward --train [--batch 64] [--out FILE]

On one CUDA device: builds the flagship model (Swin-B 224 px, ClinicalBERT
dims, 5 fusion layers at 1024) in bf16 from a seeded init, on each route with
the same weights: the default Swin route (``whole``), the
K1 + K2 route (``k1k2``, ``whole_block=False``) and the int8 serving mixes
(``int8_static``, with act_amax calibrated on 8 seeded images by the plain
f32 Swin forward, and ``int8``; ``MultiModalConfig.from_config``). For each
text length (default 64), batch and route it prints the
forward time without the profiler (median of 10 CUDA-event timings), then
profiles 5 forwards after 3 warm-ups with ``torch.profiler`` and sums the
device time of every kernel by kind: the attention launch of the Swin blocks
(K1's and the whole-block kernel's ``window_attn_wgmma``), K3's three
launches (the q/k/v GEMM, the attention tile, the output GEMM and its
epilogue), K1's projection (``k1_proj_wgmma``), K2, the whole-block MLP epilogue,
library GEMMs of the plain layers, and everything else (copies, casts,
elementwise), the int8 forms of the whole-block epilogue counted apart.
Device busy is the sum over kernels; the idle share is set
against the unprofiled forward time, since the profiler's own host cost
stretches the profiled wall time. A kind whose launch count is not a whole
multiple of the forwards marks a trace that lost events (``complete`` false).
One JSON line per (route, batch) goes to stdout and to ``--out``.

``--train`` does the same for ``train/joint.py::make_train_step`` on the
flagship at each batch instead (route ``train``: default dropout and drop path,
f32 master weights, bf16 Adam mu, a 300-dim KG projection, one seeded batch
repeated): the step time without the profiler, then the device time by kind,
where the raw-layout attention core's forward (C-F) and backward (C-B, with
its chunk reduction) are kinds of their own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.utils.convert import init_params

KINDS = (  # (kind, test on the kernel name), first match wins
    ("wattn core forward (C-F)", lambda n: "core_fwd_kernel" in n),
    ("wattn core backward (C-B)", lambda n: "core_bwd_kernel" in n or "sum_chunks_kernel" in n),
    ("swin attention phase", lambda n: "window_attn_wgmma" in n),
    ("K3 q/k/v GEMM", lambda n: "qkv_kernel<" in n),
    ("K3 attention tile", lambda n: "attn_kernel<" in n),
    ("K3 output GEMM + epilogue", lambda n: "out_kernel<" in n),
    ("K1 projection epilogue", lambda n: "k1_proj_wgmma" in n),
    ("K2 ln_mlp", lambda n: "ln_mlp_kernel" in n),
    ("whole-block MLP epilogue, int8", lambda n: "block_mlp_q8_kernel" in n
     or "block_mlp_kernel<true" in n),
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


def report(rec: dict, ms: float) -> str:
    """Print one record's breakdown; return it as a JSON line."""
    rec["idle_share_vs_unprofiled"] = 1.0 - rec["busy_ms"] / ms
    print(f"route {rec['route']} batch {rec['batch']} L{rec.get('text_len', 64)}: {ms:.3f} "
          f"ms, busy "
          f"{rec['busy_ms']:.3f} ms, profiled span {rec['profiled_span_ms']:.3f} ms"
          + ("" if rec["complete"] else " (the trace lost events)"), flush=True)
    for kind, v in rec["kinds"].items():
        print(f"  {kind:36s} {v['ms']:9.3f} ms {v['ms'] / rec['busy_ms']:6.1%} "
              f"{v['launches']:7.1f} launches", flush=True)
    line = json.dumps(rec)
    print(line, flush=True)
    return line


ROUTES = ("whole", "k1k2", "int8_static", "int8")


def route_models(dev: torch.device) -> dict:
    """route -> the flagship model on it, all with the default route's weights."""
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.quant_calib import calibrate_swin_act_amax

    cfg = MultiModalConfig.flagship()
    whole = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev).eval()
    init_params(whole, seed=0)
    cfgs = {"k1k2": dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin,
                                                                      whole_block=False)),
            "int8": MultiModalConfig.from_config(Config(serve_quant="int8"), flagship=True)}
    images = np.random.default_rng(0).random((8, 224, 224, 3), dtype=np.float32)
    amax = calibrate_swin_act_amax(whole.backbones.swin, images)
    static = MultiModalConfig.from_config(Config(serve_quant="int8_static"), flagship=True)
    cfgs["int8_static"] = dataclasses.replace(
        static, swin=dataclasses.replace(static.swin, act_amax=amax))
    models = {}
    for route in ROUTES:
        if route == "whole":
            models[route] = whole
            continue
        models[route] = MultiModalRetrievalModel(cfgs[route], dtype=torch.bfloat16,
                                                 device=dev).eval()
        models[route].load_state_dict(whole.state_dict())
    return models


def forward_lines(card: str, batches, lengths, dev: torch.device) -> list:
    """One record per (text length, batch, route) for the serving forward."""
    cfg = MultiModalConfig.flagship()
    models = route_models(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    lines = []
    for L in lengths:
        for batch in batches:
            inputs = (torch.rand((batch, 224, 224, 3), generator=gen, device=dev),
                      torch.randint(0, cfg.text.vocab_size, (batch, L), generator=gen,
                                    device=dev),
                      torch.ones((batch, L), dtype=torch.int64, device=dev))
            for route, model in models.items():
                fwd = serving_forward(model)
                ms = forward_ms(fwd, inputs)
                rec = {"card": card, "route": route, "batch": batch, "text_len": L,
                       "forward_ms": ms, **profile(fwd, inputs)}
                lines.append(report(rec, ms))
    return lines


def train_lines(card: str, batches, dev: torch.device) -> list:
    """One record per batch for the flagship train step."""
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step

    cfg = MultiModalConfig.flagship()
    model = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev)
    init_params(model, seed=0)
    tcfg = Config(lr=1e-4)
    rng = np.random.default_rng(1)
    lines = []
    for batch in batches:
        state = init_train_state(model, tcfg, seed=0, total_steps=1000, kg_dim=300)
        step = make_train_step(model, tcfg, pos_weight=np.ones(cfg.num_classes, np.float32))
        data = {"image": rng.random((batch, 224, 224, 3), dtype=np.float32),
                "input_ids": rng.integers(0, cfg.text.vocab_size, (batch, 64)),
                "attention_mask": np.ones((batch, 64), np.int64),
                "labels": (rng.random((batch, cfg.num_classes)) < 0.3).astype(np.float32),
                "kg_target": rng.standard_normal((batch, 300)).astype(np.float32),
                "kg_target_valid": np.ones(batch, np.float32)}
        data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}

        def run(state=state, step=step, data=data):
            step(state, data)  # the state is updated in place

        ms = forward_ms(run, ())
        rec = {"card": card, "route": "train", "batch": batch, "step_ms": ms,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               **profile(run, ())}
        lines.append(report(rec, ms))
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=None)
    ap.add_argument("--text-len", type=int, nargs="+", default=[64],
                    help="text lengths of the serving forward (up to 512)")
    ap.add_argument("--train", action="store_true",
                    help="profile the flagship train step (default batch 64)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.train:
        lines = train_lines(card, args.batch or [64], dev)
    else:
        lines = forward_lines(card, args.batch or [8, 64], args.text_len, dev)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
