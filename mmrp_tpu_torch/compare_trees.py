"""Two checkouts of the port on one card, timed in turns: end to end and on the host.

    python -m mmrp_tpu_torch.compare_trees --trees PARENT CHANGE [--rounds 12] [--out FILE]

Starts one worker process per checkout (each imports its own
``mmrp_tpu_torch`` and builds its own kernels) and builds in each, from the
same seed, the flagship in bf16 on the default Swin route and on the K1 + K2
route (``whole_block=False``), and the flagship train step (f32 masters,
batch 64, text length 64). Then, for ``--rounds`` rounds, each worker in turn
(A B B A, then B A A B, ...) times, while the other waits:

- the serving forward at batch 8 (default and K1 + K2 routes) and at batch 64
  (default route), text length 64: per forward, the CUDA-event time (what a
  caller waits for) and the host issue time (from the call until it returns,
  the card left to finish); the round's median of 10 forwards after 2 warm-ups;
- the train step: the median of 3 steps after 1 warm-up.

Each round gives one pair per metric (each side's mean over its two turns).
B is ``faster`` on a metric when it is lower in at least nine tenths of the
pairs and the medians differ by more than the interquartile range of A's own
values, ``slower`` the other way round, else ``unresolved``. After the rounds each
worker profiles 5 batch-8 forwards on the default route with ``cProfile`` and
reports the host time per call of every function of its ``mmrp_tpu_torch/ops``
(total and own), and the host cost of ``torch.cuda.device(d)`` around a call.
Every line goes to stdout and, as JSON, to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

METRICS = ("b8_whole_ms", "b8_whole_host_ms", "b8_k1k2_ms", "b8_k1k2_host_ms",
           "b64_whole_ms", "b64_whole_host_ms", "train_step_ms")


# -- the worker (one per checkout) -------------------------------------------

def _worker(tree: str) -> None:
    """Serve "time", "profile" and "quit" on stdin, one JSON line each on stdout."""
    sys.path[0] = tree  # this checkout's package, not the coordinator's
    os.chdir(tree)
    reply, sys.stdout = sys.stdout, sys.stderr  # only replies on the protocol stream

    import cProfile
    import dataclasses
    import pstats
    import time

    import numpy as np
    import torch

    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step
    from mmrp_tpu_torch.utils.convert import init_params

    dev = torch.device("cuda", 0)
    cfg = MultiModalConfig.flagship()
    whole = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev).eval()
    init_params(whole, seed=0)
    k1k2 = MultiModalRetrievalModel(
        dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, whole_block=False)),
        dtype=torch.bfloat16, device=dev).eval()
    k1k2.load_state_dict(whole.state_dict())
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(batch):
        return (torch.rand((batch, 224, 224, 3), generator=gen, device=dev),
                torch.randint(0, cfg.text.vocab_size, (batch, 64), generator=gen, device=dev),
                torch.ones((batch, 64), dtype=torch.int64, device=dev))

    forwards = {"b8_whole": (serving_forward(whole), inputs(8)),
                "b8_k1k2": (serving_forward(k1k2), inputs(8)),
                "b64_whole": (serving_forward(whole), inputs(64))}

    trained = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev)
    trained.load_state_dict(whole.state_dict())
    tcfg = Config(lr=1e-4)
    state = init_train_state(trained, tcfg, seed=0, total_steps=1000, kg_dim=300)
    step = make_train_step(trained, tcfg, pos_weight=np.ones(cfg.num_classes, np.float32))
    rng = np.random.default_rng(1)
    data = {"image": rng.random((64, 224, 224, 3), dtype=np.float32),
            "input_ids": rng.integers(0, cfg.text.vocab_size, (64, 64)),
            "attention_mask": np.ones((64, 64), np.int64),
            "labels": (rng.random((64, cfg.num_classes)) < 0.3).astype(np.float32),
            "kg_target": rng.standard_normal((64, 300)).astype(np.float32),
            "kg_target_valid": np.ones(64, np.float32)}
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}

    def timed(fn, args, reps, warmup):
        """(median CUDA-event ms, median host issue ms) of fn(*args)."""
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize()
        wall, host = [], []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn(*args)
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            wall.append(start.elapsed_time(end))
        return statistics.median(wall), statistics.median(host)

    def time_all():
        out = {}
        with torch.inference_mode():
            for name, (fwd, args) in forwards.items():
                out[f"{name}_ms"], out[f"{name}_host_ms"] = timed(fwd, args, 10, 2)
        out["train_step_ms"], _ = timed(lambda: step(state, data), (), 3, 1)
        return out

    def profile_host():
        fwd, args = forwards["b8_whole"]
        ops_dir = str(Path(tree).resolve() / "mmrp_tpu_torch" / "ops")
        with torch.inference_mode():
            for _ in range(3):
                fwd(*args)
            torch.cuda.synchronize()
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(5):
                fwd(*args)
            prof.disable()
            torch.cuda.synchronize()
        calls = {}
        for (path, line, func), (_, ncalls, own, total, _) in pstats.Stats(prof).stats.items():
            if str(Path(path).resolve()).startswith(ops_dir):
                calls[f"ops/{Path(path).name}:{line}({func})"] = {
                    "calls_per_forward": ncalls / 5, "us_per_call": total / ncalls * 1e6,
                    "own_us_per_call": own / ncalls * 1e6}
        n = 20000
        t0 = time.perf_counter()
        for _ in range(n):
            with torch.cuda.device(dev):
                pass
        ctx_us = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        for _ in range(n):
            _ = dev.index is None or dev.index == torch.cuda.current_device()
        check_us = (time.perf_counter() - t0) / n * 1e6
        return {"functions": calls, "device_context_us": ctx_us, "device_check_us": check_us}

    print(json.dumps({"ready": True}), file=reply, flush=True)
    while True:
        cmd = sys.stdin.readline().strip()
        if cmd in ("quit", ""):
            break
        result = time_all() if cmd == "time" else profile_host()
        print(json.dumps(result), file=reply, flush=True)


# -- the coordinator -----------------------------------------------------------

def verdict(pairs) -> dict:
    """How B compares with A over pairs (a, b) of one metric (lower is
    better): "faster" when B is lower in at least nine tenths of the pairs
    (ties count for neither) and the medians differ by more than the
    interquartile range of A's own values, "slower" the same the other way
    round, else "unresolved"; and whether every B value is below every A."""
    n = len(pairs)
    a_vals, b_vals = [a for a, _ in pairs], [b for _, b in pairs]
    b_wins, a_wins = sum(b < a for a, b in pairs), sum(a < b for a, b in pairs)
    q = statistics.quantiles(a_vals, n=4)
    iqr = q[2] - q[0]
    diff = statistics.median(b_vals) - statistics.median(a_vals)
    if b_wins >= 0.9 * n and -diff > iqr:
        word = "faster"
    elif a_wins >= 0.9 * n and diff > iqr:
        word = "slower"
    else:
        word = "unresolved"
    return {"A_median": statistics.median(a_vals), "B_median": statistics.median(b_vals),
            "A_iqr": iqr, "pairs_B_lower": b_wins, "pairs_A_lower": a_wins, "pairs": n,
            "every_B_below_every_A": max(b_vals) < min(a_vals), "B_is": word}


class Worker:
    def __init__(self, label: str, tree: Path):
        self.label = label
        self.proc = subprocess.Popen(
            # absolute: the worker changes into its tree before it imports
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(tree.resolve())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def ask(self, cmd: str) -> dict:
        try:
            self.proc.stdin.write(cmd + "\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            pass  # the worker has ended: readline says so
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"compare_trees: worker {self.label} ended "
                               f"(exit code {self.proc.wait()})")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.ask("quit")
            except (RuntimeError, BrokenPipeError, ValueError):
                pass
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, type=Path, required=True, metavar=("A", "B"))
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(json.dumps(rec))

    emit({"card": card, "A": str(args.trees[0]), "B": str(args.trees[1])})
    workers = [Worker("A", args.trees[0]), Worker("B", args.trees[1])]
    try:
        for w in workers:
            if not w.proc.stdout.readline():  # {"ready": true}
                raise RuntimeError(f"compare_trees: worker {w.label} did not start "
                                   f"(exit code {w.proc.wait()})")
        results = {"A": [], "B": []}
        for r in range(args.rounds):
            order = (0, 1, 1, 0) if r % 2 == 0 else (1, 0, 0, 1)
            got = {"A": [], "B": []}
            for i in order:
                got[workers[i].label].append(workers[i].ask("time"))
            for label, recs in got.items():  # the mean of the side's two turns
                rec = {m: sum(x[m] for x in recs) / len(recs) for m in METRICS}
                results[label].append(rec)
                emit({"round": r, "tree": label, **rec})
        for m in METRICS:
            pairs = [(a[m], b[m]) for a, b in zip(results["A"], results["B"])]
            emit({"metric": m, **verdict(pairs), "A": [p[0] for p in pairs],
                  "B": [p[1] for p in pairs]})
        for w in workers:
            emit({"host_profile": w.label, **w.ask("profile")})
    finally:
        for w in workers:
            w.close()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _worker(sys.argv[2])
    else:
        main()
