"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m mmrp_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. The cell's configuration, traffic mix and limits are the files
``BENCHMARK.json`` names; the traffic's ``driver`` builds the program, makes
every input from the seed, warms up (set-up, ``setup_s``), measures for
``--seconds``, then checks what the timed path produced against the plain
float32 reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (the benchmark's spans over the window,
and the profiler over a short stretch after it).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``busy_s`` / ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit; the same numbers are the
last lines of standard error. No result and a non-zero exit when CUDA or the
cell's devices are missing, when a share of a roofline or of the peak reads
above 100%, or when the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from mmrp_bench import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mmrp_tpu")


def cache_env(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list:
    """The JAX modules among ``names`` (default: the process's modules),
    compared by whole top-level names."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_note() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def is_correct(checks) -> bool:
    """Every compared number within its limit."""
    return all(value <= limit for _, value, limit in checks)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = harness.ROOT
    cache_env(root)
    bench = harness.benchmark(root)
    cell = harness.workload(bench, args.workload)

    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"mmrp_bench: the cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    t_cuda = time.perf_counter()
    print(f"mmrp_bench: {cell['name']} seed {args.seed}", file=sys.stderr)

    ctx = harness.Ctx(cell=cell["name"], config=harness.config_file(bench, cell["config"], root),
                      traffic=harness.traffic_file(cell["traffic"]),
                      limits=harness.limits_file(cell["name"]), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), device="cuda",
                      t_start=T_START, log=lambda s: print(s, file=sys.stderr))
    ctx.log(f"set-up: torch imported at {t_torch - T_START:.3f} s, CUDA found at "
            f"{t_cuda - T_START:.3f} s")
    out = harness.driver(ctx.traffic["driver"]).run(ctx)
    note = card_note()  # after the window: nvidia-smi's start-up is no part of set-up
    print(f"mmrp_bench: on {note}", file=sys.stderr)

    bad = forbidden_modules()
    if bad:
        print(f"mmrp_bench: the process holds {bad} after the window", file=sys.stderr)
        return 5
    try:
        result = assemble(bench, cell, args, out, torch, note)
    except ValueError as err:  # a share of a roofline or of the peak above 100%
        print(f"mmrp_bench: {err}", file=sys.stderr)
        return 6
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def assemble(bench, cell, args, out, torch, note) -> dict:
    name = cell["name"]
    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if not applies(m, name):
                continue
            value = out["setup_s"] if m["name"] == "setup_s" else out["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, name):
                continue
            value = harness.metric_reader(m["name"])(out["layer_data"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"], "card": note}
    result = {"correct": is_correct(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device}
    trace = out["layer_data"].get("trace")
    if args.trace and trace:
        device["busy_s"], device["window_s"] = trace["busy_s"], trace["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in trace["top_ops"]],
                               "idle_gaps": [list(x) for x in trace["idle_gaps"]]}
        result["trace_complete"] = trace["complete"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out["checks"]}
    return result


if __name__ == "__main__":
    sys.exit(main())
