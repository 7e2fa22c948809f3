"""The readings that the limits of ``limits/<workload>.json`` are set from,
on the chip, many seeds in one process.

    python3 -m mmrp_bench.control --workload <name> --mode <mode> --seeds <n> [<n> ...]
                                  [--seconds S] [--out FILE]

Modes:

- ``program``: the cell as the benchmark runs it (a short window at the
  cell's own load, then the check): the lower readings;
- ``control``: the nearest precision below the configuration's bfloat16.
  For a serving cell the program's own int8 path (``Config.serve_quant =
  "int8"``: W8A8 GEMMs in the text tower and the fusion stack) in the
  program's place; for a training cell, which has no such path, the
  reference with every GEMM in int8 (``reference/quant.py``) in the
  program's place, against the float32 reference;
- ``half`` (training): the reference on the first half of each batch, the
  mean taken over it, in the program's place: a planted fault.

One JSON line per seed: the mode, the seed and every compared number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from mmrp_bench import harness
from mmrp_bench.run import cache_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control", "half"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache_env(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("mmrp_bench.control: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    traffic = harness.traffic_file(cell["traffic"])
    drv = harness.driver(traffic["driver"])
    for seed in args.seeds:
        ctx = harness.Ctx(cell=cell["name"], config=harness.config_file(bench, cell["config"]),
                          traffic=traffic, limits=harness.limits_file(cell["name"]), seed=seed,
                          seconds=args.seconds, trace=False,
                          variant="control" if args.mode == "control" else None,
                          log=lambda s: print(s, file=sys.stderr))
        t0 = time.perf_counter()
        if args.mode == "program" or traffic["driver"] == "stream":
            checks = drv.run(ctx)["checks"]
        else:
            checks = drv.readings(ctx, args.mode)
        line = json.dumps({"workload": cell["name"], "mode": args.mode, "seed": seed,
                           "seconds": time.perf_counter() - t0,
                           "readings": {n: v for n, v, _ in checks}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
