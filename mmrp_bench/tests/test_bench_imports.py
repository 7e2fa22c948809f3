"""Nothing the harness imports or runs is JAX or the JAX package, compared by
whole top-level module names (``mmrp_tpu_torch`` starts with ``mmrp_tpu``
and is not it)."""

import subprocess
import sys

from mmrp_bench import run

CHILD = r"""
import sys
from mmrp_bench import control, gen, harness, run, trace, work
from mmrp_bench.reference import model, quant, train
from mmrp_bench.tests import micro
for name in ("stream", "train"):
    harness.driver(name)
for m in harness.benchmark()["per_layer"]:
    harness.metric_reader(m["name"])
harness.driver("stream").run(micro.ctx(micro.MICRO, micro.stream_traffic(), "flagship.stream-openi", seconds=0.2))
harness.driver("train").run(micro.ctx(micro.MICRO, micro.train_traffic(), "flagship.train-openi", seconds=0.2))
print(sorted({m.split(".")[0] for m in sys.modules}))
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_jax_module():
    env = {k: v for k, v in __import__("os").environ.items()}
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True, text=True,
                         cwd=str(run.harness.ROOT), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.strip().splitlines()[-2])
    assert "mmrp_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "mmrp_tpu"} & set(tops)
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["mmrp_tpu_torch", "mmrp_tpu_torch.models", "jaxtyping",
                                  "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["mmrp_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "mmrp_tpu"]


def test_the_harness_reads_no_jax_benchmark_file():
    root = run.harness.ROOT / "mmrp_bench"
    text = "".join(p.read_text() for p in root.rglob("*.py") if "tests" not in p.parts)
    for name in ("BASELINE.json", "BENCH_", "bench.py", "tools/", "import jax", "mmrp_tpu."):
        assert name not in text, name
