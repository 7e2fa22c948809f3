"""The benchmark of the PyTorch and CUDA port (``mmrp_tpu_torch``): one cell
of ``BENCHMARK.json`` run once by ``python3 -m mmrp_bench.run``."""
