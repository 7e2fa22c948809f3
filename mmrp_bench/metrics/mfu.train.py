"""The train step's share of the chip's bf16 peak: three times the useful
forward FLOPs (forward, and the backward's two products per GEMM) of every
pair of the steps completed in the window, over the window's seconds,
against 989 TFLOP/s."""

from mmrp_bench.work import PEAK_FLOPS, share_pct


def read(data):
    w = data.get("window")
    if not w or not w.get("steps"):
        return None
    return share_pct("mfu.train", w["useful_flops"] / w["seconds"] / PEAK_FLOPS * 100.0)
