"""The serving step's share of the chip's bf16 peak: the useful model FLOPs
of every pair completed in the window (``work.pair_work``: text-side work at
each pair's valid length) over the window's seconds, against 989 TFLOP/s."""

from mmrp_bench.work import PEAK_FLOPS, share_pct


def read(data):
    w = data.get("window")
    if not w or not w.get("pairs"):
        return None
    return share_pct("mfu.embed", w["useful_flops"] / w["seconds"] / PEAK_FLOPS * 100.0)
