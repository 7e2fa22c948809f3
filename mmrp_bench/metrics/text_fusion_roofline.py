"""The text tower and the fusion layers (K3, K2 and the GEMMs around them
today) against their roofline: the least time their useful work of the
traced batches could take (``work.roofline_ms`` of its FLOPs and bytes) over
the device time of every kernel launched inside the benchmark's spans
around ``backbones.text`` and each fusion layer, in %. Nothing from a trace
that lost events."""

from mmrp_bench.work import roofline_ms, share_pct


def read(data):
    t = data.get("trace")
    if not t or not t["complete"]:
        return None
    dev = t["span_device_s"].get("model.text", 0.0) + t["span_device_s"].get("model.fusion", 0.0)
    if dev <= 0:
        return None
    flops, nbytes = data["trace_work"]["text_fusion"]
    return share_pct("text_fusion_roofline", roofline_ms(flops, nbytes) / 1e3 / dev * 100.0)
