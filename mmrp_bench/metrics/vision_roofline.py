"""The vision tower (Swin or MedCLIP's Swin-T and projection: K1, K2, the
pair, the chain and the windows kernels today) against its roofline, as
``text_fusion_roofline`` reads it, over the spans around the vision tower."""

from mmrp_bench.work import roofline_ms, share_pct


def read(data):
    t = data.get("trace")
    if not t or not t["complete"]:
        return None
    dev = t["span_device_s"].get("model.vision", 0.0)
    if dev <= 0:
        return None
    flops, nbytes = data["trace_work"]["vision"]
    return share_pct("vision_roofline", roofline_ms(flops, nbytes) / 1e3 / dev * 100.0)
