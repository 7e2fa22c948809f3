"""Device time per train step of the kernels that are not the port's own
(outside the ``mmrp::`` namespace: library GEMMs, copies, casts and
elementwise work; collectives left out), ms per step over the traced
steps."""


def read(data):
    t = data.get("trace")
    if not t or not t["complete"] or "steps" not in t:
        return None
    return t["nonport_device_s"] / t["steps"] * 1e3
