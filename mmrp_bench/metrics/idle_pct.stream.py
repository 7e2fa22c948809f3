"""The device's idle share while the stream runs: the traced window (a
steady stretch of batch periods between two loader hand-overs) less the
union of the intervals in which an operation ran on the device, in %."""


def read(data):
    t = data.get("trace")
    if not t or not t["complete"] or "model.vision" not in t["span_device_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
