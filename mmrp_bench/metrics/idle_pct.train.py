"""The device's idle share while the train step runs: the traced window
(whole step periods) less the union of the intervals in which an operation
ran on the device, in %."""


def read(data):
    t = data.get("trace")
    if not t or not t["complete"] or "steps" not in t:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
