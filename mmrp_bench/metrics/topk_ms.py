"""Device time of the gallery top-K per batch: the kernels launched inside
the benchmark's span around ``RetrievalEngine.retrieve_batch_device``, ms
per batch of the traced stretch."""


def read(data):
    t = data.get("trace")
    if not t or not t["complete"] or "model.vision" not in t["span_device_s"]:
        return None
    n = data["trace_work"]["batches"]
    return t["span_device_s"].get("retrieval.topk", 0.0) / n * 1e3 if n else None
