"""Host time per batch of the stream's own host work: putting a batch on the
device (``StreamingPipeline._put``) and finishing it once its results are
on the host (``_finish`` after its event wait: valid rows, thresholds,
retrieval ids), ms per batch, host clock of the benchmark's spans over the
window."""


def read(data):
    host = data.get("host_spans")
    if not host or not data.get("host_spans_batches"):
        return None
    total = sum(host.get("stream.put", [])) + sum(host.get("stream.finish", []))
    return total / data["host_spans_batches"] * 1e3
