"""Host-side input pipeline: threaded prefetch and per-rank batches.

Counterpart of ``mmrp_tpu/data/pipeline.py``: ``PrefetchLoader``, one
producer thread that runs the batch iterator (which decodes its samples on
its own thread pool) ahead of the consumer, with a bounded queue for
back-pressure; ``shard_for_host``, a host's round-robin slice of the
records; and ``device_put_sharded_batch``, this rank's rows of a host batch
on its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch


class PrefetchLoader:
    """Wrap a batch iterable with N worker threads + a bounded queue."""

    def __init__(self, inner, num_workers: int = 4, prefetch: int = 8):
        self.inner = inner
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.inner)

    # Delegate the BatchIterator surface consumers rely on: ``.ds`` (label
    # stats in run_joint_training) and ``._epoch`` (resume reseeds the data
    # order). The _epoch setter must reach the INNER iterator — setting a
    # plain attribute on the wrapper would silently break resume determinism.
    @property
    def ds(self):
        return self.inner.ds

    @property
    def _epoch(self) -> int:
        return self.inner._epoch

    @_epoch.setter
    def _epoch(self, value: int) -> None:
        self.inner._epoch = value

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # A single producer keeps batch order deterministic while the
        # consumer overlaps device work; per-sample decode parallelism
        # lives inside BatchIterator (its own num_workers thread pool).
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        err: List[BaseException] = []

        def produce() -> None:
            try:
                for batch in self.inner:
                    q.put(batch)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]


def shard_for_host(records: Sequence[dict], host_id: int, num_hosts: int) -> List[dict]:
    """Deterministic per-host slice (round-robin) of the record list."""
    return [r for i, r in enumerate(records) if i % num_hosts == host_id]


def device_put_sharded_batch(batch: Dict[str, np.ndarray], mesh, data_axis: str = "dp"):
    """A host batch (the same on every rank) -> this rank's block of rows of
    each array, the batch dimension sharded over ``data_axis``
    (``Shard(0)``), as a tensor on the rank's device. Non-array entries (the
    id list) pass through untouched."""
    from mmrp_tpu_torch.parallel.mesh import mesh_device, rows_of

    dev = mesh_device(mesh)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            out[k] = torch.from_numpy(np.ascontiguousarray(rows_of(v, mesh, data_axis))).to(dev)
        else:
            out[k] = v
    return out
