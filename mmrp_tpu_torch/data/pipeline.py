"""Host-side input pipeline: threaded prefetch.

Counterpart of ``PrefetchLoader`` in ``mmrp_tpu/data/pipeline.py``: one
producer thread runs the batch iterator (which decodes its samples on its own
thread pool) ahead of the consumer, and a bounded queue applies
back-pressure. The JAX module's per-host sharding (``shard_for_host``,
``device_put_sharded_batch``) belongs to the multi-card path, which is not
ported (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


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
