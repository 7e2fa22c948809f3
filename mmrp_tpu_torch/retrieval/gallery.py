"""Exact cosine top-K over an embedding gallery on one device.

Counterpart of the single-device path of ``mmrp_tpu/retrieval/gallery.py``
(the mesh-sharded path is not ported). The gallery is L2-normalized at load,
so cosine is a dot product: one f32 ``queries @ gallery.T`` and a top-K.
``RetrievalEngine`` keeps the JAX engine's contracts: f32 query
normalization with eps 1e-8, ``k = min(k, n_real)``, self-exclusion through
``query_id``, and zero-filled ``get_embeddings_for_ids``. As in JAX, the
search is split in two for a pipelined caller (``serve/stream.py``):
``retrieve_batch_device`` leaves its results on the device, and
``finalize_batch`` brings them to the host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def l2_normalize(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


def topk_single(queries: torch.Tensor, gallery: torch.Tensor, k: int = 10,
                n_real: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) x (N, D) -> (scores (Q, k), indices (Q, k)), f32 scores. Rows at
    and past ``n_real`` (padding of a preallocated gallery) score -inf: their
    dot product of 0 would otherwise beat real rows of negative cosine."""
    scores = queries.float() @ gallery.float().t()
    if n_real is not None and n_real < gallery.shape[0]:
        scores[:, n_real:] = -torch.inf
    return torch.topk(scores, k, dim=1)


class RetrievalEngine:
    """Embedding-gallery engine: an (N, D) matrix + aligned ids, exact
    ``retrieve`` on ``device`` (the card unless the caller names another),
    id lookup and zero-filled ``get_embeddings_for_ids``. The gallery is
    L2-normalized at load."""

    def __init__(self, embeddings: np.ndarray, ids: Sequence[str],
                 device=DEFAULT_DEVICE):
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2:
            raise ValueError("embeddings must be (N, D)")
        if embeddings.shape[0] != len(ids):
            raise ValueError(f"embeddings rows {embeddings.shape[0]} != ids {len(ids)}")
        self.ids = list(ids)
        self.id2idx = {r: i for i, r in enumerate(self.ids)}
        self.embeddings = l2_normalize(embeddings)
        self.device = resolve_device(device, "RetrievalEngine")
        self._device_gallery: Optional[torch.Tensor] = None

    @classmethod
    def from_files(cls, emb_path: str, ids_path: str, device=DEFAULT_DEVICE) -> "RetrievalEngine":
        """A run directory's ``train_embeddings.npy`` (N, D) and ``train_ids.json``."""
        emb = np.load(emb_path)
        ids = json.loads(Path(ids_path).read_text())
        return cls(emb, ids, device=device)

    def get_embeddings_for_ids(self, ids: Sequence[str]) -> np.ndarray:
        """(len(ids), D); zero vector for unknown ids."""
        out = np.zeros((len(ids), self.embeddings.shape[1]), dtype=np.float32)
        for i, rid in enumerate(ids):
            j = self.id2idx.get(rid)
            if j is not None:
                out[i] = self.embeddings[j]
        return out

    def retrieve_batch_device(self, queries_dev: torch.Tensor,
                              k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device (Q, D) -> device (scores (Q, kk), indices (Q, kk)),
        kk = min(k, N); the queries are normalized in f32 on the device. No
        host sync: a pipelined caller enqueues the next batch's search before
        it reads this one's (``finalize_batch``)."""
        if self._device_gallery is None:
            self._device_gallery = torch.from_numpy(self.embeddings).to(self.device)
        q = queries_dev.to(self.device, torch.float32)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
        return topk_single(q, self._device_gallery, min(k, len(self.ids)))

    def finalize_batch(self, s: torch.Tensor, i: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Device top-K results -> numpy. The JAX engine also drops the
        padding rows of its mesh-sharded gallery here; this gallery has none
        (every row is real), so nothing else is left to do."""
        return s.cpu().numpy(), i.cpu().numpy()

    def retrieve_batch(self, queries: np.ndarray, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) -> (scores (Q, kk), indices (Q, kk)), kk = min(k, N)."""
        q = torch.as_tensor(np.asarray(queries, np.float32))
        return self.finalize_batch(*self.retrieve_batch_device(q, k))

    def retrieve(self, query_emb: np.ndarray, K: int = 10,
                 query_id: Optional[str] = None) -> List[Tuple[str, float]]:
        """Single query -> [(id, score)] sorted desc; excludes the query's own
        gallery row when ``query_id`` names one (self-match)."""
        extra = 1 if query_id is not None and query_id in self.id2idx else 0
        s, i = self.retrieve_batch(np.asarray(query_emb)[None, :],
                                   k=min(K + extra, len(self.ids)))
        out = []
        for score, idx in zip(s[0], i[0]):
            rid = self.ids[int(idx)]
            if query_id is not None and rid == query_id:
                continue
            out.append((rid, float(score)))
            if len(out) == K:
                break
        return out
