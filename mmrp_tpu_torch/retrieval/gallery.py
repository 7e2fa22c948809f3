"""Exact cosine top-K over an embedding gallery, on one device or sharded
by rows over a mesh axis.

Counterpart of ``mmrp_tpu/retrieval/gallery.py``. The gallery is
L2-normalized at load, so cosine is a dot product: one f32 ``queries @
gallery.T`` and a top-K. With a ``mesh`` (``parallel/mesh.py``) every rank
holds its block of rows (the gallery padded with zero rows to a multiple of
the shard count; padding rows score -inf on the device), takes its local
top-K, all-gathers the candidates and takes the global top-K of them
(``make_sharded_topk``): O(ranks * k) scores cross the ranks, not O(N).
Every top-K breaks ties as ``lax.top_k`` does, the lower index first
(``topk_ordered``), so a gallery with duplicated rows gives JAX's ids in
JAX's order on either path.
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def l2_normalize(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, eps)


def topk_ordered(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` along the last dimension in ``lax.top_k``'s order: the
    higher score first and, among equal scores, the lower index
    (``torch.topk`` promises no order among ties). One stable descending
    sort, no host sync."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def topk_single(queries: torch.Tensor, gallery: torch.Tensor, k: int = 10,
                n_real: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, D) x (N, D) -> (scores (Q, k), indices (Q, k)), f32 scores. Rows at
    and past ``n_real`` (padding of a preallocated gallery) score -inf: their
    dot product of 0 would otherwise beat real rows of negative cosine."""
    scores = queries.float() @ gallery.float().t()
    if n_real is not None and n_real < gallery.shape[0]:
        scores[:, n_real:] = -torch.inf
    return topk_ordered(scores, k)


def make_sharded_topk(mesh, axis: str, k: int, n_real: Optional[int] = None):
    """fn(queries (Q, D), the same on every rank; this rank's block of
    gallery rows) -> (scores (Q, k), global indices (Q, k)), the same on
    every rank. ``n_real`` is the unpadded row count: padding rows score
    -inf on the device (their dot product of 0 would beat real rows of
    negative cosine). A block can hold fewer than k rows: each rank takes
    ``min(k, rows)``, and the union still covers k real rows. The ranks'
    candidates cross as one all-gather (scores and global indices in f64,
    both exact), in rank order, so that the global top-K keeps the lower
    index first among ties."""
    from mmrp_tpu_torch.parallel.collectives import all_gather_cat
    from mmrp_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    n_shards = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    shard_id = axis_index(mesh, axis)

    def local_topk(q: torch.Tensor, g_shard: torch.Tensor):
        scores = q.float() @ g_shard.float().t()
        rows = g_shard.shape[0]
        if n_real is not None and (shard_id + 1) * rows > n_real:
            scores[:, max(0, n_real - shard_id * rows):] = -torch.inf
        s, i = topk_ordered(scores, min(k, rows))
        every = all_gather_cat(torch.stack([s.double(), (i + shard_id * rows).double()]), group,
                               dim=2)  # (2, Q, shards * k_loc)
        top_s, pos = topk_ordered(every[0].float(), min(k, every.shape[2]))
        return top_s, torch.gather(every[1], 1, pos).long()

    return local_topk


class RetrievalEngine:
    """Embedding-gallery engine: an (N, D) matrix + aligned ids, exact
    ``retrieve`` on ``device`` (the card unless the caller names another),
    id lookup and zero-filled ``get_embeddings_for_ids``. The gallery is
    L2-normalized at load. With ``mesh``
    the rows are sharded over ``shard_axis`` on each rank's device (the
    mesh's; ``device`` is not used) and every rank calls each search."""

    def __init__(self, embeddings: np.ndarray, ids: Sequence[str],
                 device=DEFAULT_DEVICE, mesh=None, shard_axis: str = "dp"):
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2:
            raise ValueError("embeddings must be (N, D)")
        if embeddings.shape[0] != len(ids):
            raise ValueError(f"embeddings rows {embeddings.shape[0]} != ids {len(ids)}")
        self.ids = list(ids)
        self.id2idx = {r: i for i, r in enumerate(self.ids)}
        self.embeddings = l2_normalize(embeddings)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self._n_real = embeddings.shape[0]
        if mesh is not None:
            from mmrp_tpu_torch.parallel.mesh import mesh_device

            self.device = mesh_device(mesh)
        else:
            self.device = resolve_device(device, "RetrievalEngine")
        self._device_gallery: Optional[torch.Tensor] = None
        self._sharded_topk_cache: Dict[int, Callable] = {}

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
        g = self._gallery_on_device()
        q = queries_dev.to(self.device, torch.float32)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
        kk = min(k, self._n_real)
        if self.mesh is not None:
            if kk not in self._sharded_topk_cache:
                self._sharded_topk_cache[kk] = make_sharded_topk(
                    self.mesh, self.shard_axis, kk, n_real=self._n_real)
            return self._sharded_topk_cache[kk](q, g)
        return topk_single(q, g, kk)

    def _gallery_on_device(self) -> torch.Tensor:
        """The gallery on the device, or with a mesh this rank's block of it
        (padded with zero rows to a multiple of the shard count)."""
        if self._device_gallery is None:
            g = self.embeddings
            if self.mesh is not None:
                from mmrp_tpu_torch.parallel.mesh import axis_size, rows_of

                pad = (-g.shape[0]) % axis_size(self.mesh, self.shard_axis)
                if pad:
                    g = np.concatenate([g, np.zeros((pad, g.shape[1]), g.dtype)])
                g = np.ascontiguousarray(rows_of(g, self.mesh, self.shard_axis))
            self._device_gallery = torch.from_numpy(g).to(self.device)
        return self._device_gallery

    def finalize_batch(self, s: torch.Tensor, i: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Device top-K results -> numpy, padding rows of a sharded gallery
        dropped: they score -inf on the device and appear only when the
        gallery holds fewer real rows than the search asks for."""
        kk = min(s.shape[1], self._n_real)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        invalid = i >= self._n_real
        if invalid.any():
            s = np.where(invalid, -np.inf, s)
            order = np.argsort(-s, axis=1, kind="stable")
            s = np.take_along_axis(s, order, axis=1)
            i = np.take_along_axis(i, order, axis=1)
        return s[:, :kk], i[:, :kk]

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
