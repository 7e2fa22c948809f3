"""DenseLinkSearch (DLS) parity engine.

Counterpart of ``mmrp_tpu/retrieval/dls.py``: a faithful re-implementation
of the reference's approximate retrieval walk (reference:
src/Retrieval/retrieval.py:53-271) kept for metric-equivalence checks
against the reference stack. The **product path** is the exact engine in
``retrieval/gallery.py``.

Semantics preserved:
- offline link graph: per-node top ``max_links`` cosine neighbors with
  similarity >= ``link_threshold`` (retrieval.py:121-138), built on the
  device (the card unless the caller names another) as JAX builds it: a
  blocked f32 ``q @ G^T`` and a top-k per block (``torch.topk``, a library
  call, as JAX's is ``lax.top_k`` outside any Pallas kernel); the self
  column and the links below the threshold are dropped on the device;
- cached to disk, rebuilt on shape mismatch (retrieval.py:85-119) — npz
  with atomic replace instead of pickle;
- query walk on the host: RNG seeded from the query id hash, ``seed_size``
  random entry nodes, greedy best-first expansion bounded by ``max_steps``
  and a result heap of R = heap_mult * K (retrieval.py:188-237), final top-K
  by cosine.
"""

from __future__ import annotations

import hashlib
import heapq
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine, l2_normalize


def link_block(g: torch.Tensor, start: int, rows: int, max_links: int,
               threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The links of gallery rows [start, start + rows) of the normalized
    ``g`` (N, D), on its device: (neighbors (rows, max_links) int32, sims
    float32), -1 / 0.0 where missing. JAX walks each row's top-k in order,
    skips the row itself, stops at the first similarity below the threshold
    (the rest are lower) and at ``max_links``; the same as keeping, in
    order, the first ``max_links`` columns that are not the row and reach
    the threshold."""
    k = min(max_links + 1, g.shape[0])  # +1: the self column is dropped
    s, i = torch.topk(g[start:start + rows] @ g.t(), k, dim=1)
    own = torch.arange(start, start + rows, device=g.device)[:, None]
    keep = (i != own) & (s >= threshold)
    slot = torch.cumsum(keep, dim=1) - 1
    keep &= slot < max_links
    r, c = keep.nonzero(as_tuple=True)
    nbrs = torch.full((rows, max_links), -1, dtype=torch.int32, device=g.device)
    sims = torch.zeros((rows, max_links), dtype=torch.float32, device=g.device)
    nbrs[r, slot[r, c]] = i[r, c].int()
    sims[r, slot[r, c]] = s[r, c]
    return nbrs, sims


def build_link_graph(
    embeddings: np.ndarray,
    max_links: int = 10,
    threshold: float = 0.3,
    block: int = 1024,
    device=DEFAULT_DEVICE,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (neighbors (N, max_links) int32, sims (N, max_links) float32).

    Missing links (below threshold) are -1 / 0.0. The blocked product keeps
    peak device memory at O(block * N)."""
    dev = resolve_device(device, "build_link_graph")
    g = torch.from_numpy(l2_normalize(np.asarray(embeddings, np.float32))).to(dev)
    N = g.shape[0]
    parts = [link_block(g, start, min(block, N - start), max_links, threshold)
             for start in range(0, N, block)]
    nbrs = torch.cat([p[0] for p in parts]) if parts else torch.empty((0, max_links))
    sims = torch.cat([p[1] for p in parts]) if parts else torch.empty((0, max_links))
    return (nbrs.cpu().numpy().astype(np.int32, copy=False),
            sims.cpu().numpy().astype(np.float32, copy=False))


class DLSRetrievalEngine:
    def __init__(
        self,
        embeddings: np.ndarray,
        ids: Sequence[str],
        max_links: int = 10,
        link_threshold: float = 0.3,
        seed_size: int = 5,
        max_steps: int = 100,
        heap_mult: int = 10,
        cache_path: Optional[str] = None,
        device=DEFAULT_DEVICE,
    ):
        self.embeddings = l2_normalize(np.asarray(embeddings, np.float32))
        self.ids = list(ids)
        if self.embeddings.shape[0] != len(self.ids):
            raise ValueError("embeddings/ids length mismatch")
        self.id2idx = {r: i for i, r in enumerate(self.ids)}
        self.max_links = max_links
        self.link_threshold = link_threshold
        self.seed_size = seed_size
        self.max_steps = max_steps
        self.heap_mult = heap_mult
        self.device = device
        self.neighbors, self.link_sims = self._load_or_build(cache_path)

    def _load_or_build(self, cache_path):
        N = self.embeddings.shape[0]
        if cache_path and Path(cache_path).exists():
            try:
                z = np.load(cache_path)
                nbrs, sims = z["neighbors"], z["sims"]
                if nbrs.shape == (N, self.max_links):
                    return nbrs, sims
            except (OSError, KeyError, ValueError):
                pass  # corrupt cache -> rebuild (retrieval.py:85-119)
        nbrs, sims = build_link_graph(
            self.embeddings, self.max_links, self.link_threshold, device=self.device
        )
        if cache_path:
            tmp = str(cache_path) + ".tmp.npz"
            np.savez_compressed(tmp, neighbors=nbrs, sims=sims)
            os.replace(tmp, cache_path)
        return nbrs, sims

    # the reranker's candidate rows, as the exact engine gives them
    get_embeddings_for_ids = RetrievalEngine.get_embeddings_for_ids

    # -- query ---------------------------------------------------------------

    def _seed_rng(self, query_id: Optional[str]) -> np.random.Generator:
        if query_id is None:
            return np.random.default_rng(0)
        h = int(hashlib.sha256(str(query_id).encode()).hexdigest()[:8], 16)
        return np.random.default_rng(h)

    def retrieve(
        self, query_emb: np.ndarray, K: int = 10, query_id: Optional[str] = None
    ) -> List[Tuple[str, float]]:
        q = np.asarray(query_emb, np.float32)
        q = q / max(float(np.linalg.norm(q)), 1e-8)
        N = self.embeddings.shape[0]
        rng = self._seed_rng(query_id)
        seeds = rng.choice(N, size=min(self.seed_size, N), replace=False)

        R = self.heap_mult * K
        visited = set()
        frontier: List[Tuple[float, int]] = []  # min-heap of (-sim, idx)
        results: List[Tuple[float, int]] = []  # min-heap of (sim, idx), size<=R

        def visit(idx: int):
            if idx in visited:
                return
            visited.add(idx)
            sim = float(self.embeddings[idx] @ q)
            heapq.heappush(frontier, (-sim, idx))
            heapq.heappush(results, (sim, idx))
            if len(results) > R:
                heapq.heappop(results)

        for s in seeds:
            visit(int(s))
        for _ in range(self.max_steps):
            if not frontier:
                break
            _, best = heapq.heappop(frontier)
            for nb in self.neighbors[best]:
                if nb < 0:
                    break
                visit(int(nb))

        ranked = sorted(results, key=lambda t: -t[0])
        out = []
        for sim, idx in ranked:
            rid = self.ids[idx]
            if query_id is not None and rid == query_id:
                continue
            out.append((rid, sim))
            if len(out) == K:
                break
        return out


def make_retrieval_engine(
    backend: str,
    embeddings: np.ndarray,
    ids: Sequence[str],
    **kw,
):
    """Factory mirroring reference make_retrieval_engine (retrieval.py:273-304);
    ``device`` goes to either engine. The JAX exact engine's mesh options are
    not ported (ROADMAP.md Queue 1 item 10c) and, as JAX does with keys it
    does not know, are dropped."""
    if backend == "dls":
        allowed = {
            "max_links", "link_threshold", "seed_size", "max_steps",
            "heap_mult", "cache_path", "device",
        }
        return DLSRetrievalEngine(
            embeddings, ids, **{k: v for k, v in kw.items() if k in allowed}
        )
    if backend == "exact":
        return RetrievalEngine(embeddings, ids, device=kw.get("device", DEFAULT_DEVICE))
    raise ValueError(f"unknown retrieval backend {backend!r}")
