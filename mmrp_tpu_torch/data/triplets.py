"""Weakly-supervised triplet/pair generation from label overlap.

Counterpart of ``mmrp_tpu/data/triplets.py``, copied (numpy and the standard
library only; nothing of JAX).

Parity with the reference generators (reference:
src/DataHandler/TripletGenerate.py:53-131):

- ``PseudoTripletDataset``: (query, positive, negative) triples where the
  positive shares label Jaccard >= pos_threshold and the negative has zero
  overlap (:53-78);
- ``LabelEmbeddingLookup``: per-report label-embedding rows with OR
  aggregation of duplicate report rows (:96-131).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class PseudoTripletDataset:
    def __init__(
        self,
        ids: Sequence[str],
        labels: np.ndarray,  # (N, C) binary
        pos_threshold: float = 0.5,
        seed: int = 0,
    ):
        self.ids = list(ids)
        self.labels = np.asarray(labels, bool)
        self.pos_threshold = pos_threshold
        self.rng = np.random.default_rng(seed)
        # Jaccard via one (N, C) @ (C, N) matmul — the broadcast form
        # (labels[:, None] & labels[None]) materializes an (N, N, C) tensor,
        # ~2 GB at OpenI scale (N~7.5k, C=43)
        lf = self.labels.astype(np.float32)
        inter = lf @ lf.T
        counts = lf.sum(axis=1)
        union = counts[:, None] + counts[None, :] - inter
        jac = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
        np.fill_diagonal(jac, -1.0)
        self._pos = [np.where(row >= pos_threshold)[0] for row in jac]
        self._neg = [np.where(row == 0.0)[0] for row in jac]

    def __len__(self) -> int:
        return len(self.ids)

    def sample(self, idx: int) -> Optional[Tuple[str, str, str]]:
        pos, neg = self._pos[idx], self._neg[idx]
        if len(pos) == 0 or len(neg) == 0:
            return None
        p = int(self.rng.choice(pos))
        n = int(self.rng.choice(neg))
        return self.ids[idx], self.ids[p], self.ids[n]

    def __iter__(self) -> Iterator[Tuple[str, str, str]]:
        for i in range(len(self.ids)):
            t = self.sample(i)
            if t is not None:
                yield t


class LabelEmbeddingLookup:
    """report id -> aggregated label-embedding rows (OR over duplicates)."""

    def __init__(
        self,
        label_table: np.ndarray,  # (C, D)
        id_to_labels: Dict[str, np.ndarray],
    ):
        self.table = np.asarray(label_table, np.float32)
        merged: Dict[str, np.ndarray] = {}
        for rid, vec in id_to_labels.items():
            v = np.asarray(vec, bool)
            merged[rid] = merged.get(rid, np.zeros_like(v)) | v
        self.id_to_labels = merged

    def label_indices(self, rid: str) -> List[int]:
        v = self.id_to_labels.get(rid)
        return [] if v is None else list(np.where(v)[0])

    def embeddings(self, rid: str) -> np.ndarray:
        idx = self.label_indices(rid)
        if not idx:
            return np.zeros((0, self.table.shape[1]), np.float32)
        return self.table[np.asarray(idx)]
