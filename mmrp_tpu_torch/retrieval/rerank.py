"""Retrieval reranker: embedding cosine + label Jaccard + KG cosine.

Counterpart of ``mmrp_tpu/retrieval/rerank.py``, line for line (numpy only):
the same ids in the same order with the same floats.

    final = alpha * minmax(emb_cos) + beta * minmax(label_jaccard)
          + gamma * minmax(kg_cos)           (defaults 0.6 / 0.25 / 0.15)

with a constant column scaled to zeros. KG vectors per record follow the
cascade: precomputed record vectors when available, else the record's
report-node embedding, else the pooled label-node embeddings (``label_pooler``
when given, else their mean). Scoring is vectorized over the candidate set.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def minmax_scale(x: np.ndarray) -> np.ndarray:
    """Reference semantics (reranker.py:152-159): zeros when constant."""
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return x
    lo, hi = np.nanmin(x), np.nanmax(x)
    if hi - lo == 0:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def _cos_rows(M: np.ndarray, v: np.ndarray) -> np.ndarray:
    Mn = M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-8)
    vn = v / max(float(np.linalg.norm(v)), 1e-8)
    return Mn @ vn


def label_jaccard(query_labels: np.ndarray, cand_labels: np.ndarray) -> np.ndarray:
    """(C,) x (K, C) binary -> (K,) Jaccard overlap."""
    q = query_labels.astype(bool)
    c = cand_labels.astype(bool)
    inter = (c & q[None, :]).sum(axis=1)
    union = (c | q[None, :]).sum(axis=1)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


class Reranker:
    def __init__(
        self,
        alpha: float = 0.6,
        beta: float = 0.25,
        gamma: float = 0.15,
        labels_by_id: Optional[Dict[str, np.ndarray]] = None,
        kg_vectors_by_id: Optional[Dict[str, np.ndarray]] = None,
        kg_node_embeddings: Optional[np.ndarray] = None,
        kg_node2id: Optional[Dict[str, int]] = None,
        label_names: Optional[Sequence[str]] = None,
        label_pooler: Optional[object] = None,  # LabelAttention apply fn
    ):
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.labels_by_id = labels_by_id or {}
        self.kg_vectors_by_id = kg_vectors_by_id or {}
        self.kg_node_embeddings = kg_node_embeddings
        self.kg_node2id = kg_node2id or {}
        self.label_names = list(label_names or [])
        self.label_pooler = label_pooler

    # -- KG vector cascade (reranker.py:181-238) ------------------------------

    def kg_vector(self, record_id: str) -> Optional[np.ndarray]:
        v = self.kg_vectors_by_id.get(record_id)
        if v is not None:
            return np.asarray(v, np.float32)
        if self.kg_node_embeddings is None:
            return None
        idx = self.kg_node2id.get(f"report:{record_id}")
        if idx is not None:
            return np.asarray(self.kg_node_embeddings[idx], np.float32)
        labels = self.labels_by_id.get(record_id)
        if labels is None or not self.label_names:
            return None
        rows = [
            self.kg_node2id.get(f"label:{name}")
            for name, on in zip(self.label_names, labels)
            if on
        ]
        rows = [r for r in rows if r is not None]
        if not rows:
            return None
        vecs = self.kg_node_embeddings[np.asarray(rows)]
        if self.label_pooler is not None:
            return np.asarray(self.label_pooler(vecs), np.float32)
        return vecs.mean(axis=0).astype(np.float32)

    # -- rerank ----------------------------------------------------------------

    def rerank(
        self,
        query_id: str,
        candidate_ids: List[str],
        candidate_embs: np.ndarray,
        query_emb: np.ndarray,
        topk: Optional[int] = None,
    ) -> List[Tuple[str, float, float, float, float]]:
        """-> [(id, final, emb_n, lab_n, kg_n)] sorted by final desc."""
        K = len(candidate_ids)
        if K == 0:
            return []
        emb_scores = _cos_rows(np.asarray(candidate_embs, np.float32), query_emb)

        q_labels = self.labels_by_id.get(query_id)
        if q_labels is not None:
            cand_labels = np.stack(
                [
                    self.labels_by_id.get(
                        cid, np.zeros_like(np.asarray(q_labels))
                    )
                    for cid in candidate_ids
                ]
            )
            lab_scores = label_jaccard(np.asarray(q_labels), cand_labels)
        else:
            lab_scores = np.zeros(K)

        q_kg = self.kg_vector(query_id)
        if q_kg is not None:
            kg_scores = np.zeros(K)
            cand_kg = [self.kg_vector(cid) for cid in candidate_ids]
            have = [i for i, v in enumerate(cand_kg) if v is not None]
            if have:
                M = np.stack([cand_kg[i] for i in have])
                kg_scores[have] = _cos_rows(M, q_kg)
        else:
            kg_scores = np.zeros(K)

        emb_n = minmax_scale(emb_scores)
        lab_n = minmax_scale(lab_scores)
        kg_n = minmax_scale(kg_scores)
        final = self.alpha * emb_n + self.beta * lab_n + self.gamma * kg_n

        order = np.argsort(-final, kind="stable")
        if topk:
            order = order[:topk]
        return [
            (
                candidate_ids[i],
                float(final[i]),
                float(emb_n[i]),
                float(lab_n[i]),
                float(kg_n[i]),
            )
            for i in order
        ]
