"""Retrieval metrics on id lists (numpy).

The list-based metrics of ``mmrp_tpu/eval/metrics.py`` (``precision_at_k``,
``recall_at_k``, ``average_precision``, ``mean_average_precision``,
``mean_reciprocal_rank``, ``ndcg_at_k``), copied: the reference's formulas,
for drop-in parity on id lists. The batched on-device metrics and the
classification metrics wait for ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Set

import numpy as np


def precision_at_k(retrieved_ids: Sequence, relevant_ids: Iterable, k: int = 5) -> float:
    """Precision@k = |top-k ∩ relevant| / k."""
    rel = set(relevant_ids)
    return sum(1 for r in retrieved_ids[:k] if r in rel) / k


def recall_at_k(retrieved_ids: Sequence, relevant_ids: Iterable, k: int = 5) -> float:
    """Recall@k = |top-k ∩ relevant| / |relevant| (0 when no relevant)."""
    rel = set(relevant_ids)
    if not rel:
        return 0.0
    hits = len(set(retrieved_ids[:k]) & rel)
    return hits / len(rel)


def average_precision(
    retrieved: Sequence, relevant: Set, k: Optional[int] = None
) -> float:
    """AP = Σ_i Precision@i · rel(i) / |relevant|."""
    if k is None:
        k = len(retrieved)
    hits, score = 0, 0.0
    for i, r in enumerate(retrieved[:k], start=1):
        if r in relevant:
            hits += 1
            score += hits / i
    return score / len(relevant) if relevant else 0.0


def mean_average_precision(
    all_retrieved: Sequence[Sequence],
    all_relevant: Sequence[Set],
    k: Optional[int] = None,
) -> float:
    aps = [average_precision(r, rel, k) for r, rel in zip(all_retrieved, all_relevant)]
    return float(np.mean(aps)) if aps else 0.0


def mean_reciprocal_rank(
    all_retrieved: Sequence[Sequence], all_relevant: Sequence[Set]
) -> float:
    """MRR = mean(1/rank of first relevant; 0 if none retrieved)."""
    rrs = []
    for retrieved, relevant in zip(all_retrieved, all_relevant):
        rr = 0.0
        for i, r in enumerate(retrieved, start=1):
            if r in relevant:
                rr = 1.0 / i
                break
        rrs.append(rr)
    return float(np.mean(rrs)) if rrs else 0.0


def ndcg_at_k(retrieved: Sequence, relevant: Iterable, k: int = 5) -> float:
    """Binary-gain nDCG@k with log2(rank+1) discount."""
    rel = set(relevant)
    gains = [1.0 if r in rel else 0.0 for r in retrieved[:k]]
    discounts = 1.0 / np.log2(np.arange(2, len(gains) + 2))
    dcg = float(np.sum(np.asarray(gains) * discounts))
    ideal = sorted(gains, reverse=True)
    idcg = float(np.sum(np.asarray(ideal) * discounts))
    return dcg / idcg if idcg > 0 else 0.0
