"""Retrieval + classification metrics.

Counterpart of ``mmrp_tpu/eval/metrics.py``:

- the list-based retrieval metrics (``precision_at_k``, ``recall_at_k``,
  ``average_precision``, ``mean_average_precision``, ``mean_reciprocal_rank``,
  ``ndcg_at_k``), copied: the reference's formulas on id lists;
- the batched ones over a binary relevance matrix ``rel`` (Q, K) as torch
  functions on the tensor's device (the JAX package's jnp versions), each
  returning a per-query vector;
- the classification metrics (safe AUROC / average precision, NaN on a
  single-class column; the sklearn-semantics PR curve, per-class report,
  the early-stopping composite and the F1-optimal thresholds), copied: numpy.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Set

import numpy as np
import torch


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


# --------------------------------------------------------------------------
# Batched retrieval metrics over a relevance matrix (torch, on its device)
# --------------------------------------------------------------------------
#
# rel: (Q, K) float/bool — rel[q, i] == 1 iff the i-th retrieved item for
# query q is relevant. n_relevant: (Q,) total relevant per query (for recall /
# AP denominators). All functions return per-query vectors; take .mean() for
# the aggregate.


def precision_at_k_batch(rel: torch.Tensor, k: int) -> torch.Tensor:
    return rel[:, :k].float().sum(1) / k


def recall_at_k_batch(rel: torch.Tensor, n_relevant: torch.Tensor, k: int) -> torch.Tensor:
    hits = rel[:, :k].float().sum(1)
    n = n_relevant.float()
    return torch.where(n > 0, hits / torch.clamp(n, min=1), torch.zeros_like(hits))


def average_precision_batch(rel: torch.Tensor, n_relevant: torch.Tensor) -> torch.Tensor:
    rel = rel.float()
    cum_hits = torch.cumsum(rel, dim=1)
    ranks = torch.arange(1, rel.shape[1] + 1, dtype=torch.float32, device=rel.device)
    ap_num = (cum_hits / ranks * rel).sum(1)
    n = n_relevant.float()
    return torch.where(n > 0, ap_num / torch.clamp(n, min=1), torch.zeros_like(ap_num))


def reciprocal_rank_batch(rel: torch.Tensor) -> torch.Tensor:
    rel = rel.float()
    ranks = torch.arange(1, rel.shape[1] + 1, dtype=torch.float32, device=rel.device)
    # first relevant rank: min rank where rel==1, else +inf
    first = torch.where(rel > 0, ranks, torch.full_like(rel, float("inf"))).amin(1)
    return torch.where(torch.isfinite(first), 1.0 / first, torch.zeros_like(first))


def ndcg_at_k_batch(rel: torch.Tensor, k: int) -> torch.Tensor:
    gains = rel[:, :k].float()
    discounts = 1.0 / torch.log2(torch.arange(2, gains.shape[1] + 2, dtype=torch.float32,
                                              device=rel.device))
    dcg = (gains * discounts).sum(1)
    ideal = torch.sort(gains, dim=1, descending=True).values
    idcg = (ideal * discounts).sum(1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-12), torch.zeros_like(dcg))


# --------------------------------------------------------------------------
# Classification metrics
# --------------------------------------------------------------------------


def safe_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUROC; NaN when the column has a single class (reference helper.py:634)."""
    y_true = np.asarray(y_true)
    if len(np.unique(y_true)) < 2:
        return float("nan")
    return float(_roc_auc(y_true, np.asarray(y_score)))


def _roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Rank-based AUROC (Mann-Whitney U), ties handled by average rank."""
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    n = len(y_score)
    i = 0
    rank_vals = np.arange(1, n + 1, dtype=np.float64)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        rank_vals[i : j + 1] = (i + j + 2) / 2.0
        i = j + 1
    ranks[order] = rank_vals
    pos = y_true > 0
    n_pos = int(pos.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)


def safe_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP; NaN when the column has a single class (reference helper.py:656).

    Tie handling matches sklearn's ``average_precision_score`` (which the
    reference calls): items sharing a score collapse into ONE operating
    point — AP = Σ_g (R_g − R_{g−1}) · P_g over distinct-score groups g in
    descending-score order. For all-distinct scores this equals the
    per-item Σ P_i·rel_i / n_pos formula; with ties it differs, and the
    grouped form is the protocol the reference reports.
    """
    y_true = np.asarray(y_true).astype(np.float64)
    if len(np.unique(y_true)) < 2:
        return float("nan")
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    yt, ys = y_true[order], y_score[order]
    distinct = np.where(np.diff(ys))[0]
    idxs = np.r_[distinct, ys.size - 1]
    tps = np.cumsum(yt)[idxs]
    precision = tps / (idxs + 1.0)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def pr_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Precision-recall curve with sklearn semantics (the reference's
    thresholding oracle, eval_on_test.py:29-38 / train.py:161-167):
    distinct-score operating points, outputs reversed to ascending
    thresholds with a terminal (precision=1, recall=0) point. Returns
    (precision, recall, thresholds) with
    len(thresholds) == len(precision) - 1."""
    y_true = np.asarray(y_true).astype(np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    yt, ys = y_true[order], y_score[order]
    distinct = np.where(np.diff(ys))[0]
    idxs = np.r_[distinct, ys.size - 1]
    tps = np.cumsum(yt)[idxs]
    ps = idxs + 1.0
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    thresholds = ys[idxs]
    precision = precision[::-1]
    recall = recall[::-1]
    thresholds = thresholds[::-1]
    return (np.hstack((precision, 1.0)), np.hstack((recall, 0.0)), thresholds)


def prf1(y_true: np.ndarray, y_pred: np.ndarray) -> tuple:
    """Binary precision/recall/F1 with 0.0 on empty denominators."""
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    tp = int(np.sum(y_true & y_pred))
    fp = int(np.sum(~y_true & y_pred))
    fn = int(np.sum(y_true & ~y_pred))
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def per_class_report(
    y_true: np.ndarray,
    y_prob: np.ndarray,
    thresholds: np.ndarray,
    class_names: Sequence[str],
) -> dict:
    """Per-class AUROC/AP/P/R/F1 + macro/micro aggregates.

    Mirrors the reference evaluation layout (src/Evaluate/eval_on_test.py:140-172).
    """
    n_classes = y_true.shape[1]
    rows = []
    for c in range(n_classes):
        yt, yp = y_true[:, c], y_prob[:, c]
        # STRICT > : the reference binarizes with y_prob > t everywhere
        # (train.py:622, eval_on_test.py:137) even though its PR-curve
        # thresholds are computed with >= semantics — the boundary item is
        # dropped. Kept for bit-parity (thresholds are data values, so the
        # boundary case is common, not a measure-zero event).
        pred = (yp > thresholds[c]).astype(int)
        p, r, f1 = prf1(yt, pred)
        tp = int(((yt == 1) & (pred == 1)).sum())
        fp = int(((yt == 0) & (pred == 1)).sum())
        fn = int(((yt == 1) & (pred == 0)).sum())
        rows.append(
            {
                "class": class_names[c],
                "auroc": safe_roc_auc(yt, yp),
                "ap": safe_average_precision(yt, yp),
                "precision": p,
                "recall": r,
                "f1": f1,
                "threshold": float(thresholds[c]),
                "support": int(yt.sum()),
                # confusion at this threshold (reference README's
                # advertised confusion report; one thresholding pass)
                "tp": tp,
                "fp": fp,
                "fn": fn,
                "tn": int(len(yt) - tp - fp - fn),
            }
        )
    aurocs = np.array([r["auroc"] for r in rows], dtype=np.float64)
    aps = np.array([r["ap"] for r in rows], dtype=np.float64)
    f1s = np.array([r["f1"] for r in rows], dtype=np.float64)
    preds = (y_prob > thresholds[None, :]).astype(int)
    micro_p, micro_r, micro_f1 = prf1(y_true.ravel(), preds.ravel())
    return {
        "per_class": rows,
        "macro_auroc": float(np.nanmean(aurocs)),
        "macro_ap": float(np.nanmean(aps)),
        "macro_f1": float(np.nanmean(f1s)),
        "macro_precision": float(np.mean([r["precision"] for r in rows])),
        "macro_recall": float(np.mean([r["recall"] for r in rows])),
        "micro_precision": micro_p,
        "micro_recall": micro_r,
        "micro_f1": micro_f1,
        # reference eval_on_test.py:152-154: micro AP = sklearn AP over the
        # flattened matrix, NaN on degenerate input
        "micro_ap": safe_average_precision(y_true.ravel(), y_prob.ravel()),
    }


def composite_score(report: dict) -> float:
    """THE early-stopping composite, 0.5*macro_f1 + 0.5*macro_auroc
    (AUROC treated as 0 when undefined — reference train.py:725-739).
    Single definition shared by the joint trainer (train/pipeline.py),
    the Swin finetune loop, and the ASL auto-search so the stages can
    never silently optimize different objectives."""
    auroc = report["macro_auroc"]
    return 0.5 * report["macro_f1"] + 0.5 * (
        auroc if np.isfinite(auroc) else 0.0
    )


def find_best_thresholds(
    y_true: np.ndarray, y_prob: np.ndarray, grid: Optional[np.ndarray] = None
) -> np.ndarray:
    """Per-class F1-optimal threshold, reference protocol by default.

    Default (grid=None) reproduces the reference exactly (train.py:161-167
    and eval_on_test.py:29-38): PR-curve operating points per class,
    pick t[argmax 2pr/(p+r+1e-8)]; 0.5 when the curve has no thresholds
    (constant scores). Pass an explicit ``grid`` for the vectorized
    fixed-grid variant (faster, threshold values independent of the data).
    """
    if grid is None:
        best = []
        for c in range(y_true.shape[1]):
            p, r, t = pr_curve(y_true[:, c], y_prob[:, c])
            if len(t) == 0:
                best.append(0.5)
                continue
            f1 = 2 * p * r / (p + r + 1e-8)
            best.append(float(t[int(np.argmax(f1))]))
        return np.array(best)
    yt = y_true[None, :, :].astype(bool)  # (1, N, C)
    pred = y_prob[None, :, :] >= grid[:, None, None]  # (T, N, C)
    tp = np.sum(yt & pred, axis=1).astype(np.float64)  # (T, C)
    fp = np.sum(~yt & pred, axis=1).astype(np.float64)
    fn = np.sum(yt & ~pred, axis=1).astype(np.float64)
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1e-12)
    best = np.argmax(f1, axis=0)  # (C,)
    return grid[best]
