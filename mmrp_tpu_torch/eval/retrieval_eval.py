"""Retrieval evaluation: dual-gallery protocol + latency + ablations.

Counterpart of ``mmrp_tpu/eval/retrieval_eval.py``, over the port's
``RetrievalEngine`` (exact top-K on its device):

- :func:`evaluate_gallery` / :func:`dual_gallery_eval`: two galleries per
  run, generalization (test -> test) and historical (test -> train), scored
  against label-overlap GT: P@K / mAP / MRR / R@K / nDCG plus the average and
  p50 per-query latency in ms (host clock, one query at a time: the latency a
  request sees);
- :func:`embedding_rank_eval`: one cosine matrix query x gallery and its
  top-K on the device (torch), MRR / Hit@K / Recall@K from the batched
  metrics of ``eval/metrics.py``;
- :func:`variant_eval`: the reranker ablations (baseline / kg_only /
  la_only / kg_la / full) with paired significance tests against the
  baseline (``eval/significance.py``, a copy).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.eval import metrics as M
from mmrp_tpu_torch.utils.logging import TeeLogger


def evaluate_gallery(
    engine,
    query_embs: np.ndarray,
    query_ids: Sequence[str],
    gt: Mapping[str, Sequence[str]],
    k: int = 10,
    reranker=None,
    time_queries: bool = True,
    per_query: bool = False,
) -> Dict[str, float]:
    """One gallery pass -> metric dict (+ avg/p50 latency).

    ``per_query=True`` adds an ``out["per_query"]`` dict of per-query
    metric vectors (AP, RR, P@k, nDCG@k) for paired significance testing
    (eval/significance.py; reference README.md:82,112 advertises this
    but ships no implementation)."""
    retrieved: List[List[str]] = []
    relevant: List[set] = []
    times: List[float] = []
    for i, qid in enumerate(query_ids):
        t0 = time.perf_counter()
        hits = engine.retrieve(query_embs[i], K=k, query_id=qid)
        if reranker is not None and hits:
            cand_ids = [h[0] for h in hits]
            cand_embs = engine.get_embeddings_for_ids(cand_ids)
            ranked = reranker.rerank(qid, cand_ids, cand_embs, query_embs[i], topk=k)
            hits = [(r[0], r[1]) for r in ranked]
        times.append((time.perf_counter() - t0) * 1e3)
        # order-preserving dedupe: a duplicated gallery id must not be
        # double-counted as two hits (AP/P@K would exceed 1)
        retrieved.append(list(dict.fromkeys(h[0] for h in hits)))
        relevant.append(set(gt.get(qid, [])))

    out = {
        f"P@{k}": float(np.mean([M.precision_at_k(r, s, k) for r, s in zip(retrieved, relevant)])),
        f"R@{k}": float(np.mean([M.recall_at_k(r, s, k) for r, s in zip(retrieved, relevant)])),
        "mAP": M.mean_average_precision(retrieved, relevant, k),
        "MRR": M.mean_reciprocal_rank(retrieved, relevant),
        f"nDCG@{k}": float(np.mean([M.ndcg_at_k(r, s, k) for r, s in zip(retrieved, relevant)])),
    }
    if time_queries:
        out["avg_ms"] = float(np.mean(times))
        out["p50_ms"] = float(np.percentile(times, 50))
    if per_query:
        out["per_query"] = {
            "AP": [M.average_precision(r, s, k) for r, s in zip(retrieved, relevant)],
            "RR": [
                M.mean_reciprocal_rank([r], [s]) for r, s in zip(retrieved, relevant)
            ],
            f"P@{k}": [
                M.precision_at_k(r, s, k) for r, s in zip(retrieved, relevant)
            ],
            f"nDCG@{k}": [
                M.ndcg_at_k(r, s, k) for r, s in zip(retrieved, relevant)
            ],
        }
    return out


def dual_gallery_eval(
    test_engine,
    train_engine,
    query_embs: np.ndarray,
    query_ids: Sequence[str],
    gt_test: Mapping[str, Sequence[str]],
    gt_train: Mapping[str, Sequence[str]],
    k: int = 10,
    reranker=None,
    out_dir: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Generalization (test gallery) + historical (train gallery) protocol."""
    res = {
        "generalization": evaluate_gallery(
            test_engine, query_embs, query_ids, gt_test, k, reranker
        ),
        "historical": evaluate_gallery(
            train_engine, query_embs, query_ids, gt_train, k, reranker
        ),
    }
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "retrieval_results.json").write_text(json.dumps(res, indent=1))
        log = TeeLogger(str(out / "retrieval_results.txt"))
        for proto, m in res.items():
            log(f"== {proto} ==")
            for name, v in m.items():
                log(f"  {name}: {v:.4f}")
    return res


def embedding_rank_eval(
    query_embs: np.ndarray,
    query_ids: Sequence[str],
    gallery_embs: np.ndarray,
    gallery_ids: Sequence[str],
    gt: Mapping[str, Sequence[str]],
    ks: Sequence[int] = (1, 5, 10),
    exclude_self: bool = True,
    device=DEFAULT_DEVICE,
) -> Dict[str, float]:
    """Full cosine sim matrix query x gallery -> MRR@K / Hit@K / Recall@K
    by label-overlap GT, as one product and top-K on ``device`` (the card
    unless the caller asks for the CPU) plus a vectorized relevance lookup."""
    from mmrp_tpu_torch.retrieval.gallery import l2_normalize

    device = resolve_device(device, "embedding_rank_eval")
    q = torch.from_numpy(l2_normalize(np.asarray(query_embs, np.float32))).to(device)
    g = torch.from_numpy(l2_normalize(np.asarray(gallery_embs, np.float32))).to(device)
    kmax = max(ks)
    sims = q @ g.T  # (Q, G)
    if exclude_self:
        gid_idx = {r: i for i, r in enumerate(gallery_ids)}
        mask = np.zeros(tuple(sims.shape), np.float32)
        for qi, qid in enumerate(query_ids):
            j = gid_idx.get(qid)
            if j is not None:
                mask[qi, j] = -np.inf
        sims = sims + torch.from_numpy(mask).to(device)
    top_idx = torch.topk(sims, min(kmax, g.shape[0]), dim=1).indices.cpu().numpy()

    garr = np.asarray(gallery_ids)
    rel = np.zeros(top_idx.shape, np.float32)
    n_rel = np.zeros(len(query_ids), np.float32)
    for qi, qid in enumerate(query_ids):
        rset = set(gt.get(qid, []))
        n_rel[qi] = len(rset)
        rel[qi] = [1.0 if garr[j] in rset else 0.0 for j in top_idx[qi]]
    rel_t, n_rel_t = torch.from_numpy(rel), torch.from_numpy(n_rel)
    out: Dict[str, float] = {"MRR": float(M.reciprocal_rank_batch(rel_t).mean())}
    for k in ks:
        out[f"Hit@{k}"] = float((rel[:, :k].sum(axis=1) > 0).astype(np.float32).mean())
        out[f"R@{k}"] = float(M.recall_at_k_batch(rel_t, n_rel_t, k).mean())
    return out


def variant_eval(
    engine,
    query_embs: np.ndarray,
    query_ids: Sequence[str],
    gt: Mapping[str, Sequence[str]],
    reranker_factory,  # (alpha, beta, gamma) -> Reranker
    k: int = 10,
    out_path: Optional[str] = None,
    significance: bool = True,
) -> Dict[str, Dict[str, float]]:
    """Reranker ablations (retrieval_eval_variants.py:31-153).

    ``significance=True`` adds per-variant paired tests vs the no-rerank
    baseline (paired t-test / Wilcoxon / bootstrap CI on per-query AP and
    RR) under ``res[name]["significance_vs_baseline"]`` — the capability
    the reference README.md:82,112 lists but never implemented."""
    variants = {
        "baseline": None,  # no rerank
        "kg_only": reranker_factory(0.0, 0.0, 1.0),
        "la_only": reranker_factory(0.0, 1.0, 0.0),
        "kg_la": reranker_factory(0.0, 0.5, 0.5),
        "full": reranker_factory(0.6, 0.25, 0.15),
    }
    res = {
        name: evaluate_gallery(
            engine, query_embs, query_ids, gt, k, rr, per_query=significance
        )
        for name, rr in variants.items()
    }
    if significance:
        from mmrp_tpu_torch.eval.significance import compare_variants

        tests = compare_variants(
            {name: m.pop("per_query") for name, m in res.items()}
        )
        for name, t in tests.items():
            res[name]["significance_vs_baseline"] = t
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(res, indent=1))
    return res
