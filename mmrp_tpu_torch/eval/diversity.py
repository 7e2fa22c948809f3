"""Retrieval diversity analysis.

A copy of ``mmrp_tpu/eval/diversity.py`` over the port's predictor and
engine. Parity with the reference diversity computer (reference:
src/Evaluate/retrieval_diversity_compute.py:169-193): per-query embedding
diversity = 1 - mean pairwise cosine of the retrieved set, plus label
diversity = mean pairwise label distance; aggregated per gallery and
flattened to CSV summaries. ``full_diversity_report`` additionally runs the
explainability engine for the query and every retrieved item, saves
overlay PNGs per (query, result, map type), and records cross-map
comparison metrics — the reference's diversity_retrieval_report script
(src/Evaluate/diversity_retrieval_report.py).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def embedding_diversity(embs: np.ndarray) -> float:
    """1 - mean pairwise cosine over retrieved items (>=2 items)."""
    if embs.shape[0] < 2:
        return 0.0
    n = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-8)
    sim = n @ n.T
    iu = np.triu_indices(len(n), k=1)
    return float(1.0 - sim[iu].mean())


def label_diversity(labels: np.ndarray) -> float:
    """Mean pairwise (1 - Jaccard) over retrieved items' label sets."""
    if labels.shape[0] < 2:
        return 0.0
    lf = labels.astype(bool).astype(np.float32)
    inter = lf @ lf.T
    counts = lf.sum(axis=1)
    union = counts[:, None] + counts[None, :] - inter
    jac = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    iu = np.triu_indices(len(lf), k=1)
    return float(1.0 - jac[iu].mean())


def diversity_report(
    engine,
    query_embs: np.ndarray,
    query_ids: Sequence[str],
    labels_by_id: Mapping[str, np.ndarray],
    k: int = 10,
    out_csv: Optional[str] = None,
) -> Dict[str, float]:
    rows: List[dict] = []
    for i, qid in enumerate(query_ids):
        hits = engine.retrieve(query_embs[i], K=k, query_id=qid)
        ids = [h[0] for h in hits]
        embs = engine.get_embeddings_for_ids(ids)
        lbl = np.stack(
            [labels_by_id.get(r, np.zeros_like(next(iter(labels_by_id.values()))))
             for r in ids]
        ) if ids and labels_by_id else np.zeros((0, 1))
        rows.append(
            {
                "query_id": qid,
                "emb_diversity": embedding_diversity(embs),
                "label_diversity": label_diversity(lbl),
            }
        )
    summary = {
        "mean_emb_diversity": float(np.mean([r["emb_diversity"] for r in rows])),
        "mean_label_diversity": float(np.mean([r["label_diversity"] for r in rows])),
        "n_queries": len(rows),
    }
    if out_csv:
        Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
        with open(out_csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["query_id", "emb_diversity", "label_diversity"])
            w.writeheader()
            w.writerows(rows)
    return summary


def full_diversity_report(
    predictor,  # MMRPredictor with retriever attached
    batch_lookup,  # id -> dict(image, input_ids, attention_mask)
    query_ids: Sequence[str],
    out_dir: str,
    k: int = 5,
    save_overlays: bool = True,
) -> Dict:
    """Per-query explain for the query AND each retrieved item, overlay PNGs
    per (qid, rid, map type), cross-map comparison metrics, JSON report
    (reference diversity_retrieval_report.py, module-level script)."""
    import json

    from mmrp_tpu_torch.models.explain import compare_maps
    from mmrp_tpu_torch.utils.viz import save_query_overlays

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    report = []
    for qid in query_ids:
        q = batch_lookup(qid)
        res = predictor.predict(
            q["image"], q["input_ids"], q["attention_mask"], K=k,
            query_id=qid, explain=True,
        )
        q_map = res["explanation"]["attention"]["attn_final"][0]
        q_gray = (np.asarray(q["image"])[0, :, :, 0] + 1.0) / 2.0
        if save_overlays:
            save_query_overlays(str(out / "overlays"), qid, q_gray,
                                {"attn": q_map})
        entry = {"query_id": qid, "results": []}
        embs = []
        for rid, score in res.get("retrieval", [[]])[0]:
            try:
                r = batch_lookup(rid)
            except KeyError:
                continue
            r_maps = predictor.explainer.attention_maps(
                r["image"], r["input_ids"], r["attention_mask"]
            )
            r_map = r_maps["attn_final"][0]
            if save_overlays:
                r_gray = (np.asarray(r["image"])[0, :, :, 0] + 1.0) / 2.0
                save_query_overlays(str(out / "overlays"), qid, r_gray,
                                    {"attn": r_map}, result_id=rid)
            cmp = compare_maps(q_map, r_map)
            entry["results"].append({"id": rid, "score": float(score), **cmp})
            r_emb = predictor.embed(r["image"], r["input_ids"], r["attention_mask"])
            embs.append(r_emb["joint_emb"][0])
        if embs:
            entry["emb_diversity"] = embedding_diversity(np.stack(embs))
        report.append(entry)
    (out / "diversity_report.json").write_text(
        json.dumps(report, indent=1, default=float)
    )
    return {"n_queries": len(report), "report_path": str(out / "diversity_report.json")}
