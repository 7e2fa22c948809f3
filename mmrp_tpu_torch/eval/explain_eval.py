"""Retrieval + explainability joint evaluation.

A copy of ``mmrp_tpu/eval/explain_eval.py`` over the port's predictor: for each test query, run
predict(explain=True), retrieve the top-1 result, explain it too, and
measure attention-map alignment between query and top-1 (Pearson /
Spearman / IoU@5% / IoU@20%) alongside the usual retrieval metrics.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from mmrp_tpu_torch.eval import metrics as M
from mmrp_tpu_torch.models.explain import compare_maps


def retrieval_explain_eval(
    predictor,  # MMRPredictor
    batch_lookup,  # id -> dict(image, input_ids, attention_mask)
    query_ids: Sequence[str],
    gt: Mapping[str, Sequence[str]],
    k: int = 5,
    out_path: Optional[str] = None,
) -> Dict[str, float]:
    retrieved, relevant = [], []
    align = {"pearson": [], "spearman": [], "iou@5%": [], "iou@20%": []}
    for qid in query_ids:
        q = batch_lookup(qid)
        res = predictor.predict(
            q["image"], q["input_ids"], q["attention_mask"], K=k, explain=True,
            query_id=qid,
        )
        hits = res.get("retrieval", [[]])[0]
        retrieved.append([h[0] for h in hits])
        relevant.append(set(gt.get(qid, [])))
        if hits:
            top1 = hits[0][0]
            try:
                r = batch_lookup(top1)
            except KeyError:
                continue
            q_map = res["explanation"]["attention"]["attn_final"][0]
            r_exp = predictor.explainer.attention_maps(
                r["image"], r["input_ids"], r["attention_mask"]
            )
            cmp = compare_maps(q_map, r_exp["attn_final"][0])
            for key in align:
                v = cmp.get(key)
                if v is not None and np.isfinite(v):
                    align[key].append(v)

    out = {
        f"P@{k}": float(np.mean([M.precision_at_k(r, s, k) for r, s in zip(retrieved, relevant)])),
        "mAP": M.mean_average_precision(retrieved, relevant, k),
        "MRR": M.mean_reciprocal_rank(retrieved, relevant),
    }
    for key, vals in align.items():
        out[f"align_{key}"] = float(np.mean(vals)) if vals else float("nan")
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(out, indent=1, default=float))
    return out
