"""One-command reference-protocol parity run.

Counterpart of ``mmrp_tpu/eval/parity.py`` over the port's modules: the
re-embed runs ``MMRPredictor.embed`` on the serving kernels and the explain
alignment the kernels' gradient routes, on ``device`` (the card unless the
caller names another).

``python -m mmrp_tpu_torch.cli parity --data <openi_dir> --run-dir <run_dir>``
executes the reference's FULL evaluation protocol against a trained run
and writes ``PARITY_RESULTS.md`` + ``parity_results.json``:

- per-class classification AUROC / F1 / AP with the run's calibrated
  thresholds (reference src/Evaluate/eval_on_test.py:40-208)
- dual-gallery retrieval (test-as-gallery generalization vs
  train-as-gallery historical) with latency percentiles
  (retrieval_eval.py:33-186), on the run config's ``retrieval_backend``:
  the exact engine, or the reference's DLS walk (``retrieval/dls.py``)
- reranker ablation variants + paired significance vs the cosine
  baseline (retrieval_eval_variants.py:31-153; significance is
  advertised in the reference README but implemented only here)
- embedding-rank eval by label-overlap GT (retrieval_overlap.py:84-202)
- retrieval + explanation-alignment eval: Pearson / Spearman / IoU of
  the query's attention map vs its top-1 neighbor's
  (retrieval_explain_eval.py:85-304)
- retrieval diversity + KG sanity probes (diversity_retrieval_report.py,
  KG health checks)

The runner re-embeds the test split from the restored checkpoint (one
forward per batch yields both probs and joint embeddings), so the report
validates the full serve path, not just cached artifacts. It dry-runs on
the synthetic OpenI fixture (tests/test_end_to_end.py) — when real OpenI
data lands, bit-for-metric parity vs BASELINE.md is this one command
instead of a round of plumbing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from mmrp_tpu_torch.device import DEFAULT_DEVICE
from mmrp_tpu_torch.labels import LABEL_COLS


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4f}" if np.isfinite(v) else "nan"
    return str(v)


def _md_table(d: Dict[str, Any]) -> str:
    keys = [k for k, v in d.items() if not isinstance(v, (dict, list))]
    head = "| " + " | ".join(keys) + " |"
    sep = "|" + "---|" * len(keys)
    row = "| " + " | ".join(_fmt(d[k]) for k in keys) + " |"
    return "\n".join([head, sep, row])


def run_parity(
    data_dir: str,
    run_dir: str,
    out_dir: Optional[str] = None,
    k: int = 10,
    explain_queries: int = 8,
    device=DEFAULT_DEVICE,
) -> Dict[str, Any]:
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.data.dataset import ChestXRDataset, build_dataloader
    from mmrp_tpu_torch.eval.classification import evaluate_classification
    from mmrp_tpu_torch.eval.diversity import diversity_report
    from mmrp_tpu_torch.eval.explain_eval import retrieval_explain_eval
    from mmrp_tpu_torch.eval.gt import build_label_overlap_gt
    from mmrp_tpu_torch.eval.retrieval_eval import (
        dual_gallery_eval,
        embedding_rank_eval,
        variant_eval,
    )
    from mmrp_tpu_torch.retrieval.dls import make_retrieval_engine
    from mmrp_tpu_torch.retrieval.rerank import Reranker
    from mmrp_tpu_torch.serve.runner import build_demo_context, load_rerank_inputs

    t0 = time.time()
    data = Path(data_dir)
    run = Path(run_dir)
    out = Path(out_dir) if out_dir else run / "parity"
    out.mkdir(parents=True, exist_ok=True)

    cfg_path = run / "config.yaml"
    cfg = Config.load(str(cfg_path)) if cfg_path.exists() else Config()

    ctx = build_demo_context(str(run), data_dir=str(data), device=device)
    predictor = ctx["predictor"]
    tok = ctx["tokenizer"]

    records = json.loads((data / "records_cache.json").read_text())["records"]
    by_id = {r["id"]: r for r in records}
    test_ids_split = json.loads(
        (data / "splits" / "test_ids.json").read_text()
    )
    test_recs = [by_id[i] for i in test_ids_split if i in by_id]
    if not test_recs:
        raise ValueError(f"no test records resolvable from {data}")

    ds = ChestXRDataset(
        test_recs, tok, max_length=cfg.text_dim, image_size=cfg.image_size
    )
    loader = build_dataloader(
        ds, cfg.batch_size, shuffle=False, num_workers=cfg.data_workers
    )

    # ---- one pass: probs + joint embeddings off the restored checkpoint --
    probs_l, embs_l, labels_l, ids = [], [], [], []
    for batch in loader:
        o = predictor.embed(
            batch["image"], batch["input_ids"], batch["attention_mask"]
        )
        keep = np.asarray(batch["valid"]) > 0
        probs_l.append(o["probs"][keep])
        embs_l.append(o["joint_emb"][keep])
        labels_l.append(np.asarray(batch["labels"])[keep])
        ids.extend([i for i, kp in zip(batch["ids"], keep) if kp])
    probs = np.concatenate(probs_l)
    test_embs = np.concatenate(embs_l)
    labels = np.concatenate(labels_l)

    report: Dict[str, Any] = {"n_test": len(ids), "run_dir": str(run)}

    # ---- classification (eval_on_test.py:40-208) --------------------------
    th = predictor.threshold
    th_arr = np.asarray(th)
    cls = evaluate_classification(
        probs, labels, LABEL_COLS,
        thresholds=th_arr if th_arr.ndim else None,
        out_dir=str(out / "cls"),
    )
    report["classification"] = {
        key: cls[key] for key in cls
        if key not in ("per_class",) and not isinstance(cls[key], (list,))
    }
    report["classification_per_class_csv"] = str(
        out / "cls" / "test_per_class.csv"
    )

    # ---- dual-gallery retrieval + variants + significance ------------------
    train_emb = np.load(run / "train_embeddings.npy")
    train_ids = json.loads((run / "train_ids.json").read_text())
    lbl = lambda idlist: np.stack([by_id[i]["labels"] for i in idlist])
    gt_test = build_label_overlap_gt(ids, labels, ids, labels)
    gt_train = build_label_overlap_gt(ids, labels, train_ids, lbl(train_ids))

    test_eng = make_retrieval_engine(cfg.retrieval_backend, test_embs, ids, device=device)
    train_eng = make_retrieval_engine(cfg.retrieval_backend, train_emb, train_ids,
                                      device=device)
    report["retrieval"] = dual_gallery_eval(
        test_eng, train_eng, test_embs, ids, gt_test, gt_train,
        k=k, out_dir=str(out / "retrieval"),
    )

    labels_by_id, _, kg_kwargs = load_rerank_inputs(
        str(run), data_dir=str(data), warn=False
    )

    def factory(a, b, c):
        return Reranker(alpha=a, beta=b, gamma=c,
                        labels_by_id=labels_by_id,
                        label_names=LABEL_COLS, **kg_kwargs)

    report["variants"] = variant_eval(
        test_eng, test_embs, ids, gt_test, factory, k=k,
        out_path=str(out / "variants.json"),
    )

    # ---- embedding-rank eval (retrieval_overlap.py:84-202) ----------------
    report["embedding_rank"] = embedding_rank_eval(
        test_embs, ids, train_emb, train_ids, gt_train,
        ks=(1, 5, min(10, len(train_ids))), device=device,
    )

    # ---- explain alignment (retrieval_explain_eval.py:85-304) -------------
    idx_by_id = {r["id"]: j for j, r in enumerate(test_recs)}

    def batch_lookup(rid: str) -> Dict[str, np.ndarray]:
        if rid not in idx_by_id:
            raise KeyError(rid)
        s = ds[idx_by_id[rid]]
        return {
            "image": s["image"][None],
            "input_ids": s["input_ids"][None],
            "attention_mask": s["attention_mask"][None],
        }

    n_explain = min(explain_queries, len(ids))
    if predictor.retriever is not None and n_explain:
        report["explain_alignment"] = retrieval_explain_eval(
            predictor, batch_lookup, ids[:n_explain], gt_train,
            k=min(5, k), out_path=str(out / "explain_alignment.json"),
        )
        # ---- retrieval diversity (diversity_retrieval_report.py) ----------
        lbl_by_id = {i: np.asarray(by_id[i]["labels"], np.float32)
                     for i in train_ids if i in by_id}
        report["diversity"] = diversity_report(
            predictor.retriever, test_embs[:n_explain], ids[:n_explain],
            lbl_by_id, k=min(5, k), out_csv=str(out / "diversity.csv"),
        )

    # ---- KG sanity probes --------------------------------------------------
    kg_dir = run / "kg"
    if (kg_dir / "node_embeddings.npy").exists():
        from mmrp_tpu_torch.eval.kg_probe import full_probe

        probe = full_probe(
            str(kg_dir), LABEL_COLS, out_path=str(out / "kg_probe.json")
        )
        report["kg_health"] = probe.get("health", probe)

    report["wall_s"] = round(time.time() - t0, 2)

    # ---- write the report ---------------------------------------------------
    (out / "parity_results.json").write_text(
        json.dumps(report, indent=1, default=float)
    )
    md = ["# Parity results — reference evaluation protocol", ""]
    md += [f"Run: `{run}` · data: `{data}` · test N = {len(ids)} · "
           f"wall {report['wall_s']}s", ""]
    md += ["## Classification (eval_on_test.py:40-208)", "",
           _md_table({kk: vv for kk, vv in report["classification"].items()
                      if not isinstance(vv, dict)}), ""]
    for split_name, res in report["retrieval"].items():
        if isinstance(res, dict):
            md += [f"## Retrieval — {split_name} gallery "
                   "(retrieval_eval.py:33-186)", "", _md_table(res), ""]
    if isinstance(report.get("variants"), dict):
        md += ["## Reranker variants + significance "
               "(retrieval_eval_variants.py:31-153)", ""]
        for name, res in report["variants"].items():
            if isinstance(res, dict):
                md += [f"**{name}**", "", _md_table(res), ""]
    md += ["## Embedding-rank eval (retrieval_overlap.py:84-202)", "",
           _md_table(report["embedding_rank"]), ""]
    if "explain_alignment" in report:
        md += ["## Explain alignment (retrieval_explain_eval.py:85-304)",
               "", _md_table(report["explain_alignment"]), ""]
    if "diversity" in report:
        md += ["## Retrieval diversity", "", _md_table(report["diversity"]),
               ""]
    if "kg_health" in report:
        md += ["## KG health", "",
               "```json",
               json.dumps(report["kg_health"], indent=1, default=float),
               "```", ""]
    (out / "PARITY_RESULTS.md").write_text("\n".join(md))
    return report
