"""Classification evaluation on a data split.

Counterpart of ``mmrp_tpu/eval/classification.py``, copied (numpy and the
standard library only; nothing of JAX). The PNGs follow ``eval/eda.py::pyplot``:
drawn where matplotlib imports, else named in one line.

Parity with reference eval_on_test (reference:
src/Evaluate/eval_on_test.py:40-208): per-class AUROC/AP/P/R/F1 with
macro/micro aggregates, thresholds either fixed or F1-optimal on the split,
a detailed per-class CSV, and a text report.

Additionally ships the confusion and calibration reports the reference
README advertises (README.md "Confusion and calibration plots") but whose
code does not exist anywhere in the reference: per-class confusion counts
at the calibrated thresholds, expected calibration error over pooled
(sample, class) predictions, and reliability/confusion PNGs.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from mmrp_tpu_torch.eval.eda import pyplot
from mmrp_tpu_torch.eval.metrics import find_best_thresholds, per_class_report
from mmrp_tpu_torch.utils.logging import TeeLogger


def calibration_report(
    y_true: np.ndarray, y_prob: np.ndarray, bins: int = 10
) -> Dict:
    """Reliability stats over pooled (sample, class) predictions.

    ECE = sum_b (n_b / N) * |acc_b - conf_b| with equal-width bins — the
    standard multilabel pooling (each (i, c) sigmoid output is one
    binary prediction of P(label c present)).
    """
    conf = y_prob.ravel().astype(np.float64)
    corr = y_true.ravel().astype(np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(conf, edges[1:-1]), 0, bins - 1)
    n = np.bincount(idx, minlength=bins).astype(np.float64)
    s_conf = np.bincount(idx, weights=conf, minlength=bins)
    s_corr = np.bincount(idx, weights=corr, minlength=bins)
    with np.errstate(invalid="ignore", divide="ignore"):
        bin_conf = np.where(n > 0, s_conf / n, np.nan)
        bin_acc = np.where(n > 0, s_corr / n, np.nan)
    mask = n > 0
    ece = float(np.sum(n[mask] / conf.size * np.abs(bin_acc[mask] - bin_conf[mask])))
    return {
        "ece": ece,
        "bins": bins,
        "bin_count": n.tolist(),
        "bin_confidence": [None if np.isnan(x) else float(x) for x in bin_conf],
        "bin_accuracy": [None if np.isnan(x) else float(x) for x in bin_acc],
    }


def _save_plots(report: Dict, cal: Dict, out: Path, split_name: str) -> Dict:
    """Reliability diagram + per-class confusion chart (optional, Agg)."""
    paths = {}
    plt = pyplot([out / f"{split_name}_reliability.png", out / f"{split_name}_confusion.png"])
    if plt is None:
        return paths

    conf = [c for c in cal["bin_confidence"] if c is not None]
    acc = [a for a in cal["bin_accuracy"] if a is not None]
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    ax.plot([0, 1], [0, 1], "--", color="gray", lw=1, label="perfect")
    ax.plot(conf, acc, "o-", label=f"model (ECE {cal['ece']:.3f})")
    ax.set_xlabel("predicted probability")
    ax.set_ylabel("empirical frequency")
    ax.set_title(f"reliability ({split_name})")
    ax.legend()
    fig.tight_layout()
    p = out / f"{split_name}_reliability.png"
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths["reliability"] = str(p)

    rows = report["per_class"]
    names = [r["class"] for r in rows]
    tp = np.array([r["tp"] for r in rows], dtype=np.float64)
    fp = np.array([r["fp"] for r in rows])
    fn = np.array([r["fn"] for r in rows])
    fig, ax = plt.subplots(figsize=(10, max(3, 0.25 * len(names))))
    y = np.arange(len(names))
    ax.barh(y, tp, label="TP")
    ax.barh(y, fn, left=tp, label="FN")
    ax.barh(y, fp, left=tp + fn, label="FP")
    ax.set_yticks(y)
    ax.set_yticklabels(names, fontsize=6)
    ax.invert_yaxis()
    ax.set_title(f"per-class confusion at calibrated thresholds ({split_name})")
    ax.legend()
    fig.tight_layout()
    p = out / f"{split_name}_confusion.png"
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths["confusion"] = str(p)
    return paths


def evaluate_classification(
    probs: np.ndarray,  # (N, C)
    labels: np.ndarray,  # (N, C)
    class_names: Sequence[str],
    thresholds: Optional[np.ndarray] = None,  # None -> F1-optimal on this split
    out_dir: Optional[str] = None,
    split_name: str = "test",
) -> Dict:
    if thresholds is None:
        thresholds = find_best_thresholds(labels, probs)
    report = per_class_report(labels, probs, np.asarray(thresholds), class_names)
    cal = calibration_report(labels, probs)
    report["calibration"] = cal

    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        csv_path = out / f"{split_name}_per_class.csv"
        with csv_path.open("w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(report["per_class"][0].keys()))
            w.writeheader()
            w.writerows(report["per_class"])
        log = TeeLogger(str(out / f"{split_name}_report.txt"))
        log(f"== classification report ({split_name}) ==")
        log(f"macro AUROC {report['macro_auroc']:.4f}  macro AP {report['macro_ap']:.4f}")
        log(f"macro F1 {report['macro_f1']:.4f}  micro F1 {report['micro_f1']:.4f}")
        log(f"ECE {cal['ece']:.4f} ({cal['bins']} bins)")
        report["plots"] = _save_plots(report, cal, out, split_name)
        (out / f"{split_name}_summary.json").write_text(
            json.dumps({k: v for k, v in report.items() if k != "per_class"},
                       indent=1, default=float)
        )
    return report
