"""Dataset EDA + data-quality checks.

Counterpart of ``mmrp_tpu/eval/eda.py``, copied (numpy and the standard
library only; nothing of JAX). The PNGs are drawn where matplotlib imports;
where it does not, :func:`pyplot` prints one line naming the PNGs it skipped,
and the JSON reports are written all the same.

Covers the reference's EDA scripts (reference: src/Evaluate/
EDA_before_split.py, EDA_after_split.py, dataEDAnLabeledCheck.py,
finalOutputDataEDA.py, data_phrase_check.py): label prevalence,
co-occurrence, report-length stats, zero-label filtering, per-split
distribution comparison, and LLM-verification delta analysis.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def pyplot(skipped: Sequence) -> Optional[object]:
    """``matplotlib.pyplot`` on the Agg backend, or None after one line
    naming the PNGs in ``skipped`` that are not drawn without it."""
    try:
        import matplotlib
    except ImportError:
        print(f"[eda] matplotlib not installed: skipped {', '.join(map(str, skipped))}")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def label_prevalence(labels: np.ndarray, names: Sequence[str]) -> Dict[str, float]:
    L = np.asarray(labels)
    return {n: float(L[:, i].mean()) for i, n in enumerate(names)}


def label_cooccurrence(labels: np.ndarray) -> np.ndarray:
    L = np.asarray(labels, np.float64)
    return L.T @ L


def report_length_stats(texts: Sequence[str]) -> Dict[str, float]:
    lens = np.array([len(t.split()) for t in texts])
    return {
        "mean": float(lens.mean()) if len(lens) else 0.0,
        "p50": float(np.percentile(lens, 50)) if len(lens) else 0.0,
        "p95": float(np.percentile(lens, 95)) if len(lens) else 0.0,
        "max": int(lens.max()) if len(lens) else 0,
    }


def drop_zero_label_records(records: Sequence[dict]) -> List[dict]:
    """Zero-label rows are dropped before splitting (EDA_before_split.py)."""
    return [r for r in records if any(r["labels"])]


def eda_before_split(records: Sequence[dict], names: Sequence[str],
                     out_path: Optional[str] = None) -> Dict:
    labels = np.stack([np.asarray(r["labels"]) for r in records])
    report = {
        "n_records": len(records),
        "n_zero_label": int((labels.sum(1) == 0).sum()),
        "prevalence": label_prevalence(labels, names),
        "report_length": report_length_stats([r["report_text"] for r in records]),
        "mean_labels_per_record": float(labels.sum(1).mean()),
    }
    if out_path:
        Path(out_path).write_text(json.dumps(report, indent=1))
    return report


def eda_after_split(
    splits: Mapping[str, Sequence[str]],
    records_by_id: Mapping[str, dict],
    names: Sequence[str],
    out_path: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-split prevalence comparison (EDA_after_split.py)."""
    out: Dict[str, Dict[str, float]] = {}
    for split, ids in splits.items():
        labels = np.stack([np.asarray(records_by_id[i]["labels"]) for i in ids])
        out[split] = label_prevalence(labels, names)
    if out_path:
        Path(out_path).write_text(json.dumps(out, indent=1))
    return out


def verification_delta(
    before: Sequence[dict], after: Sequence[dict], names: Sequence[str]
) -> Dict[str, int]:
    """How many labels the LLM pass added/removed (finalOutputDataEDA.py)."""
    b = np.stack([np.asarray(r["labels"]) for r in before])
    a = np.stack([np.asarray(r["labels"]) for r in after])
    return {
        "added": int(((a == 1) & (b == 0)).sum()),
        "removed": int(((a == 0) & (b == 1)).sum()),
        "unchanged_records": int((a == b).all(axis=1).sum()),
        "changed_records": int((a != b).any(axis=1).sum()),
    }


def mesh_label_stats(
    xml_dir: str,
    out_dir: Optional[str] = None,
    min_count_threshold: int = 5,
) -> Dict:
    """MeSH-term statistics vs the label taxonomy (reference:
    src/Evaluate/dataEDAnLabeledCheck.py): count ``<MeSH>`` child terms
    across the OpenI XMLs, map each (lowercased, pre-'/' qualifier
    stripped) term against every taxonomy phrase list, and report unmapped
    terms, terms claimed by multiple groups, and per-group phrase counts.
    With ``out_dir`` set, also writes a bar plot of the frequent terms."""
    import xml.etree.ElementTree as ET

    from mmrp_tpu_torch.labels.taxonomy import get_taxonomy

    counter: Counter = Counter()
    files = sorted(Path(xml_dir).glob("*.xml"))
    for fn in files:
        try:
            root = ET.parse(fn).getroot()
        except ET.ParseError:
            continue
        for node in root.findall(".//MeSH/*"):
            label = (node.text or "").split("/")[0].strip().lower()
            if label:
                counter[label] += 1

    # ALL categories including the auxiliary device/technical/anatomy
    # groups, like the reference's merged all_groups dict
    all_groups: Dict[str, Sequence[str]] = {}
    for groups in get_taxonomy().categories.values():
        all_groups.update(groups)
    reverse: Dict[str, List[str]] = {}
    for group, phrases in all_groups.items():
        for p in phrases:
            reverse.setdefault(p.strip().lower(), []).append(group)
    unmapped = sorted(t for t in counter if t not in reverse)
    multi = sorted(t for t, g in reverse.items() if len(g) > 1)
    report = {
        "n_xml_files": len(files),
        "n_unique_mesh_terms": len(counter),
        "n_mesh_occurrences": int(sum(counter.values())),
        "mesh_counts": dict(counter.most_common()),
        "unmapped_terms": unmapped,
        "n_unmapped": len(unmapped),
        "terms_in_multiple_groups": multi,
        "group_phrase_counts": {g: len(p) for g, p in all_groups.items()},
    }
    if out_dir:
        outp = Path(out_dir)
        outp.mkdir(parents=True, exist_ok=True)
        (outp / "mesh_label_stats.json").write_text(
            json.dumps(report, indent=1)
        )
        top = [(t, c) for t, c in counter.most_common()
               if c >= min_count_threshold] or counter.most_common(20)
        plt = pyplot([outp / "mesh_term_counts.png"]) if top else None
        if plt is not None:
            fig, ax = plt.subplots(figsize=(10, max(3, 0.3 * len(top))))
            names = [t for t, _ in top][::-1]
            vals = [c for _, c in top][::-1]
            ax.barh(names, vals)
            ax.set_xlabel("occurrences")
            ax.set_title(f"MeSH terms (count >= {min_count_threshold})")
            fig.tight_layout()
            fig.savefig(outp / "mesh_term_counts.png", dpi=100)
            plt.close(fig)
            report["plot"] = str(outp / "mesh_term_counts.png")
    return report


def dicom_debug_plots(dicom_src, out_dir: str) -> Dict[str, float]:
    """DICOM-pipeline visual debug (reference: src/Evaluate/
    data_phrase_check.py:61-110): per-stage histograms (raw -> rescaled ->
    windowed -> normalized) and the final normalized image, as PNGs, plus
    the printed min/max stats as a dict."""
    from mmrp_tpu_torch.data.dicom import percentile_window, read_dicom, window_image

    dcm = read_dicom(dicom_src)
    raw = dcm.pixel_array.astype(np.float32)
    scaled = raw * dcm.rescale_slope + dcm.rescale_intercept
    if dcm.window_center is not None and dcm.window_width:
        lower = dcm.window_center - dcm.window_width / 2.0
        upper = dcm.window_center + dcm.window_width / 2.0
        win = np.clip(scaled, lower, upper)
        norm = (win - lower) / (upper - lower + 1e-5)
    else:
        norm = percentile_window(scaled)
        win = norm
    stats = {
        "raw_min": float(raw.min()), "raw_max": float(raw.max()),
        "scaled_min": float(scaled.min()), "scaled_max": float(scaled.max()),
        "window_center": float(dcm.window_center or 0.0),
        "window_width": float(dcm.window_width or 0.0),
        "norm_min": float(norm.min()), "norm_max": float(norm.max()),
    }

    outp = Path(out_dir)
    outp.mkdir(parents=True, exist_ok=True)
    (outp / "dicom_debug_stats.json").write_text(json.dumps(stats, indent=1))
    plt = pyplot([outp / "dicom_debug.png", outp / "final_norm.png"])
    if plt is None:
        return stats
    fig, axs = plt.subplots(1, 4, figsize=(16, 3.2))
    for ax, (title, arr) in zip(
        axs, [("Raw", raw), ("Scaled", scaled), ("Windowed", win),
              ("Normalized", norm)]
    ):
        ax.hist(arr.ravel(), bins=100)
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(outp / "dicom_debug.png", dpi=100)
    plt.close(fig)

    fig, ax = plt.subplots()
    ax.imshow(norm, cmap="gray", vmin=0, vmax=1)
    ax.set_title("Final Normalized Image")
    ax.axis("off")
    fig.savefig(outp / "final_norm.png", dpi=100)
    plt.close(fig)
    return stats


def label_distribution_plot(
    labels: np.ndarray, names: Sequence[str], out_path: str
) -> Optional[str]:
    """Positive-count bar chart per label (data_phrase_check.py's label
    distribution plot); None where matplotlib is missing."""
    plt = pyplot([out_path])
    if plt is None:
        return None
    counts = np.asarray(labels).sum(axis=0)
    fig, ax = plt.subplots(figsize=(10, max(3, 0.25 * len(names))))
    ax.barh(list(names)[::-1], counts[::-1].tolist())
    ax.set_xlabel("positive count")
    ax.set_title("Label distribution")
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def phrase_match_check(
    records: Sequence[dict], labeler, n_samples: int = 20, seed: int = 0
) -> List[dict]:
    """Spot-check which phrases fired per report (data_phrase_check.py)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(records), size=min(n_samples, len(records)), replace=False)
    out = []
    for i in idx:
        rec = records[int(i)]
        ms = labeler.matches(rec["report_text"])
        out.append(
            {
                "id": rec["id"],
                "matches": [
                    {"group": m.group, "phrase": m.phrase, "negated": m.negated}
                    for m in ms
                ],
            }
        )
    return out
