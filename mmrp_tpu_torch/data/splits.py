"""Leak-safe multilabel stratified train/val/test splitting.

Counterpart of ``mmrp_tpu/data/splits.py``, copied (numpy and the standard
library only; nothing of JAX).

Parity with the reference splitter (reference:
src/DataHandler/train_val_split.py:31-152): records are grouped **by report
text** so no report straddles splits, each group gets an OR-aggregated label
vector, and an 80/10/10 split is produced by two stratified stages. The
reference depends on iterative-stratification's
MultilabelStratifiedShuffleSplit; this framework implements iterative
stratification (Sechidis et al., 2011) directly — same algorithm family,
no dependency — and writes the same artifact set (per-split id JSONs, CSVs,
per-label positive-count diagnostics).
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def multilabel_stratified_split(
    Y: np.ndarray,
    proportions: Sequence[float],
    seed: int = 2709,
) -> List[np.ndarray]:
    """Iterative stratification of samples with label matrix Y (n, C).

    Returns one index array per proportion; every sample is assigned to
    exactly one split. Deterministic for a given seed.
    """
    Y = np.asarray(Y, dtype=bool)
    n, C = Y.shape
    k = len(proportions)
    props = np.asarray(proportions, dtype=np.float64)
    props = props / props.sum()
    rng = np.random.default_rng(seed)

    # desired residual sample counts per split, and per (split, label)
    desire = props * n
    label_counts = Y.sum(axis=0).astype(np.float64)
    desire_label = props[:, None] * label_counts[None, :]

    assigned = np.full(n, -1, dtype=np.int64)
    remaining = set(range(n))

    # process labels from rarest to most common, re-evaluated each round
    while remaining:
        rem_idx = np.fromiter(remaining, dtype=np.int64)
        rem_Y = Y[rem_idx]
        per_label_rem = rem_Y.sum(axis=0)
        active = np.where(per_label_rem > 0)[0]
        if active.size == 0:
            # label-free samples: fill splits by remaining overall desire
            for i in rem_idx:
                j = int(np.argmax(desire + rng.random(k) * 1e-9))
                assigned[i] = j
                desire[j] -= 1.0
            break
        # rarest active label
        l = active[np.argmin(per_label_rem[active])]
        holders = rem_idx[rem_Y[:, l]]
        # shuffle for tie-breaking determinism under seed
        rng.shuffle(holders)
        for i in holders:
            cand = desire_label[:, l]
            best = np.where(cand == cand.max())[0]
            if best.size > 1:
                overall = desire[best]
                best = best[np.where(overall == overall.max())[0]]
                j = int(rng.choice(best))
            else:
                j = int(best[0])
            assigned[i] = j
            desire[j] -= 1.0
            desire_label[j, Y[i]] -= 1.0
            remaining.discard(int(i))

    return [np.where(assigned == j)[0] for j in range(k)]


def train_val_test_split(
    records: Sequence[dict],
    train_frac: float = 0.8,
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 2709,
    out_dir: Optional[str] = None,
    label_cols: Optional[Sequence[str]] = None,
) -> Dict[str, List[str]]:
    """Group records by report text, stratify groups, return per-split id lists.

    Two stratified stages (train vs rest, then val vs test) mirror the
    reference's nested MultilabelStratifiedShuffleSplit (train_val_split.py:87-96).
    """
    if label_cols is None:
        from mmrp_tpu_torch.labels import LABEL_COLS

        label_cols = LABEL_COLS

    # group by report text — leak prevention (train_val_split.py:48-54)
    group_ids: Dict[str, List[str]] = defaultdict(list)
    group_labels: Dict[str, np.ndarray] = {}
    for rec in records:
        key = rec["report_text"]
        group_ids[key].append(rec["id"])
        vec = np.asarray(rec["labels"], dtype=bool)
        group_labels[key] = group_labels.get(key, np.zeros(len(label_cols), bool)) | vec

    keys = sorted(group_ids)  # deterministic group order
    Y = np.stack([group_labels[key] for key in keys])

    # stage 1: train vs (val+test)
    rest_frac = val_frac + test_frac
    tr_idx, rest_idx = multilabel_stratified_split(
        Y, [train_frac, rest_frac], seed=seed
    )
    # stage 2: val vs test within the rest
    val_rel, test_rel = multilabel_stratified_split(
        Y[rest_idx], [val_frac / rest_frac, test_frac / rest_frac], seed=seed + 1
    )
    val_idx = rest_idx[val_rel]
    test_idx = rest_idx[test_rel]

    splits = {
        "train": sorted(i for g in tr_idx for i in group_ids[keys[g]]),
        "val": sorted(i for g in val_idx for i in group_ids[keys[g]]),
        "test": sorted(i for g in test_idx for i in group_ids[keys[g]]),
    }

    if out_dir:
        _write_split_artifacts(splits, records, label_cols, out_dir)
    return splits


def check_label_consistency(
    records: Sequence[dict],
    labels_by_id: Dict[str, Sequence[int]],
    max_report: int = 10,
) -> List[str]:
    """Compare records' label vectors against an external label table;
    returns mismatching ids (the reference aborts on any mismatch,
    src/Trainner/train.py:169-195, 407-409)."""
    bad: List[str] = []
    for rec in records:
        ext = labels_by_id.get(rec["id"])
        if ext is None:
            continue
        if list(map(int, ext)) != list(map(int, rec["labels"])):
            bad.append(rec["id"])
    if bad:
        print(f"[splits] label mismatch for {len(bad)} records "
              f"(first {max_report}): {bad[:max_report]}")
    return bad


def _write_split_artifacts(splits, records, label_cols, out_dir) -> None:
    """id JSONs + per-split CSVs + per-label positive-count diagnostics
    (reference train_val_split.py:127-150)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    by_id = {r["id"]: r for r in records}
    diag: Dict[str, Dict[str, int]] = {}
    for name, ids in splits.items():
        (out / f"{name}_ids.json").write_text(json.dumps(ids, indent=1))
        lines = ["id,report_text," + ",".join(label_cols)]
        counts = np.zeros(len(label_cols), dtype=int)
        for rid in ids:
            rec = by_id[rid]
            text = rec["report_text"].replace('"', "'").replace("\n", " ")
            row = f'{rid},"{text}",' + ",".join(str(v) for v in rec["labels"])
            lines.append(row)
            counts += np.asarray(rec["labels"], dtype=int)
        (out / f"{name}_labels.csv").write_text("\n".join(lines))
        diag[name] = {c: int(v) for c, v in zip(label_cols, counts)}
    (out / "split_label_counts.json").write_text(json.dumps(diag, indent=1))
