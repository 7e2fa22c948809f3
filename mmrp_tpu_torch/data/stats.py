"""Raw-array dataset + data-access helpers for EDA and the web demo.

Counterpart of ``mmrp_tpu/data/stats.py``, copied (numpy and the standard
library only; nothing of JAX).

Covers the reference's stat utilities (reference:
src/DataHandler/stat_utils.py:7-57 RawStatDataset — raw decoded arrays with
a zero-array fallback on decode failure; src/Helpers/helper.py:37-101 —
cached report lookup + recursive DICOM find with id fallback;
src/Helpers/webTestSetContruct.py:20-90 — the web demo's sample set).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmrp_tpu_torch.data.dicom import load_raw_array


class RawStatDataset:
    """Raw normalized arrays resized to a common shape for statistics;
    zero array on decode failure (stat_utils.py:55-57)."""

    def __init__(self, records: Sequence[dict], size: Tuple[int, int] = (224, 224)):
        self.records = list(records)
        self.size = size

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> np.ndarray:
        from mmrp_tpu_torch.data.dicom import _resize_bilinear

        try:
            arr = load_raw_array(self.records[idx]["dicom_path"])
            return _resize_bilinear(arr.astype(np.float32), self.size)
        except (ValueError, OSError):
            return np.zeros(self.size, np.float32)

    def intensity_stats(self, max_samples: Optional[int] = None) -> Dict[str, float]:
        n = min(len(self), max_samples or len(self))
        vals = np.stack([self[i] for i in range(n)])
        return {
            "mean": float(vals.mean()),
            "std": float(vals.std()),
            "p01": float(np.percentile(vals, 1)),
            "p99": float(np.percentile(vals, 99)),
            "n": n,
        }


class ReportLookup:
    """id -> report text with a JSON cache (reference helper.py:37-75 uses
    an unlocked pickle; this uses atomic JSON)."""

    def __init__(self, records: Optional[Sequence[dict]] = None,
                 cache_path: Optional[str] = None):
        self.cache_path = cache_path
        self._map: Dict[str, str] = {}
        if cache_path and Path(cache_path).exists():
            try:
                self._map = json.loads(Path(cache_path).read_text())
            except (json.JSONDecodeError, OSError):
                self._map = {}
        if records is not None:
            self._map.update({r["id"]: r["report_text"] for r in records})
            self._save()

    def _save(self) -> None:
        if not self.cache_path:
            return
        p = Path(self.cache_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._map))
        os.replace(tmp, p)

    def __call__(self, record_id: str) -> Optional[str]:
        return self._map.get(record_id)


def find_dicom(dicom_root: str, record_id: str) -> Optional[str]:
    """Recursive search for <record_id>.dcm with prefix fallback
    (helper.py:77-101)."""
    root = Path(dicom_root)
    exact = list(root.rglob(f"{record_id}.dcm"))
    if exact:
        return str(exact[0])
    loose = [p for p in root.rglob("*.dcm") if record_id in p.stem]
    return str(loose[0]) if loose else None


def build_web_sample_set(
    records: Sequence[dict],
    out_dir: str,
    n_per_label: int = 2,
    label_cols: Optional[Sequence[str]] = None,
    seed: int = 0,
) -> List[dict]:
    """Small diverse sample set for the web demo (webTestSetContruct.py:20-90):
    up to n_per_label records per label group, deduplicated, manifest JSON."""
    if label_cols is None:
        from mmrp_tpu_torch.labels import LABEL_COLS

        label_cols = LABEL_COLS
    rng = np.random.default_rng(seed)
    chosen: Dict[str, dict] = {}
    for c, name in enumerate(label_cols):
        holders = [r for r in records if r["labels"][c]]
        rng.shuffle(holders)
        for r in holders[:n_per_label]:
            chosen[r["id"]] = r
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = [
        {"id": r["id"], "dicom_path": r["dicom_path"],
         "report_text": r["report_text"], "labels": r["labels"]}
        for r in chosen.values()
    ]
    (out / "web_samples.json").write_text(json.dumps(manifest, indent=1))
    return manifest
