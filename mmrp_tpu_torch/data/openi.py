"""OpenI XML report parsing -> records.

Counterpart of ``mmrp_tpu/data/openi.py``, copied (numpy and the standard
library only; nothing of JAX).

Behavior parity with the reference parser (reference:
src/DataHandler/dataParser.py:92-176): per-XML ``parentImage`` ids are
normalized (``CXR3_1_IM-1384-2001`` -> ``3_IM-1384-2001``) and joined against
a recursive ``*.dcm`` scan; the report text is the concatenation of
``AbstractText`` nodes (falling back to ``ArticleTitle``); each matched image
yields a record with a 43-dim weak label vector plus is_normal/is_abnormal
flags (Normal fires alone vs. any non-Normal group).

Unlike the reference — which re-runs this parse up to four times per
pipeline run (SURVEY §3.1) — ``parse_openi_xml`` memoizes to a JSON cache
keyed by directory fingerprints.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from mmrp_tpu_torch.data.labeler import PhraseLabeler
from mmrp_tpu_torch.labels import LABEL_COLS


def normalize_image_id(raw_id: str) -> Optional[str]:
    """``CXR<n>_<rest>`` -> ``<n>_<rest>``; None when not normalizable."""
    if not raw_id or not raw_id.startswith("CXR") or "_" not in raw_id:
        return None
    num, _, rest = raw_id[3:].partition("_")
    if not rest:
        return None
    return f"{num}_{rest}"


def scan_dicom_dir(dicom_root: str) -> Dict[str, str]:
    """Recursive .dcm scan -> {basename-without-ext: path}."""
    paths = glob.glob(os.path.join(dicom_root, "**", "*.dcm"), recursive=True)
    return {os.path.splitext(os.path.basename(p))[0]: p for p in paths}


def extract_report_text(root: ET.Element) -> str:
    parts = [n.text.strip() for n in root.findall(".//AbstractText") if n.text]
    if not parts:
        title = root.findtext(".//ArticleTitle") or ""
        parts = [title.strip()]
    return " ".join(parts)


def parse_openi_xml(
    xml_dir: str,
    dicom_root: str,
    labeler: Optional[PhraseLabeler] = None,
    label_cols: Optional[Sequence[str]] = None,
    cache_path: Optional[str] = None,
) -> List[dict]:
    """Parse all XML reports; returns records
    {id, dicom_path, report_text, labels, is_normal, is_abnormal}."""
    label_cols = list(label_cols or LABEL_COLS)

    if cache_path:
        cached = _load_cache(cache_path, xml_dir, dicom_root, label_cols)
        if cached is not None:
            return cached

    labeler = labeler or PhraseLabeler()
    dcm_map = scan_dicom_dir(dicom_root)
    normal_idx = label_cols.index("Normal") if "Normal" in label_cols else -1

    records: List[dict] = []
    for fname in sorted(os.listdir(xml_dir)):
        if not fname.endswith(".xml"):
            continue
        try:
            root = ET.parse(os.path.join(xml_dir, fname)).getroot()
        except ET.ParseError:
            continue
        report = extract_report_text(root)
        vec: Optional[List[int]] = None  # label once per report, reuse per image
        for img_tag in root.findall("parentImage"):
            image_id = normalize_image_id(img_tag.attrib.get("id", ""))
            if image_id is None:
                continue
            dcm_path = dcm_map.get(image_id)
            if dcm_path is None:
                continue
            if vec is None:
                vec = labeler.label_vector(report, label_cols)
            is_normal = normal_idx >= 0 and vec[normal_idx] == 1 and sum(vec) == 1
            is_abnormal = any(
                v for i, v in enumerate(vec) if i != normal_idx
            )
            records.append(
                {
                    "id": image_id,
                    "dicom_path": dcm_path,
                    "report_text": report,
                    "labels": vec,
                    "is_normal": is_normal,
                    "is_abnormal": is_abnormal,
                }
            )

    if cache_path:
        _save_cache(cache_path, xml_dir, dicom_root, label_cols, records)
    return records


# ---------------------------------------------------------------------------
# Cache (parse once; the reference re-parses per stage)
# ---------------------------------------------------------------------------


def _fingerprint(xml_dir: str, dicom_root: str, label_cols: Sequence[str]) -> str:
    h = hashlib.sha256()
    for d in (xml_dir, dicom_root):
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        h.update(d.encode())
        h.update(str(len(names)).encode())
        for n in names[:50]:
            h.update(n.encode())
    h.update("|".join(label_cols).encode())
    return h.hexdigest()


def _load_cache(path, xml_dir, dicom_root, label_cols) -> Optional[List[dict]]:
    p = Path(path)
    if not p.exists():
        return None
    try:
        blob = json.loads(p.read_text())
        if blob.get("fingerprint") == _fingerprint(xml_dir, dicom_root, label_cols):
            return blob["records"]
    except (json.JSONDecodeError, KeyError, OSError):
        pass
    return None


def _save_cache(path, xml_dir, dicom_root, label_cols, records) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(
        json.dumps(
            {
                "fingerprint": _fingerprint(xml_dir, dicom_root, label_cols),
                "records": records,
            }
        )
    )
    os.replace(tmp, p)  # atomic — avoids the unlocked-cache hazards of the reference
