"""KG embedding health probes.

Counterpart of ``mmrp_tpu/eval/kg_probe.py``, copied (numpy and the standard
library only; nothing of JAX).

Parity with the reference sanity scripts (reference:
src/Evaluate/kg_check.py, kg_diagnose.py, kg_probe.py): norm statistics,
zero/NaN node detection, label-node coverage, and nearest-neighbor spot
checks over the trained node embeddings.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def embedding_health(embeddings: np.ndarray) -> Dict[str, float]:
    norms = np.linalg.norm(embeddings, axis=1)
    return {
        "n_nodes": int(embeddings.shape[0]),
        "dim": int(embeddings.shape[1]),
        "mean_norm": float(norms.mean()),
        "std_norm": float(norms.std()),
        "n_zero_norm": int((norms < 1e-8).sum()),
        "n_nan": int(np.isnan(embeddings).any(axis=1).sum()),
        "n_inf": int(np.isinf(embeddings).any(axis=1).sum()),
    }


def label_node_coverage(
    node2id: Mapping[str, int], label_names: Sequence[str]
) -> Dict[str, object]:
    missing = [g for g in label_names if f"label:{g}" not in node2id]
    return {
        "n_labels": len(label_names),
        "n_present": len(label_names) - len(missing),
        "missing": missing,
    }


def nearest_neighbors(
    embeddings: np.ndarray,
    node2id: Mapping[str, int],
    probe_nodes: Sequence[str],
    k: int = 5,
) -> Dict[str, List[str]]:
    id2node = {i: n for n, i in node2id.items()}
    n = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-8)
    out: Dict[str, List[str]] = {}
    for name in probe_nodes:
        idx = node2id.get(name)
        if idx is None:
            out[name] = []
            continue
        sims = n @ n[idx]
        sims[idx] = -np.inf
        top = np.argsort(-sims)[:k]
        out[name] = [id2node.get(int(t), str(t)) for t in top]
    return out


def full_probe(
    kg_dir: str,
    label_names: Sequence[str],
    probe_nodes: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
) -> Dict:
    kg = Path(kg_dir)
    emb = np.load(kg / "node_embeddings.npy")
    node2id = json.loads((kg / "node2id.json").read_text())
    report = {
        "health": embedding_health(emb),
        "label_coverage": label_node_coverage(node2id, label_names),
    }
    if probe_nodes:
        report["neighbors"] = nearest_neighbors(emb, node2id, probe_nodes)
    if out_path:
        Path(out_path).write_text(json.dumps(report, indent=1, default=str))
    return report
