"""Retrieval ground truth: label-overlap relevance sets.

Copy of ``mmrp_tpu/eval/gt.py`` (numpy only), which has parity with the
reference GT builder (reference:
src/Helpers/contructGT.py:18-117): for every query id, the relevant set is
every gallery id sharing at least ``min_overlap`` positive labels (Jaccard
or count), computed for the two protocols the eval uses — generalization
(test->test) and historical (test->train).

The reference README additionally claims "retrieval relevance is based on
label overlap AND ontology-aware relationships" (README.md Evaluation
section), but ``contructGT.py`` is pure overlap — no ontology code exists
there. ``ontology_label_adjacency`` + ``label_adjacency=`` implement the
advertised semantics as an opt-in: labels whose mapped ontology terms
coincide (or are declared related, e.g. DOID is_a edges) also count as
shared. Default remains exact reference parity.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np


def ontology_label_adjacency(
    label_names: Sequence[str],
    label2ont: Mapping[str, Sequence[str]],
    related_pairs: Optional[Iterable[Tuple[str, str]]] = None,
) -> np.ndarray:
    """(C, C) bool: labels related through the ontology mapping.

    ``label2ont``: label -> mapped ontology ids (the ``*_label2ontology
    .json`` artifacts written by kg/ontology.py::run_mapper; LOCAL:
    fallback ids count only as self-matches). ``related_pairs``: extra
    ontology-id pairs to treat as related (e.g. DOID is_a edges from
    kg/builder.py's .obo parse). A[i, j] is True when label i and j map
    to the same ontology id or to a declared-related pair; the diagonal
    is always True.
    """
    C = len(label_names)
    rel = {}
    for a, b in related_pairs or ():
        rel.setdefault(a, set()).add(b)
        rel.setdefault(b, set()).add(a)
    mapped = [set(label2ont.get(name, ())) for name in label_names]
    A = np.eye(C, dtype=bool)
    for i in range(C):
        for j in range(i + 1, C):
            hit = bool(mapped[i] & mapped[j]) or any(
                o in rel and mapped[j] & rel[o] for o in mapped[i]
            )
            A[i, j] = A[j, i] = hit
    return A


def build_label_overlap_gt(
    query_ids: Sequence[str],
    query_labels: np.ndarray,  # (Q, C) binary
    gallery_ids: Sequence[str],
    gallery_labels: np.ndarray,  # (G, C)
    min_shared: int = 1,
    exclude_self: bool = True,
    out_path: Optional[str] = None,
    label_adjacency: Optional[np.ndarray] = None,  # (C, C) bool, opt-in
) -> Dict[str, List[str]]:
    Q = np.asarray(query_labels, bool)
    G = np.asarray(gallery_labels, bool)
    if label_adjacency is not None:
        # ontology-aware: query label c counts as shared when the gallery
        # item has any label related to c. Relatedness is undirected, so
        # the matrix is symmetrized first (a caller passing raw directed
        # edges, e.g. child->parent is_a, still gets both directions).
        # (G @ A)[j, c] = #gallery-j labels related to c; >0 means gallery
        # j covers label c; Q @ cover.T counts covered query labels.
        A = np.asarray(label_adjacency, bool)
        A = (A | A.T).astype(np.int32)
        Gx = G.astype(np.int32) @ A.T
        shared = Q.astype(np.int32) @ (Gx > 0).astype(np.int32).T
    else:
        shared = Q.astype(np.int32) @ G.astype(np.int32).T  # (Q, G) shared positives
    gt: Dict[str, List[str]] = {}
    garr = np.asarray(gallery_ids)
    for i, qid in enumerate(query_ids):
        rel = shared[i] >= min_shared
        ids = garr[rel].tolist()
        if exclude_self and qid in ids:
            ids.remove(qid)
        gt[qid] = ids
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(gt))
    return gt
