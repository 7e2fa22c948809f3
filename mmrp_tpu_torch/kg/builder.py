"""Knowledge-graph construction: dataset triples + ontologies.

Copy of ``mmrp_tpu/kg/builder.py`` (numpy only; the taxonomy from the port's
``labels/``), which has parity with the reference KGBuilder (reference:
src/KnowledgeGraph/KG_Builder.py:18-463):

- dataset mode: per record, ``report:<id> -REPORT_OF-> image:<id>`` plus
  ``report -HAS_<CATEGORY>-> label:<group>`` edges for each positive label
  (KG_Builder.py:79-136), with optional global image-feature extraction for
  entity initialization (:92-157, stored npz instead of .pt);
- ontology mode: DOID .obo parsing (is_a / synonym / xref, :215-290) and
  RadLex .owl parsing (subClassOf / preferredName, :292-336);
- hybrid mode: both + label->ontology mapping edges (:434-440);
- curated CSV triples (:339-374);
- artifacts: triples.csv (s_id, r_id, o_id, confidence, source) +
  node2id/relation2id/entity_meta JSONs (:393-406), with ensure_exists
  caching (:450-463) and atomic writes.
"""

from __future__ import annotations

import csv
import json
import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmrp_tpu_torch.labels import get_taxonomy

CATEGORY_RELATION = {
    "disease": "HAS_DISEASE",
    "finding": "HAS_FINDING",
    "symptom": "HAS_SYMPTOM",
    "normal": "HAS_NORMAL",
}


@dataclass
class KGBuilder:
    out_dir: str
    mode: str = "hybrid"  # dataset | ontology | hybrid

    nodes: Dict[str, int] = field(default_factory=dict)
    relations: Dict[str, int] = field(default_factory=dict)
    triples: List[Tuple[int, int, int, float, str]] = field(default_factory=list)
    entity_meta: Dict[str, dict] = field(default_factory=dict)

    def node(self, name: str, ntype: Optional[str] = None) -> int:
        if name not in self.nodes:
            self.nodes[name] = len(self.nodes)
            if ntype:
                self.entity_meta[name] = {"type": ntype}
        return self.nodes[name]

    def relation(self, name: str) -> int:
        if name not in self.relations:
            self.relations[name] = len(self.relations)
        return self.relations[name]

    def add(self, s: str, r: str, o: str, conf: float = 1.0, source: str = "extracted",
            s_type: Optional[str] = None, o_type: Optional[str] = None) -> None:
        self.triples.append(
            (self.node(s, s_type), self.relation(r), self.node(o, o_type), conf, source)
        )

    # -- dataset triples -------------------------------------------------------

    def build_from_records(
        self,
        records: Sequence[dict],
        label_cols: Optional[Sequence[str]] = None,
        feature_extractor: Optional[Callable[[dict], np.ndarray]] = None,
    ) -> None:
        """records: parse_openi_xml output. feature_extractor(record) ->
        global image vector (saved to kg_image_feats.npz, keyed by node)."""
        if label_cols is None:
            from mmrp_tpu_torch.labels import LABEL_COLS

            label_cols = LABEL_COLS
        tax = get_taxonomy()
        cat_of = {g: tax.category_of(g) for g in label_cols}
        feats: Dict[str, np.ndarray] = {}
        for rec in records:
            rid = rec["id"]
            report, image = f"report:{rid}", f"image:{rid}"
            self.add(report, "REPORT_OF", image, 1.0, "extracted",
                     s_type="report", o_type="image")
            for g, on in zip(label_cols, rec["labels"]):
                if on:
                    rel = CATEGORY_RELATION.get(cat_of[g], "HAS_FINDING")
                    self.add(report, rel, f"label:{g}", 1.0, "extracted",
                             s_type="report", o_type="label")
            if feature_extractor is not None:
                try:
                    feats[image] = np.asarray(feature_extractor(rec), np.float32)
                except (ValueError, OSError) as e:
                    print(f"[KGBuilder] feature extraction failed for {rid}: {e}")
        if feats:
            out = Path(self.out_dir)
            out.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(
                out / "kg_image_feats.npz",
                **{k: v for k, v in feats.items()},
            )

    # -- ontologies ---------------------------------------------------------------

    def add_doid_obo(self, obo_path: str, max_terms: Optional[int] = None) -> int:
        """Parse a DOID .obo file: [Term] stanzas with id/name/is_a/synonym/
        xref (KG_Builder.py:215-290). Returns #terms parsed."""
        n = 0
        term: Dict[str, List[str]] = {}
        in_term = False

        def flush():
            nonlocal n
            tid = term.get("id", [None])[0]
            if not tid or term.get("is_obsolete", ["false"])[0] == "true":
                return
            node = f"doid:{tid}"
            name = term.get("name", [""])[0]
            self.node(node, "ontology")
            if name:
                self.entity_meta[node] = {"type": "ontology", "name": name}
            for parent in term.get("is_a", []):
                pid = parent.split("!")[0].strip()
                self.add(node, "IS_A", f"doid:{pid}", 1.0, "doid",
                         s_type="ontology", o_type="ontology")
            for syn in term.get("synonym", []):
                m = re.match(r'"([^"]+)"', syn)
                if m:
                    self.add(node, "SYNONYM", f"synonym:{m.group(1).lower()}",
                             0.9, "doid", s_type="ontology", o_type="synonym")
            for xref in term.get("xref", []):
                self.add(node, "XREF", f"xref:{xref.strip()}", 0.8, "doid",
                         s_type="ontology", o_type="xref")
            n += 1

        with open(obo_path, "r", encoding="utf-8", errors="ignore") as fh:
            for line in fh:
                line = line.strip()
                if line == "[Term]":
                    if in_term:
                        flush()
                    term, in_term = {}, True
                    if max_terms and n >= max_terms:
                        in_term = False
                        break
                elif line.startswith("[") and line.endswith("]"):
                    if in_term:
                        flush()
                    in_term = False
                elif in_term and ":" in line:
                    k, _, v = line.partition(":")
                    term.setdefault(k.strip(), []).append(v.strip())
        if in_term:
            flush()
        return n

    def add_radlex_owl(self, owl_path: str) -> int:
        """Parse RadLex OWL: classes with subClassOf + labels
        (KG_Builder.py:292-336). Namespace-agnostic tag matching."""
        n = 0
        tree = ET.parse(owl_path)

        def local(tag: str) -> str:
            return tag.rsplit("}", 1)[-1]

        for el in tree.getroot().iter():
            if local(el.tag) != "Class":
                continue
            about = None
            for k, v in el.attrib.items():
                if local(k) in ("about", "ID"):
                    about = v.rsplit("/", 1)[-1].rsplit("#", 1)[-1]
            if not about:
                continue
            node = f"radlex:{about}"
            self.node(node, "ontology")
            for child in el:
                tag = local(child.tag)
                if tag == "subClassOf":
                    ref = None
                    for k, v in child.attrib.items():
                        if local(k) == "resource":
                            ref = v.rsplit("/", 1)[-1].rsplit("#", 1)[-1]
                    if ref:
                        self.add(node, "IS_A", f"radlex:{ref}", 1.0, "radlex",
                                 s_type="ontology", o_type="ontology")
                elif tag in ("label", "preferredName", "Preferred_name"):
                    if child.text:
                        self.entity_meta[node] = {
                            "type": "ontology",
                            "name": child.text.strip(),
                        }
            n += 1
        return n

    def add_label_ontology_mapping(self, mapping: Dict[str, str], source="mapping"):
        """label group -> ontology id edges (KG_Builder.py:434-440)."""
        for group, onto_id in mapping.items():
            if onto_id and onto_id != "LOCAL:":
                self.add(f"label:{group}", "MAPS_TO", onto_id, 1.0, source,
                         s_type="label", o_type="ontology")

    def add_curated_csv(self, csv_path: str) -> int:
        """Curated triples CSV with columns s,r,o[,confidence]
        (KG_Builder.py:339-374)."""
        n = 0
        with open(csv_path, newline="", encoding="utf-8") as fh:
            for row in csv.DictReader(fh):
                conf = float(row.get("confidence", 1.0) or 1.0)
                self.add(row["s"], row["r"], row["o"], conf, "curated")
                n += 1
        return n

    # -- persistence -----------------------------------------------------------------

    def save(self) -> None:
        out = Path(self.out_dir)
        out.mkdir(parents=True, exist_ok=True)

        def atomic_write(path: Path, text: str):
            tmp = path.with_suffix(path.suffix + ".tmp")
            tmp.write_text(text)
            os.replace(tmp, path)

        lines = ["s_id,r_id,o_id,confidence,source"]
        for s, r, o, c, src in self.triples:
            lines.append(f"{s},{r},{o},{c},{src}")
        atomic_write(out / "triples.csv", "\n".join(lines))
        atomic_write(out / "node2id.json", json.dumps(self.nodes, indent=1))
        atomic_write(out / "relation2id.json", json.dumps(self.relations, indent=1))
        atomic_write(out / "entity_meta.json", json.dumps(self.entity_meta, indent=1))

    @classmethod
    def load(cls, out_dir: str) -> "KGBuilder":
        out = Path(out_dir)
        b = cls(out_dir=out_dir)
        b.nodes = json.loads((out / "node2id.json").read_text())
        b.relations = json.loads((out / "relation2id.json").read_text())
        meta_p = out / "entity_meta.json"
        if meta_p.exists():
            b.entity_meta = json.loads(meta_p.read_text())
        with (out / "triples.csv").open(newline="") as fh:
            for row in csv.DictReader(fh):
                b.triples.append(
                    (
                        int(row["s_id"]),
                        int(row["r_id"]),
                        int(row["o_id"]),
                        float(row["confidence"]),
                        row["source"],
                    )
                )
        return b

    def exists(self) -> bool:
        out = Path(self.out_dir)
        return all(
            (out / f).exists()
            for f in ("triples.csv", "node2id.json", "relation2id.json")
        )

    def ensure_exists(self, build_fn: Callable[["KGBuilder"], None]) -> "KGBuilder":
        """Cache pattern (KG_Builder.py:450-463): reuse artifacts if present."""
        if self.exists():
            return KGBuilder.load(self.out_dir)
        build_fn(self)
        self.save()
        return self

    def triple_arrays(self):
        arr = np.asarray([(s, r, o) for s, r, o, _, _ in self.triples], np.int32)
        conf = np.asarray([c for _, _, _, c, _ in self.triples], np.float32)
        src = [s for *_, s in self.triples]
        return arr, conf, src
