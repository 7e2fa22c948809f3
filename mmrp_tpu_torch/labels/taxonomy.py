"""Label taxonomy for OpenI chest X-ray weak labeling.

Counterpart of ``mmrp_tpu/labels/taxonomy.py`` (numpy and json only), with
its own copy of ``taxonomy.json``: the 43 active label groups (19 disease +
1 normal + 19 finding + 4 symptom) and their keyword phrase lists. Auxiliary
categories (device, technical, anatomy, metadata, ...) are retained but are
not part of the classifier label space.

Canonical column order is ``disease keys + normal keys + finding keys +
symptom keys`` in taxonomy insertion order: ``LABEL_COLS`` is the JAX
package's list, name for name and in the same order, and it is the order of
every label vector, threshold vector and classifier output of the port.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

_TAXONOMY_PATH = Path(__file__).parent / "taxonomy.json"

# Category order that defines the 43-class label space.
_ACTIVE_ORDER = ("disease", "normal", "finding", "symptom")


@dataclass(frozen=True)
class LabelTaxonomy:
    """Immutable view over the label taxonomy."""

    categories: Mapping[str, Mapping[str, Sequence[str]]]

    @property
    def label_cols(self) -> List[str]:
        """43 active group names in canonical order."""
        cols: List[str] = []
        for cat in _ACTIVE_ORDER:
            cols.extend(self.categories[cat].keys())
        return cols

    @property
    def num_classes(self) -> int:
        return len(self.label_cols)

    def combined_groups(self) -> Dict[str, List[str]]:
        """group -> keyword phrases for all active categories (labeler input)."""
        out: Dict[str, List[str]] = {}
        for cat in _ACTIVE_ORDER:
            for group, kws in self.categories[cat].items():
                out[group] = list(kws)
        return out

    def category_of(self, group: str) -> str:
        for cat, groups in self.categories.items():
            if group in groups:
                return cat
        raise KeyError(group)

    def groups_in(self, category: str) -> List[str]:
        return list(self.categories[category].keys())


@lru_cache(maxsize=1)
def get_taxonomy() -> LabelTaxonomy:
    with open(_TAXONOMY_PATH, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    # JSON objects preserve insertion order, but the asset is written with
    # sort_keys for stable diffs; enforce canonical group order explicitly.
    cats = {cat: dict(groups) for cat, groups in raw["categories"].items()}
    return LabelTaxonomy(categories=cats)


# Convenience module-level constants (computed once at import).
LABEL_COLS: List[str] = get_taxonomy().label_cols
NUM_CLASSES: int = len(LABEL_COLS)
