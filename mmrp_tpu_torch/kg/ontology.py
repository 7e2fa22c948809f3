"""Ontology mapping: free-text labels -> DOID / RadLex / SNOMED ids.

Counterpart of ``mmrp_tpu/kg/ontology.py``, copied (numpy and the standard
library only; nothing of JAX).

Parity with the reference OntologyMapper (reference:
src/KnowledgeGraph/ontology_mapper.py:25-325) with its resolution cascade:

    exact dictionary -> fuzzy match (difflib ratio >= 0.8) -> BioPortal REST
    -> LLM normalization -> ``LOCAL:<name>`` fallback

All network stages are **pluggable and offline-optional**: they are
callables injected at construction (the environment has zero egress; the
reference called BioPortal/Gemini directly with API-key rotation,
ontology_mapper.py:59-65,149-224). Lookups are cached to JSON with atomic
writes (the reference writes its caches unlocked, SURVEY §5.2).
"""

from __future__ import annotations

import difflib
import json
import os
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple


class OntologyMapper:
    def __init__(
        self,
        known: Optional[Dict[str, str]] = None,
        cache_path: Optional[str] = None,
        fuzzy_threshold: float = 0.8,
        bioportal_lookup: Optional[Callable[[str], Optional[str]]] = None,
        llm_normalize: Optional[Callable[[str], Optional[str]]] = None,
    ):
        self.known = {k.lower(): v for k, v in (known or {}).items()}
        self.cache_path = cache_path
        self.fuzzy_threshold = fuzzy_threshold
        self.bioportal_lookup = bioportal_lookup
        self.llm_normalize = llm_normalize
        self.cache: Dict[str, str] = {}
        self.stats = {"exact": 0, "fuzzy": 0, "bioportal": 0, "llm": 0, "local": 0, "cached": 0}
        if cache_path and Path(cache_path).exists():
            try:
                self.cache = json.loads(Path(cache_path).read_text())
            except (json.JSONDecodeError, OSError):
                self.cache = {}

    def _save_cache(self) -> None:
        if not self.cache_path:
            return
        p = Path(self.cache_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.cache, indent=1))
        os.replace(tmp, p)

    def map_label(self, label: str) -> str:
        key = label.lower().strip()
        if key in self.cache:
            self.stats["cached"] += 1
            return self.cache[key]

        result = None
        if key in self.known:
            result = self.known[key]
            self.stats["exact"] += 1
        if result is None and self.known:
            match = difflib.get_close_matches(
                key, list(self.known), n=1, cutoff=self.fuzzy_threshold
            )
            if match:
                result = self.known[match[0]]
                self.stats["fuzzy"] += 1
        if result is None and self.bioportal_lookup is not None:
            try:
                result = self.bioportal_lookup(key)
                if result:
                    self.stats["bioportal"] += 1
            except Exception as e:  # network stage: degrade, don't die
                print(f"[OntologyMapper] bioportal failed for {key!r}: {e}")
                result = None
        if result is None and self.llm_normalize is not None:
            try:
                normalized = self.llm_normalize(key)
                if normalized and normalized.lower() in self.known:
                    result = self.known[normalized.lower()]
                    self.stats["llm"] += 1
            except Exception as e:
                print(f"[OntologyMapper] llm normalize failed for {key!r}: {e}")
        if result is None:
            result = f"LOCAL:{key}"  # reference fallback (ontology_mapper.py:232-283)
            self.stats["local"] += 1

        self.cache[key] = result
        self._save_cache()
        return result

    def map_groups(
        self, groups: Dict[str, Iterable[str]]
    ) -> Dict[str, Dict[str, str]]:
        """Map every group's keywords -> {group: {keyword: ontology_id}};
        the runner saves one JSON per category (mapper_runner.py:30-49)."""
        return {g: {kw: self.map_label(kw) for kw in kws} for g, kws in groups.items()}

    def coverage_report(self) -> Dict[str, float]:
        total = sum(self.stats.values())
        mapped = total - self.stats["local"]
        return {
            "total": total,
            "mapped_frac": mapped / total if total else 0.0,
            **self.stats,
        }


def bioportal_lookup_from_env(
    ontology: str = "SNOMEDCT",
    env_var: str = "BIOPORTAL_API_KEY",
    retries: int = 3,
) -> Optional[Callable[[str], Optional[str]]]:
    """Concrete BioPortal REST adapter for ``OntologyMapper``.

    Reference protocol (ontology_mapper.py:108-148): GET
    ``data.bioontology.org/search?q=<term>&ontologies=<onto>&apikey=…``
    and take the first collection entry's ``@id``. Uses stdlib urllib
    (zero extra deps), exponential backoff on transient failures, and NO
    internal cache — OntologyMapper already caches every stage's result
    atomically. Returns None when the env key is absent (offline mode)."""
    key = os.environ.get(env_var, "").strip()
    if not key:
        return None
    import time
    import urllib.parse
    import urllib.request

    def lookup(term: str) -> Optional[str]:
        params = urllib.parse.urlencode(
            {"q": term, "ontologies": ontology, "apikey": key})
        url = f"https://data.bioontology.org/search?{params}"
        last: Optional[Exception] = None
        for attempt in range(retries):
            try:
                with urllib.request.urlopen(url, timeout=10) as resp:
                    data = json.loads(resp.read().decode("utf-8"))
                coll = data.get("collection") or []
                return coll[0].get("@id") if coll else None
            except Exception as e:  # noqa: BLE001 — backoff and retry
                last = e
                time.sleep(min(60.0, 2.0 * (2 ** attempt)))
        raise RuntimeError(f"BioPortal lookup failed for {term!r}: {last}")

    return lookup


def gemini_normalize_from_env(
    model: str = "gemini-2.5-flash",
    env_var: str = "GEMINI_KEYS",
) -> Optional[Callable[[str], Optional[str]]]:
    """Concrete LLM-normalization adapter for ``OntologyMapper``.

    Wraps the rotating-key Gemini client (data/verify.py::
    gemini_client_from_env — key rotation + dead-key eviction, the
    reference's scheme at ontology_mapper.py:149-224) with the
    reference's terminology-normalization prompt. Returns None when keys
    or the SDK are absent (offline mode)."""
    from mmrp_tpu_torch.data.verify import gemini_client_from_env

    complete = gemini_client_from_env(model=model, env_var=env_var)
    if complete is None:
        return None

    def normalize(term: str) -> Optional[str]:
        prompt = (
            "You are a clinical terminology assistant. Given the following "
            "free-text label, return the closest canonical disease/finding "
            "name from standard ontologies (SNOMED CT, DOID, or RadLex). "
            "Respond ONLY with the cleaned term, no explanation.\n\n"
            "Return ONLY the exact SNOMED CT preferred term for the "
            f"following clinical finding.\n\nLabel: {term}"
        )
        cleaned = complete(prompt).strip()
        return cleaned or None

    return normalize


def run_mapper(
    out_dir: str,
    mapper: Optional[OntologyMapper] = None,
    categories: Tuple[str, ...] = ("disease", "finding", "symptom", "normal"),
) -> Dict[str, str]:
    """CLI-equivalent of the reference mapper_runner (mapper_runner.py:30-49):
    map all active label groups, save one ``<cat>_label2ontology.json`` per
    category, log unmapped keywords."""
    from mmrp_tpu_torch.labels import get_taxonomy

    tax = get_taxonomy()
    # live network stages activate automatically when their env keys exist
    # (BIOPORTAL_API_KEY / GEMINI_KEYS); otherwise they stay None and the
    # cascade ends at the LOCAL: fallback — same CLI, both environments
    mapper = mapper or OntologyMapper(
        cache_path=str(Path(out_dir) / "onto_cache.json"),
        bioportal_lookup=bioportal_lookup_from_env(),
        llm_normalize=gemini_normalize_from_env(),
    )
    written = {}
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for cat in categories:
        groups = {g: tax.categories[cat][g] for g in tax.groups_in(cat)}
        mapping = mapper.map_groups(groups)
        path = out / f"{cat}_label2ontology.json"
        path.write_text(json.dumps(mapping, indent=1))
        written[cat] = str(path)
        unmapped = [
            kw
            for g in mapping.values()
            for kw, v in g.items()
            if v.startswith("LOCAL:")
        ]
        if unmapped:
            print(f"[mapper] {cat}: {len(unmapped)} unmapped keywords")
    return written
