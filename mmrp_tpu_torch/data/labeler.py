"""Weak labeling: phrase matching with negation over radiology reports.

Counterpart of ``mmrp_tpu/data/labeler.py``, copied (numpy and the standard
library only; nothing of JAX).

The reference pipes every report through SciSpaCy + a PhraseMatcher + the
negspacy NegEx component (reference: src/DataHandler/dataParser.py:18-90).
This framework owns the whole path with a dependency-free implementation:

- a lightweight clinical tokenizer (lowercase, alnum word chunks, sentence
  boundaries on ./;/:),
- a first-token-indexed multi-word phrase matcher (longest-match greedy,
  case-insensitive — equivalent to PhraseMatcher(attr="LOWER")),
- a NegEx-style negation detector: pre-/post-negation triggers scoped to the
  sentence, terminated by conjunctions, so "no pneumothorax" does not light
  the air_leak label (parity target: negspacy's Negex over MATCH entities,
  dataParser.py:37-42,62-66).

Matching is host-side (CPU) and cached by the pipeline; the reference
re-parses the corpus up to 4 times per run (SURVEY §3.1) — here the parse is
done once and keyed by content hash.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from mmrp_tpu_torch.labels import get_taxonomy

_WORD_RE = re.compile(r"[a-z0-9]+(?:[-'][a-z0-9]+)*")
_SENT_SPLIT_RE = re.compile(r"[.;:]|\n\n")

# NegEx-style trigger sets (subset of the standard clinical termset used by
# negspacy; pre-triggers negate following terms, post-triggers negate
# preceding terms within the same sentence).
PRE_NEGATION_TRIGGERS: Tuple[Tuple[str, ...], ...] = (
    ("no",), ("not",), ("without",), ("denies",), ("denied",), ("deny",),
    ("negative", "for"), ("free", "of"), ("clear", "of"), ("absence", "of"),
    ("absent",), ("rules", "out"), ("ruled", "out"), ("rule", "out"),
    ("no", "evidence", "of"), ("no", "evidence", "for"), ("no", "sign", "of"),
    ("no", "signs", "of"), ("no", "suspicious",), ("never", "had"),
    ("resolved",), ("resolution", "of"), ("cannot", "see"), ("unremarkable", "for"),
)
POST_NEGATION_TRIGGERS: Tuple[Tuple[str, ...], ...] = (
    ("unlikely",), ("is", "ruled", "out"), ("are", "ruled", "out"),
    ("was", "ruled", "out"), ("not", "seen"), ("not", "identified"),
    ("is", "excluded"), ("free",),
)
# Words that terminate a negation scope (pseudo-conjunctions).
SCOPE_TERMINATORS = {
    "but", "however", "although", "though", "except", "yet", "apart",
    "aside", "nevertheless", "still", "otherwise", "which", "secondary",
}
_MAX_NEG_SCOPE = 8  # tokens a pre-trigger reaches, bounded like NegEx


def tokenize_words(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def split_sentences(text: str) -> List[str]:
    return [s for s in _SENT_SPLIT_RE.split(text) if s.strip()]


@dataclass(frozen=True)
class PhraseMatch:
    group: str
    phrase: str
    start: int  # token index within sentence
    end: int    # exclusive
    negated: bool


class PhraseLabeler:
    """Multi-word phrase matcher + negation over a group->phrases mapping."""

    def __init__(self, combined_groups: Optional[Mapping[str, Sequence[str]]] = None):
        if combined_groups is None:
            combined_groups = get_taxonomy().combined_groups()
        self.groups: List[str] = list(combined_groups.keys())
        # first-token index: token -> [(phrase_tokens, group)]
        self._index: Dict[str, List[Tuple[Tuple[str, ...], str]]] = {}
        for group, phrases in combined_groups.items():
            for phrase in phrases:
                toks = tuple(tokenize_words(phrase))
                if not toks:
                    continue
                self._index.setdefault(toks[0], []).append((toks, group))
        # longest candidates first -> greedy longest match
        for cands in self._index.values():
            cands.sort(key=lambda c: -len(c[0]))

    # -- matching -----------------------------------------------------------

    def match_sentence(self, tokens: Sequence[str]) -> List[PhraseMatch]:
        negated_spans = _negated_spans(tokens)
        matches: List[PhraseMatch] = []
        i = 0
        n = len(tokens)
        while i < n:
            cands = self._index.get(tokens[i])
            matched_len = 0
            if cands:
                for phrase_toks, group in cands:
                    L = len(phrase_toks)
                    if i + L <= n and tuple(tokens[i : i + L]) == phrase_toks:
                        neg = any(s <= i < e for s, e in negated_spans)
                        matches.append(
                            PhraseMatch(group, " ".join(phrase_toks), i, i + L, neg)
                        )
                        matched_len = L
                        break  # longest match for this start position
            i += matched_len or 1
        return matches

    def label_report(self, text: str) -> Dict[str, int]:
        """group -> 0/1; a group fires iff any of its phrases matches
        un-negated anywhere in the report (dataParser.py:47-68 semantics)."""
        labels = {g: 0 for g in self.groups}
        for sent in split_sentences(text):
            for m in self.match_sentence(tokenize_words(sent)):
                if not m.negated:
                    labels[m.group] = 1
        return labels

    def label_vector(self, text: str, label_cols: Optional[Sequence[str]] = None) -> List[int]:
        """Binary vector in canonical LABEL_COLS order (see labels.taxonomy)."""
        if label_cols is None:
            from mmrp_tpu_torch.labels import LABEL_COLS

            label_cols = LABEL_COLS
        labels = self.label_report(text)
        return [labels.get(g, 0) for g in label_cols]

    def matches(self, text: str) -> List[PhraseMatch]:
        out = []
        for sent in split_sentences(text):
            out.extend(self.match_sentence(tokenize_words(sent)))
        return out


def _negated_spans(tokens: Sequence[str]) -> List[Tuple[int, int]]:
    """Token index ranges covered by a negation trigger's scope."""
    spans: List[Tuple[int, int]] = []
    n = len(tokens)
    for i in range(n):
        # pre-triggers: scope forward until terminator or window end
        for trig in PRE_NEGATION_TRIGGERS:
            L = len(trig)
            if i + L <= n and tuple(tokens[i : i + L]) == trig:
                end = min(n, i + L + _MAX_NEG_SCOPE)
                for j in range(i + L, end):
                    if tokens[j] in SCOPE_TERMINATORS:
                        end = j
                        break
                spans.append((i + L, end))
                break
        # post-triggers: scope backward to sentence start or terminator
        for trig in POST_NEGATION_TRIGGERS:
            L = len(trig)
            if i + L <= n and tuple(tokens[i : i + L]) == trig:
                start = max(0, i - _MAX_NEG_SCOPE)
                for j in range(i - 1, start - 1, -1):
                    if tokens[j] in SCOPE_TERMINATORS:
                        start = j + 1
                        break
                spans.append((start, i))
                break
    return spans
