"""WordPiece tokenizer for radiology reports.

Counterpart of ``mmrp_tpu/data/tokenizer.py``, line for line: BERT-compatible
WordPiece ([PAD]/[UNK]/[CLS]/[SEP] specials, ``##`` continuation pieces,
greedy longest-match) that loads a standard HF ``vocab.txt`` (a run
directory's ``vocab.txt``, or ClinicalBERT's, so that pretrained weights
line up token for token) or trains a vocabulary from a corpus.

``encode`` pads ids and mask to ``max_length``: every batch of a given text
length has one shape.
"""

from __future__ import annotations

import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
_SPECIALS = [PAD, UNK, CLS, SEP, MASK]

_BASIC_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def basic_tokenize(text: str) -> List[str]:
    """Lowercase; split alnum runs and individual punctuation marks."""
    return _BASIC_RE.findall(text.lower())


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], max_input_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    # -- construction --------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        """Load an HF-format vocab.txt (one token per line, line = id)."""
        vocab = {}
        with open(path, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                vocab[line.rstrip("\n")] = i
        return cls(vocab)

    @classmethod
    def train(
        cls,
        corpus: Iterable[str],
        vocab_size: int = 8192,
        min_freq: int = 2,
    ) -> "WordPieceTokenizer":
        """Frequency-based WordPiece vocabulary.

        Whole words ranked by frequency, then suffix pieces mined from the
        remaining tail, plus a full single-character fallback so every string
        tokenizes without UNK explosions.
        """
        word_freq = Counter()
        for text in corpus:
            word_freq.update(basic_tokenize(text))

        vocab: Dict[str, int] = {}
        for tok in _SPECIALS:
            vocab[tok] = len(vocab)
        # character fallback (both word-initial and continuation forms)
        chars = sorted({c for w in word_freq for c in w})
        for c in chars:
            for form in (c, f"##{c}"):
                if form not in vocab:
                    vocab[form] = len(vocab)
        # most frequent whole words
        for w, f in word_freq.most_common():
            if len(vocab) >= vocab_size:
                break
            if f < min_freq:
                break
            if w not in vocab:
                vocab[w] = len(vocab)
        # common continuation pieces (suffixes of length 2-4) from the corpus
        if len(vocab) < vocab_size:
            suffix_freq = Counter()
            for w, f in word_freq.items():
                for L in (2, 3, 4):
                    if len(w) > L:
                        suffix_freq[f"##{w[-L:]}"] += f
            for s, f in suffix_freq.most_common():
                if len(vocab) >= vocab_size:
                    break
                if f >= min_freq and s not in vocab:
                    vocab[s] = len(vocab)
        return cls(vocab)

    def save_vocab(self, path: str) -> None:
        toks = [self.inv_vocab[i] for i in range(len(self.inv_vocab))]
        Path(path).write_text("\n".join(toks) + "\n", encoding="utf-8")

    # -- tokenization ----------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first subword split; [UNK] when impossible."""
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for w in basic_tokenize(text):
            out.extend(self.wordpiece(w))
        return out

    def encode(
        self, text: str, max_length: int = 512
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask), both (max_length,) int32.

        [CLS] tokens... [SEP], truncated then padded — matching the
        reference's padding='max_length' + truncation behavior
        (ChestXRDataset.py:10-33).
        """
        toks = self.tokenize(text)[: max_length - 2]
        ids = (
            [self.cls_id]
            + [self.vocab.get(t, self.unk_id) for t in toks]
            + [self.sep_id]
        )
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.pad_id] * pad
        mask = mask + [0] * pad
        return np.asarray(ids, dtype=np.int32), np.asarray(mask, dtype=np.int32)

    def encode_batch(
        self, texts: Sequence[str], max_length: int = 512
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_length), dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids[i], mask[i] = self.encode(t, max_length)
        return ids, mask

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def load_or_train_tokenizer(
    vocab_path: Optional[str],
    corpus: Optional[Iterable[str]] = None,
    vocab_size: int = 8192,
) -> WordPieceTokenizer:
    """HF vocab.txt when present (ClinicalBERT compatibility), else train."""
    if vocab_path and Path(vocab_path).exists():
        return WordPieceTokenizer.from_vocab_file(vocab_path)
    if corpus is None:
        raise ValueError("no vocab file and no corpus to train from")
    tok = WordPieceTokenizer.train(corpus, vocab_size=vocab_size)
    if vocab_path:
        tok.save_vocab(vocab_path)
    return tok
