"""Dataset + fixed-shape batching for the joint image-text model.

Counterpart of ``mmrp_tpu/data/dataset.py`` (numpy only), with its
conventions:

- images are NHWC float32 (B, H, W, 3), the layout the port's models take;
- every batch has identical shapes (fixed batch size, fixed text length; the
  final short batch is padded and carries a ``valid`` mask);
- weighted sampling is host-side inverse-frequency index sampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from mmrp_tpu_torch.data.dicom import DICOMImagePreprocessor
from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer


@dataclass
class ChestXRDataset:
    """records -> per-sample dict {image, input_ids, attention_mask, labels, id}."""

    records: Sequence[dict]
    tokenizer: WordPieceTokenizer
    max_length: int = 512
    image_size: int = 224
    preprocessor: Optional[DICOMImagePreprocessor] = None

    def __post_init__(self) -> None:
        if self.preprocessor is None:
            self.preprocessor = DICOMImagePreprocessor(
                output_size=(self.image_size, self.image_size)
            )
        self.max_length = min(self.max_length, 512)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        chw = self.preprocessor.load(rec["dicom_path"])  # (3, H, W)
        image = np.transpose(chw, (1, 2, 0)).astype(np.float32)  # NHWC
        ids, mask = self.tokenizer.encode(rec["report_text"], self.max_length)
        return {
            "image": image,
            "input_ids": ids,
            "attention_mask": mask,
            "labels": np.asarray(rec["labels"], dtype=np.float32),
            "id": rec["id"],
        }


def inverse_frequency_weights(labels: np.ndarray, clamp_max: float = 20.0) -> np.ndarray:
    """Per-sample weights = mean over positive classes of 1/freq(class).

    Mirrors the reference's inverse-frequency WeightedRandomSampler input
    (train.py:421-442): rarer labels -> more frequently sampled rows.
    Label-free rows get weight 1.0.
    """
    labels = np.asarray(labels, dtype=np.float64)
    n = labels.shape[0]
    class_freq = labels.sum(axis=0) / max(n, 1)
    inv = np.where(class_freq > 0, 1.0 / np.maximum(class_freq, 1e-12), 0.0)
    inv = np.minimum(inv, clamp_max)
    pos_counts = labels.sum(axis=1)
    w = np.where(
        pos_counts > 0,
        (labels * inv[None, :]).sum(axis=1) / np.maximum(pos_counts, 1),
        1.0,
    )
    # normalize to mean 1 for stable expected epoch size
    return (w / w.mean()).astype(np.float64)


def pos_weight_from_labels(labels: np.ndarray, clamp_max: float = 1.0) -> np.ndarray:
    """BCE pos_weight = neg/pos per class, clamped to [1, clamp_max]
    (train.py:463-468; the min=1 clamp is train.py:466 — classes more
    prevalent than 50% must not get their positives DOWN-weighted).

    Classes with zero positives get 1.0 (reference yields clamp_max via
    inf-then-clamp; the value is moot either way — BCE pos_weight only
    scales positive-target terms, which such a class never has)."""
    labels = np.asarray(labels, dtype=np.float64)
    pos = labels.sum(axis=0)
    neg = labels.shape[0] - pos
    pw = np.where(pos > 0, neg / np.maximum(pos, 1), 1.0)
    pw = np.maximum(pw, 1.0)
    return np.minimum(pw, clamp_max).astype(np.float32) if clamp_max else pw.astype(np.float32)


class BatchIterator:
    """Fixed-shape batches with optional weighted sampling.

    Every batch is exactly ``batch_size``; when sampling without replacement
    the final partial batch is padded by repeating row 0 and flagged via the
    ``valid`` mask so metrics/losses can exclude padding.
    """

    def __init__(
        self,
        dataset: ChestXRDataset,
        batch_size: int,
        shuffle: bool = True,
        weights: Optional[np.ndarray] = None,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 0,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.weights = weights
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.ds)
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.weights is not None:
            p = self.weights / self.weights.sum()
            return rng.choice(n, size=n, replace=True, p=p)
        idx = np.arange(n)
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        self._epoch += 1
        B = self.batch_size
        # per-sample decode (DICOM parse + window + resize) is the IO/CPU
        # hot path — fan it out over a thread pool when num_workers > 1
        pool = None
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            for start in range(0, len(idx), B):
                chunk = idx[start : start + B]
                if len(chunk) < B:
                    if self.drop_last:
                        return
                    pad = np.zeros(B - len(chunk), dtype=chunk.dtype)
                    valid = np.concatenate(
                        [np.ones(len(chunk), np.float32), np.zeros(len(pad), np.float32)]
                    )
                    chunk = np.concatenate([chunk, pad])
                else:
                    valid = np.ones(B, np.float32)
                rows = [int(i) for i in chunk]
                if pool is not None:
                    samples = list(pool.map(self.ds.__getitem__, rows))
                else:
                    samples = [self.ds[i] for i in rows]
                yield {
                    "image": np.stack([s["image"] for s in samples]),
                    "input_ids": np.stack([s["input_ids"] for s in samples]),
                    "attention_mask": np.stack([s["attention_mask"] for s in samples]),
                    "labels": np.stack([s["labels"] for s in samples]),
                    "valid": valid,
                    "ids": [s["id"] for s in samples],
                }
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def build_dataloader(
    dataset: ChestXRDataset,
    batch_size: int,
    shuffle: bool = True,
    weighted: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    num_workers: int = 0,
) -> "BatchIterator":
    """Factory mirroring reference build_dataloader (dataLoader.py:10-62).

    ``num_workers > 0`` decodes each batch's samples on a thread pool AND
    wraps the iterator in the prefetch queue of ``data/pipeline.py``.
    """
    weights = None
    if weighted:
        labels = np.stack([np.asarray(r["labels"], np.float32) for r in dataset.records])
        weights = inverse_frequency_weights(labels)
    it = BatchIterator(
        dataset, batch_size, shuffle=shuffle, weights=weights, seed=seed,
        drop_last=drop_last, num_workers=num_workers,
    )
    if num_workers > 0:
        from mmrp_tpu_torch.data.pipeline import PrefetchLoader

        return PrefetchLoader(it, num_workers=num_workers)
    return it
