"""Streaming embed + retrieve + predict at batch.

Counterpart of ``mmrp_tpu/serve/stream.py``: one serving forward per batch
(``api.serving_forward``, the kernels of the serving route), the exact
gallery top-K on its device-resident embeddings
(``RetrievalEngine.retrieve_batch_device``), per-class calibrated
thresholds, and ``run_stream`` to push a data split of a trained run through
it into ``predictions.jsonl``.

With a ``mesh`` (every rank runs the pipeline over the same loader, its model
on its device) the forward is data-parallel: each rank runs its block of
every batch's rows, the probabilities and embeddings are all-gathered over
the ``dp`` axis, and the top-K runs on the gathered embeddings (over the
engine's sharded gallery when the engine has the mesh), so every rank yields
the rows the single-device stream yields. ``stats["mesh"]`` is the mesh's
shape as JAX prints it.

Compact ingest, finished on the device, as in JAX:

- uint8 (B, H, W[, 1]) windowed pixels -> x / 255;
- uint16 (B, H, W) raw pixels at model resolution with per-sample
  ``window_center`` / ``window_width`` -> ``ops/preprocess.py::
  window_normalize`` (a client that downsamples native pixels clips them to
  the window first, so that the device's clip and normalize commute with
  its resize);
- then (x - 0.5) / 0.5 and 3 channels; float32 NHWC passes through as it is.

Host batches go to the card from pinned memory with ``non_blocking=True``:
a copy from pageable memory would hold the host until it lands, and with it
the dispatch of the next batch.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.data.dataset import ChestXRDataset, build_dataloader
from mmrp_tpu_torch.device import DEFAULT_DEVICE
from mmrp_tpu_torch.ops.preprocess import window_normalize
from mmrp_tpu_torch.parallel.collectives import all_gather_cat
from mmrp_tpu_torch.parallel.mesh import axis_group, mesh_shape, rows_of
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.serve.runner import build_demo_context


class StreamingPipeline:
    def __init__(self, model, engine: Optional[RetrievalEngine] = None,
                 label_names: Optional[Sequence[str]] = None,
                 threshold: "float | np.ndarray" = 0.5, K: int = 10, mesh=None):
        self.model = model
        self.engine = engine
        self.label_names = list(label_names) if label_names else None
        self.threshold = np.asarray(threshold)
        self.K = K
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self._fwd = serving_forward(model)
        # set by run() once the stream is consumed; None until then
        self.stats: Optional[Dict[str, Any]] = None

    _DEVICE_KEYS = ("image", "input_ids", "attention_mask", "window_center", "window_width")

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for key in self._DEVICE_KEYS:
            if key not in batch:
                continue
            arr = np.ascontiguousarray(batch[key])
            if arr.dtype == np.uint16:
                # PyTorch's uint16 has few kernels: the same bytes travel as
                # int16 and widen on the device (_ingest)
                arr = arr.view(np.int16)
            t = torch.from_numpy(arr)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t
        return out

    def _ingest(self, image: torch.Tensor, wc: Optional[torch.Tensor],
                ww: Optional[torch.Tensor], raw16: bool) -> torch.Tensor:
        """A compact batch -> model-ready (B, H, W, 3) f32, on the device."""
        if raw16:
            x = window_normalize((image.int() & 0xFFFF).float(), wc.float(), ww.float())
        elif image.dtype == torch.uint8:
            x = image.float() / 255.0
        else:
            return image
        x = (x - 0.5) / 0.5
        if x.ndim == 3:
            x = x[..., None]
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        return x

    def _dispatch(self, batch: Dict[str, np.ndarray]):
        """Enqueue one batch's device work without a host sync: the forward,
        with an engine the gallery top-K of its embeddings, and the copies of
        the results into pinned host memory, behind which an event is
        recorded. The copies sit on the stream ahead of the next batch's
        forward, so waiting for this event does not wait for that forward."""
        rows = batch
        if self.mesh is not None:  # this rank's block of the rows
            rows = {k: rows_of(np.asarray(batch[k]), self.mesh, "dp")
                    for k in self._DEVICE_KEYS if k in batch}
        tb = self._put(rows)
        image = self._ingest(tb["image"], tb.get("window_center"), tb.get("window_width"),
                             np.asarray(batch["image"]).dtype == np.uint16)
        out = self._fwd(image, tb["input_ids"].long(), tb["attention_mask"].long())
        dev = [out["probs"].float(), out["joint_emb"].float()]
        if self.mesh is not None:
            dev = [self._gather(t) for t in dev]
        if self.engine is not None:
            dev += self.engine.retrieve_batch_device(dev[1], self.K)
        if self.device.type != "cuda":
            return batch, dev, None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in dev]
        for h, t in zip(host, dev):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return batch, host, done

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order (enqueued, no host sync)."""
        return all_gather_cat(t, axis_group(self.mesh, "dp"))

    def _finish(self, batch, host, done) -> Dict[str, Any]:
        """Wait for a dispatched batch's own copies (the only sync), then on
        the host: valid rows, thresholded label sets, retrieval ids."""
        if done is not None:
            done.synchronize()
        probs, emb = host[0].numpy(), host[1].numpy()
        ret = host[2:] or None
        keep = np.asarray(batch.get("valid", np.ones(probs.shape[0]))) > 0
        result: Dict[str, Any] = {
            "probs": probs[keep],
            "joint_emb": emb[keep],
            "ids": [i for i, k in zip(batch.get("ids", []), keep) if k] or None,
        }
        pred = probs[keep] >= self.threshold
        if self.label_names:
            result["predicted"] = [[self.label_names[j] for j in np.where(row)[0]]
                                   for row in pred]
        else:
            result["predicted"] = [np.where(row)[0].tolist() for row in pred]
        if ret is not None:
            s, i = self.engine.finalize_batch(*ret)
            s, i = s[keep], i[keep]
            result["retrieval"] = [
                [(self.engine.ids[int(j)], float(sc)) for j, sc in zip(ri, rs)]
                for ri, rs in zip(i, s)
            ]
        return result

    def process_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One batch -> probs, predicted label sets, joint embeddings and,
        with an engine, the top-K retrieval."""
        return self._finish(*self._dispatch(batch))

    def run(self, loader: Iterable[Dict[str, np.ndarray]],
            depth: int = 2) -> Iterator[Dict[str, Any]]:
        """Stream the loader through the pipeline, yielding per-batch results;
        ``self.stats`` holds the throughput at the end.

        ``depth`` > 1 dispatches batch i+1's device work before it waits
        for batch i's results, so that the card runs batch i+1's forward while
        the host finishes batch i and makes batch i+2 ready; depth 1 is
        strictly serial.
        """
        n = 0
        pending: deque = deque()
        t0 = time.perf_counter()
        for batch in loader:
            pending.append(self._dispatch(batch))
            if len(pending) >= max(1, depth):
                res = self._finish(*pending.popleft())
                n += len(res["probs"])
                yield res
        while pending:
            res = self._finish(*pending.popleft())
            n += len(res["probs"])
            yield res
        dt = time.perf_counter() - t0
        self.stats = {
            "pairs": n,
            "wall_s": dt,
            "pairs_per_sec": n / dt if dt > 0 else 0.0,
            "retrieval": self.engine is not None,
            "depth": depth,
            "mesh": None if self.mesh is None else str(mesh_shape(self.mesh)),
        }


def run_stream(run_dir: str, data_dir: str, split: str = "test",
               out_dir: Optional[str] = None, K: int = 10,
               batch_size: Optional[int] = None, device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """Load a trained run, stream a split of ``data_dir`` through embed +
    retrieve + predict, and write ``predictions.jsonl`` and
    ``stream_stats.json`` (to ``out_dir``, else ``run_dir/stream_{split}``)."""
    ctx = build_demo_context(run_dir, data_dir=data_dir, device=device)
    predictor = ctx["predictor"]
    run = Path(run_dir)
    data = Path(data_dir)

    records = json.loads((data / "records_cache.json").read_text())["records"]
    ids = set(json.loads((data / "splits" / f"{split}_ids.json").read_text()))
    recs = [r for r in records if r["id"] in ids]
    cfg_path = run / "config.yaml"
    cfg = Config.load(str(cfg_path)) if cfg_path.exists() else Config()
    ds = ChestXRDataset(recs, ctx["tokenizer"], max_length=cfg.text_dim,
                        image_size=cfg.image_size)
    loader = build_dataloader(ds, batch_size or cfg.batch_size, shuffle=False, num_workers=2)

    pipe = StreamingPipeline(predictor.model, predictor.retriever, predictor.label_names,
                             predictor.threshold, K=K)
    outp = Path(out_dir) if out_dir else run / f"stream_{split}"
    outp.mkdir(parents=True, exist_ok=True)
    with (outp / "predictions.jsonl").open("w") as fh:
        for res in pipe.run(loader):
            for b, rid in enumerate(res["ids"] or []):
                row = {
                    "id": rid,
                    "predicted": res["predicted"][b],
                    "probs": [round(float(p), 5) for p in res["probs"][b]],
                }
                if "retrieval" in res:
                    row["retrieval"] = res["retrieval"][b]
                fh.write(json.dumps(row) + "\n")
    (outp / "stream_stats.json").write_text(json.dumps(pipe.stats, indent=1))
    return pipe.stats
