"""The joint stage of the training pipeline: train loop, validation,
checkpoints and resume; and the gallery embedding dump.

Counterpart of ``mmrp_tpu/train/pipeline.py`` on one card (no mesh):

- ``pos_weight`` from the training labels, clamped at
  ``cfg.pos_weight_clamp_max``;
- per epoch: ``make_train_step`` over the (weighted) train loader, then the
  validation pass (``make_eval_step`` with the text-to-image attention),
  per-class F1-optimal thresholds and the composite 0.5 * macro F1 + 0.5 *
  macro AUROC; on a better composite the best artifacts
  (``val_embeddings.npy``, ``val_attention.npy``, ``val_ids.json``,
  ``thresholds.npy``, ``val_per_class.json``) and the best model checkpoint
  (``ckpt/best``); every epoch the full train state (``ckpt/steps/<epoch>``);
  early stop after ``cfg.patience`` epochs without a better composite;
- ``cfg.resume`` with a full-state checkpoint continues after its epoch:
  masters, Adam's moments and count, the step generator's seed, step, epoch,
  ``bad`` and the best so far, and the loader's ``_epoch`` (its data order);
- ``best_multimodal_metrics.json`` at the end; the model and the returned
  state hold the best epoch's weights.

The model holds its weights: the state's f32 masters are copied into it
after every step (``train/state.py``), so an eval step reads no ``params``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.data.dataset import pos_weight_from_labels
from mmrp_tpu_torch.eval.metrics import composite_score, find_best_thresholds, per_class_report
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.train.joint import init_train_state, make_eval_step, make_train_step
from mmrp_tpu_torch.train.state import TrainState, make_write_back
from mmrp_tpu_torch.utils.checkpoint import CheckpointManager
from mmrp_tpu_torch.utils.logging import MetricWriter

# batch keys that carry integers (token ids and masks: the model's embedding
# lookups take int64)
_INT_KEYS = ("input_ids", "attention_mask")


@dataclass
class JointTrainResult:
    state: TrainState
    thresholds: np.ndarray
    best_metrics: Dict
    val_embeddings: np.ndarray
    val_ids: List[str]


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as tensors on ``device`` (ids dropped)."""
    out = {}
    for k, v in batch.items():
        if k in ("ids", "id"):
            continue
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.long() if k in _INT_KEYS else t.float()
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


def _full_state(state: TrainState, step: int, epoch: int, bad: int) -> Dict:
    return {"params": state.params,
            "opt_state": {"mu": state.mu, "nu": state.nu,
                          "count": torch.tensor(state.count, dtype=torch.int64)},
            "base_rng": torch.tensor(state.seed, dtype=torch.int64),
            "step": torch.tensor(step, dtype=torch.int64),
            "epoch": torch.tensor(epoch, dtype=torch.int64),
            "bad": torch.tensor(bad, dtype=torch.int64)}


@torch.no_grad()
def _load_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    """Copy ``src``'s tensors into ``dst``'s (same names) in place, keeping
    each destination's dtype and device (a master shared with an f32 model
    parameter stays shared)."""
    for k, v in src.items():
        dst[k].copy_(v)


def run_joint_training(
    cfg: Config,
    model: MultiModalRetrievalModel,
    train_loader,
    val_loader,
    out_dir: str,
    kg_dim: Optional[int] = None,
    class_names: Optional[Sequence[str]] = None,
    metric_writer: Optional[MetricWriter] = None,
    warm_start: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None,
) -> JointTrainResult:
    """Train ``model`` (built on its device; initialised here from
    ``cfg.seed`` by ``utils/convert.py::init_params``) on the loaders.
    ``warm_start``: optional fn(masters) that overwrites some of the f32
    masters in place (finetuned / pretrained backbones) once after init.
    With ``cfg.resume`` and a full-state checkpoint, training continues from
    the last saved epoch instead."""
    from mmrp_tpu_torch.utils.convert import init_params

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    writer = metric_writer or MetricWriter(out_dir, cfg.run_name, cfg.to_dict())
    device = next(model.parameters()).device

    train_labels = np.stack([np.asarray(r["labels"], np.float32)
                             for r in train_loader.ds.records])
    pw = pos_weight_from_labels(train_labels, cfg.pos_weight_clamp_max)

    steps_per_epoch = max(1, len(train_loader))
    init_params(model, seed=cfg.seed)
    state = init_train_state(model, cfg, seed=cfg.seed,
                             total_steps=cfg.epochs * steps_per_epoch, kg_dim=kg_dim)
    write_back = make_write_back(model)
    if warm_start is not None:
        warm_start(state.params)
        write_back(state.params)

    train_step = make_train_step(model, cfg, pw)
    eval_step = make_eval_step(model, return_attention=True)

    mgr = CheckpointManager(str(out / "ckpt"))
    best = {"composite": -1.0}
    best_is_current = True  # the model holds the best weights so far
    best_kg_proj = None  # kg_proj at the best epoch of this process's run
    bad = 0
    step = 0
    start_epoch = 0
    if cfg.resume and mgr.latest_step() is not None:
        r = mgr.restore(_full_state(state, 0, 0, 0))
        _load_into(state.params, r["params"])
        _load_into(state.mu, r["opt_state"]["mu"])
        _load_into(state.nu, r["opt_state"]["nu"])
        state.count = int(r["opt_state"]["count"])
        state.seed = int(r["base_rng"])
        write_back(state.params)
        start_epoch = int(r["epoch"]) + 1
        bad = int(r["bad"])
        step = int(r["step"])
        bm = mgr.best_metrics()
        if bm:
            best = {k: v for k, v in bm.items() if k != "_best_value"}
            best_is_current = False
        print(f"[resume] continuing from epoch {start_epoch} (step {step})")
    # deterministic data order across resume: BatchIterator reseeds per
    # epoch from (seed + _epoch)
    if hasattr(train_loader, "_epoch"):
        train_loader._epoch = start_epoch

    for epoch in range(start_epoch, cfg.epochs):
        for batch in train_loader:
            state, metrics = train_step(state, device_batch(batch, device))
            if step % 20 == 0:
                writer.log(metrics, step=step)
            step += 1
        best_is_current = False

        # ---- validation ----
        probs, ys, embs, ids, attns = [], [], [], [], []
        for batch in val_loader:
            out_b = eval_step(device_batch(batch, device))
            keep = np.asarray(batch["valid"]) > 0
            probs.append(out_b["probs"].float().cpu().numpy()[keep])
            ys.append(np.asarray(batch["labels"])[keep])
            embs.append(out_b["joint_emb"].float().cpu().numpy()[keep])
            attns.append(out_b["patch_attention"].float().cpu().numpy()[keep])
            ids.extend([i for i, k in zip(batch["ids"], keep) if k])
        probs_a, ys_a, embs_a, attn_a = map(np.concatenate, (probs, ys, embs, attns))
        th = find_best_thresholds(ys_a, probs_a)
        names = list(class_names or [f"c{i}" for i in range(ys_a.shape[1])])
        rep = per_class_report(ys_a, probs_a, th, names)
        composite = composite_score(rep)
        writer.log({"val/macro_f1": rep["macro_f1"], "val/macro_auroc": rep["macro_auroc"],
                    "val/micro_f1": rep["micro_f1"], "val/composite": composite}, step=epoch)
        if composite > best["composite"]:
            best = {"composite": composite, "epoch": epoch,
                    "macro_f1": rep["macro_f1"], "macro_auroc": rep["macro_auroc"]}
            best_is_current = True
            if "kg_proj" in state.params:
                best_kg_proj = state.params["kg_proj"].clone()
            bad = 0
            np.save(out / "val_embeddings.npy", embs_a)
            np.save(out / "val_attention.npy", attn_a)
            (out / "val_ids.json").write_text(json.dumps(ids))
            np.save(out / "thresholds.npy", th)
            (out / "val_per_class.json").write_text(
                json.dumps(rep["per_class"], indent=1, default=float))
            mgr.update_best(composite, {"model": {k: v for k, v in state.params.items()
                                                  if k != "kg_proj"}}, best)
        else:
            bad += 1
        # full train state every epoch -> killed runs resume mid-training
        mgr.save(epoch, _full_state(state, step, epoch, bad))
        if bad >= cfg.patience:
            break

    if not best_is_current:  # the best epoch's weights back into the model
        _load_into(state.params, mgr.restore_best()["model"])
        if best_kg_proj is not None:
            state.params["kg_proj"].copy_(best_kg_proj)
        write_back(state.params)
    (out / "best_multimodal_metrics.json").write_text(json.dumps(best, indent=1))
    return JointTrainResult(
        state=state,
        thresholds=np.load(out / "thresholds.npy"),
        best_metrics=best,
        val_embeddings=np.load(out / "val_embeddings.npy"),
        val_ids=json.loads((out / "val_ids.json").read_text()),
    )


def dump_embeddings(model: MultiModalRetrievalModel, loader, out_prefix: str) -> None:
    """Gallery embedding dump of the weights the model holds:
    ``<prefix>_embeddings.npy`` + ``<prefix>_ids.json``, valid rows only."""
    eval_step = make_eval_step(model)
    device = next(model.parameters()).device
    embs, ids = [], []
    for batch in loader:
        out_b = eval_step(device_batch(batch, device))
        keep = np.asarray(batch["valid"]) > 0
        embs.append(out_b["joint_emb"].float().cpu().numpy()[keep])
        ids.extend([i for i, k in zip(batch["ids"], keep) if k])
    np.save(out_prefix + "_embeddings.npy", np.concatenate(embs))
    Path(out_prefix + "_ids.json").write_text(json.dumps(ids))
