"""Swin finetuning task: label-aware classifier with the reference's
training refinements.

Counterpart of ``mmrp_tpu/train/swin_finetune.py``, function for function:

- loss choices hybrid / focal / bce / asl on smoothed labels
  (:func:`classification_loss`), and a quick search over ASL settings
  (:func:`auto_select_asl`);
- the LR range finder (:func:`lr_range_test`);
- discriminative learning rates: ``optax.adamw`` at ``lr`` for the head and
  at ``lr * backbone_lr_scale`` for the Swin backbone
  (:func:`make_finetune_optimizer`: :class:`train.state.Adam` with optax's
  default weight decay 1e-4, eps 1e-8, decoupled decay);
- progressive unfreezing as masks (:func:`freeze_mask_for_epoch`): a frozen
  parameter's gradient *and* update are multiplied by 0, so it is neither
  decayed nor given moments that move;
- the pos_weight ramp, post-training temperature calibration and per-class
  thresholds.

The model is the port's :class:`SwinForFinetune`, on the card in bf16 (the
precision its kernels take) with f32 master weights in the optimizer, as the
joint step keeps them (``train/state.py``); on the CPU in f32. Its training
route runs the Swin attention cores through C-F / C-B. Dropout and DropPath
draw from one ``torch.Generator`` seeded from ``cfg.seed``, as JAX splits its
key per step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from mmrp_tpu_torch.eval.metrics import composite_score, find_best_thresholds, per_class_report
from mmrp_tpu_torch.models.finetune_head import SwinForFinetune
from mmrp_tpu_torch.train import losses as L
from mmrp_tpu_torch.train.state import Adam, AdamState, make_write_back, master_params

Params = Dict[str, torch.Tensor]


@dataclass
class SwinFinetuneConfig:
    lr: float = 1e-4
    backbone_lr_scale: float = 0.005
    epochs: int = 12
    unfreeze_epochs: Tuple[int, ...] = (1, 5, 10)  # stage-wise unfreeze points
    loss: str = "hybrid"  # hybrid | focal | bce | asl
    focal_ratio: float = 0.3
    gamma_focal: float = 1.0
    asl_gamma_neg: float = 4.0
    asl_clip: float = 0.05
    label_smoothing: float = 0.05
    pos_weight_clamp: float = 5.0
    pos_weight_ramp_epochs: int = 5
    patience: int = 4
    seed: int = 2709


def smooth_labels(y: torch.Tensor, eps: float) -> torch.Tensor:
    return y * (1.0 - eps) + 0.5 * eps


def classification_loss(cfg: SwinFinetuneConfig, logits, targets, pos_weight, valid):
    t = smooth_labels(targets, cfg.label_smoothing)
    if cfg.loss == "hybrid":
        return L.hybrid_bce_focal(logits, t, cfg.focal_ratio, cfg.gamma_focal, pos_weight, valid)
    if cfg.loss == "focal":
        return L.focal_loss(logits, t, cfg.gamma_focal, valid)
    if cfg.loss == "asl":
        return L.asymmetric_loss(logits, t, gamma_neg=cfg.asl_gamma_neg, clip=cfg.asl_clip,
                                 valid=valid)
    return L.bce_with_logits(logits, t, pos_weight, valid)


# ---------------------------------------------------------------------------
# Optimizer: discriminative LRs + maskable freezing
# ---------------------------------------------------------------------------


def _is_backbone(name: str) -> bool:
    return name.split(".")[0] == "swin"


class FinetuneOptimizer:
    """``optax.multi_transform({"head": adamw(lr), "backbone": adamw(lr *
    backbone_lr_scale)})`` over the parameters' names."""

    def __init__(self, cfg: SwinFinetuneConfig, params: Params):
        self.labels = {k: "backbone" if _is_backbone(k) else "head" for k in params}
        self.tx = {"head": Adam(cfg.lr, weight_decay=1e-4),
                   "backbone": Adam(cfg.lr * cfg.backbone_lr_scale, weight_decay=1e-4)}

    def _part(self, tree, label):
        return {k: v for k, v in tree.items() if self.labels[k] == label}

    def init(self, params: Params) -> Dict[str, AdamState]:
        return {label: tx.init(self._part(params, label)) for label, tx in self.tx.items()}

    def step(self, params: Params, grads: Params, opt_state: Dict[str, AdamState],
             mask: Dict[str, float]) -> None:
        for label, tx in self.tx.items():
            part = self._part(params, label)
            if part:
                tx.step(part, self._part(grads, label), opt_state[label], mask)


def make_finetune_optimizer(cfg: SwinFinetuneConfig, params: Params) -> FinetuneOptimizer:
    return FinetuneOptimizer(cfg, params)


def freeze_mask_for_epoch(cfg: SwinFinetuneConfig, params, epoch: int) -> Dict[str, float]:
    """1.0 / 0.0 per parameter name: the backbone's stages unfreeze
    progressively, deepest first (epoch >= unfreeze_epochs[i] unlocks phase
    i + 1); patch embed and the final norm follow the last phase; the head is
    always trainable."""
    n_phases = len(cfg.unfreeze_epochs)
    unlocked = sum(1 for e in cfg.unfreeze_epochs if epoch >= e)

    def stage_of(name: str) -> Optional[int]:
        for part in name.split("."):
            if part.startswith(("stage", "merge")):
                return int(part[5])
        return None

    stages = {stage_of(k) for k in params if _is_backbone(k)} - {None}
    total_stages = max(stages) + 1 if stages else 1
    mask = {}
    for name in params:
        if not _is_backbone(name):
            mask[name] = 1.0
            continue
        stage = stage_of(name)
        if stage is None:
            mask[name] = 1.0 if unlocked >= n_phases else 0.0
            continue
        depth_rank = total_stages - 1 - stage  # 0 = deepest
        mask[name] = 1.0 if unlocked >= min(depth_rank + 1, n_phases) else 0.0
    return mask


def pos_weight_ramp(base_pw: np.ndarray, epoch: int, ramp_epochs: int,
                    clamp: float) -> np.ndarray:
    """Linear ramp from all-ones to the clamped inverse-frequency weights."""
    frac = min(1.0, (epoch + 1) / max(ramp_epochs, 1))
    pw = 1.0 + frac * (np.minimum(base_pw, clamp) - 1.0)
    return pw.astype(np.float32)


# ---------------------------------------------------------------------------
# Balanced finetune subset
# ---------------------------------------------------------------------------


def build_finetune_subset(records, max_per_label: int = 200, min_per_label: int = 5,
                          max_retries: int = 3, seed: int = 2709):
    """Balanced subset: cap each label's positives at ``max_per_label``;
    retry with a relaxed cap when rare labels end up under-represented."""
    rng = np.random.default_rng(seed)
    labels = np.stack([np.asarray(r["labels"]) for r in records]).astype(bool)
    n, C = labels.shape
    for attempt in range(max_retries):
        cap = max_per_label * (attempt + 1)
        chosen = np.zeros(n, dtype=bool)
        per_label = labels.sum(axis=0)
        order = np.argsort(per_label)  # rarest labels pick first
        for c in order:
            have = int(labels[chosen, c].sum())
            if have >= cap:
                continue
            holders = np.where(labels[:, c] & ~chosen)[0]
            rng.shuffle(holders)
            chosen[holders[: cap - have]] = True
        sub_counts = labels[chosen].sum(axis=0)
        if all(sub_counts[c] >= min(min_per_label, per_label[c]) for c in range(C)):
            break
    return [records[i] for i in np.where(chosen)[0]]


# ---------------------------------------------------------------------------
# LR range finder
# ---------------------------------------------------------------------------


def lr_range_test(loss_at_lr: Callable[[float], float], lr_min: float = 1e-6,
                  lr_max: float = 1.0, steps: int = 30) -> float:
    """Exponential sweep; returns the LR one decade below the loss blow-up
    point (standard LR-finder heuristic)."""
    lrs = np.logspace(np.log10(lr_min), np.log10(lr_max), steps)
    losses = np.array([loss_at_lr(float(lr)) for lr in lrs])
    finite = np.isfinite(losses)
    if not finite.any():
        return 1e-4
    run_min = np.minimum.accumulate(np.where(finite, losses, np.inf))
    bad = ~finite | (losses > 4 * run_min)
    blow = int(np.argmax(bad)) if bad.any() else len(lrs) - 1
    head = losses[: max(blow, 1)]
    if not np.isfinite(head).any():
        return 1e-4
    best = np.nanargmin(head)
    return float(lrs[best] / 10.0) if blow > 0 else float(lrs[best])


# ---------------------------------------------------------------------------
# ASL auto-search
# ---------------------------------------------------------------------------


def auto_select_asl(model, cfg: SwinFinetuneConfig, train_batches, val_batches,
                    base_pos_weight, sample_image,
                    candidates=((2.0, 0.0), (4.0, 0.05), (6.0, 0.1)),
                    quick_epochs: int = 2) -> Tuple[float, float, Dict]:
    """Short-horizon training per (gamma_neg, clip) candidate; returns the
    settings with the best composite metric."""
    best = (None, None, {"composite": -1.0})
    for gamma_neg, clip in candidates:
        trial_cfg = dataclasses.replace(cfg, loss="asl", asl_gamma_neg=gamma_neg,
                                        asl_clip=clip, epochs=quick_epochs,
                                        patience=quick_epochs + 1)
        res = finetune(model, trial_cfg, train_batches, val_batches, base_pos_weight,
                       sample_image)
        comp = composite_score(res["report"])
        if comp > best[2]["composite"]:
            best = (gamma_neg, clip, {"composite": comp})
    return best


# ---------------------------------------------------------------------------
# Temperature calibration
# ---------------------------------------------------------------------------


def calibrate_temperature(logits: np.ndarray, labels: np.ndarray, steps: int = 200,
                          lr: float = 0.05) -> float:
    """Scalar T minimizing BCE(logits / T, labels) on the validation set, by
    ``steps`` of gradient descent on log T from 0 (f32, on the CPU)."""
    lg = torch.as_tensor(np.asarray(logits, np.float32))
    y = torch.as_tensor(np.asarray(labels, np.float32))
    log_t = torch.zeros((), dtype=torch.float32)
    for _ in range(steps):
        t = log_t.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(L.bce_with_logits(lg / torch.exp(t), y), t)
        log_t = log_t - lr * g
    return float(torch.exp(log_t))


# ---------------------------------------------------------------------------
# Train step + loop
# ---------------------------------------------------------------------------


def make_finetune_step(model: SwinForFinetune, cfg: SwinFinetuneConfig,
                       tx: FinetuneOptimizer):
    from mmrp_tpu_torch.train.pipeline import device_batch

    """``step(params, opt_state, batch, pos_weight, freeze, generator) ->
    (params, opt_state, loss)``: the training-route forward and backward with
    dropout from ``generator``, the gradients cast to f32 and masked by
    ``freeze``, the two-rate AdamW on the f32 masters ``params`` (updated in
    place, updates masked too), and the masters copied back into the model."""
    named = dict(model.named_parameters())
    write_back = make_write_back(model)
    device = next(model.parameters()).device

    def step(params: Params, opt_state, batch, pos_weight, freeze, generator):
        b = device_batch(batch, device)
        pw = None if pos_weight is None else torch.as_tensor(
            np.asarray(pos_weight, np.float32), device=device)
        model.zero_grad(set_to_none=True)
        out = model(b["image"], deterministic=False, generator=generator)
        loss = classification_loss(cfg, out["logits"], b["labels"], pw, b.get("valid"))
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for k, p in named.items()}
        model.zero_grad(set_to_none=True)
        tx.step(params, grads, opt_state, freeze)
        write_back(params)
        return params, opt_state, float(loss.detach())

    return step


def finetune(model: SwinForFinetune, cfg: SwinFinetuneConfig,
             train_batches: Callable[[], Iterable[Dict[str, np.ndarray]]],
             val_batches: Callable[[], Iterable[Dict[str, np.ndarray]]],
             base_pos_weight: np.ndarray, sample_image: np.ndarray = None,
             metric_writer=None, class_names=None, init_backbone=None) -> Dict:
    """Full finetune loop -> dict(params, thresholds, temperature, report,
    best_epoch). ``params`` are the best epoch's f32 masters under the
    model's parameter names, and the model holds them (rounded to its dtype)
    on return. The model starts from ``utils/convert.py::init_params`` at
    ``cfg.seed``; ``init_backbone``, a Flax Swin parameter tree (nested or
    flat), replaces the backbone's weights first (a shape mismatch raises).
    ``sample_image`` is unused: JAX's init traces it, the port's model is
    built with its shapes."""
    from mmrp_tpu_torch.utils.convert import flax_to_state_dict, init_params

    device = next(model.parameters()).device
    init_params(model, seed=cfg.seed)
    params = master_params(model)
    if init_backbone is not None:
        for key, val in flax_to_state_dict(init_backbone).items():
            name = f"swin.{key}"
            if name not in params:
                raise ValueError(f"pretrained backbone leaf {key} is not a model parameter")
            if tuple(val.shape) != tuple(params[name].shape):
                raise ValueError(f"pretrained backbone leaf {key} shape {tuple(val.shape)} "
                                 f"!= model {tuple(params[name].shape)}")
            params[name].copy_(val)
    write_back = make_write_back(model)
    write_back(params)
    tx = make_finetune_optimizer(cfg, params)
    opt_state = tx.init(params)
    step_fn = make_finetune_step(model, cfg, tx)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    best = {"composite": -1.0}
    best_params = {k: v.clone() for k, v in params.items()}
    bad = 0
    for epoch in range(cfg.epochs):
        freeze = freeze_mask_for_epoch(cfg, params, epoch)
        pw = pos_weight_ramp(base_pos_weight, epoch, cfg.pos_weight_ramp_epochs,
                             cfg.pos_weight_clamp)
        losses = []
        for batch in train_batches():
            params, opt_state, loss = step_fn(params, opt_state, batch, pw, freeze, generator)
            losses.append(loss)

        logits_ep, ys = [], []
        for batch in val_batches():
            with torch.inference_mode():
                img = torch.as_tensor(np.asarray(batch["image"])).to(device)
                lg = model(img)["logits"].float().cpu().numpy()
            v = batch.get("valid")
            keep = slice(None) if v is None else np.asarray(v) > 0
            logits_ep.append(lg[keep])
            ys.append(np.asarray(batch["labels"])[keep])
        logits_ep = np.concatenate(logits_ep)
        ys = np.concatenate(ys)
        probs = 1.0 / (1.0 + np.exp(-logits_ep))
        th = find_best_thresholds(ys, probs)
        names = class_names or [f"c{i}" for i in range(ys.shape[1])]
        rep = per_class_report(ys, probs, th, names)
        composite = composite_score(rep)
        if metric_writer is not None:
            metric_writer.log({"swin/loss": np.mean(losses), "swin/macro_f1": rep["macro_f1"],
                               "swin/macro_auroc": rep["macro_auroc"],
                               "swin/composite": composite}, step=epoch)
        if composite > best["composite"]:
            best = {"composite": composite, "epoch": epoch, "report": rep, "thresholds": th}
            best_params = {k: v.clone() for k, v in params.items()}
            best_logits, best_ys = logits_ep, ys
            bad = 0
        else:
            bad += 1
            if bad >= cfg.patience:
                break

    with torch.no_grad():
        for k, v in best_params.items():
            params[k].copy_(v)
    write_back(params)
    temperature = calibrate_temperature(best_logits, best_ys)
    return {"params": params, "thresholds": best["thresholds"], "temperature": temperature,
            "report": best["report"], "best_epoch": best["epoch"]}
