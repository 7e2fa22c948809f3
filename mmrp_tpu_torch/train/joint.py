"""The joint multi-modal train step: loss assembly, backward, clip, AdamW.

Counterpart of ``mmrp_tpu/train/joint.py`` (``init_train_state``,
``compute_losses``, ``assemble_losses``, ``make_train_step``):

    loss = cls_weight * hybrid(BCE + focal, pos_weight)
         + cont_weight * (InfoNCE(img, txt) + weight_img_joint * InfoNCE(img, joint)
                          + weight_text_joint * InfoNCE(txt, joint))
         + kg_weight * kg_alignment(joint @ kg_proj, kg_target)

The model runs its training route (``deterministic=False``: Swin through the
raw-layout attention core C-F / C-B, BERT and fusion on their XLA branches
with dropout), in its own dtypes; ``train/state.py`` says how the f32 master
weights meet it. A step updates the state and the model in place and
rebuilds every Swin block's cached serving bias from its updated table, so
the serving route reads the stepped weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import WindowAttention
from mmrp_tpu_torch.train import losses as L
from mmrp_tpu_torch.train.state import TrainState, make_optimizer

Batch = Dict[str, torch.Tensor]


def init_train_state(model: MultiModalRetrievalModel, cfg: Config, seed: int = 0,
                     total_steps: int = 10_000, kg_dim: Optional[int] = None) -> TrainState:
    """The state of an initialised ``model``: f32 masters of its parameters
    (an f32 parameter is its own master), and with ``kg_dim`` a ``kg_proj``
    (joint_dim, kg_dim) drawn N(0, 1) / sqrt(joint_dim) from ``seed``."""
    params = {name: p.detach() if p.dtype == torch.float32 else p.detach().float()
              for name, p in model.named_parameters()}
    if kg_dim:
        joint_dim = model.config.joint_dim
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        params["kg_proj"] = torch.randn((joint_dim, kg_dim), generator=gen,
                                        device=device) / joint_dim ** 0.5
    tx = make_optimizer(cfg.lr, total_steps, mu_bf16=cfg.adam_mu_bf16)
    mu, nu = tx.init(params)
    return TrainState(params, mu, nu, 0, cfg.seed, tx)


def compute_losses(model: MultiModalRetrievalModel, kg_proj: Optional[torch.Tensor],
                   batch: Batch, generator: Optional[torch.Generator], cfg: Config,
                   pos_weight: Optional[torch.Tensor],
                   deterministic: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = model(batch["image"], batch["input_ids"], batch["attention_mask"],
                deterministic=deterministic, generator=generator)
    return assemble_losses(kg_proj, out, batch, cfg, pos_weight)


def assemble_losses(kg_proj: Optional[torch.Tensor], out: Dict[str, torch.Tensor],
                    batch: Batch, cfg: Config, pos_weight: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted loss from the model's outputs, and its terms under the
    JAX metric names."""
    valid = batch.get("valid")
    labels = batch["labels"]
    if cfg.use_hybrid:
        cls_loss = L.hybrid_bce_focal(out["logits"], labels, cfg.focal_ratio,
                                      cfg.gamma_focal, pos_weight, valid)
    elif cfg.use_focal:
        cls_loss = L.focal_loss(out["logits"], labels, cfg.gamma_focal, valid)
    else:
        cls_loss = L.bce_with_logits(out["logits"], labels, pos_weight, valid)

    nce_it = L.info_nce(out["img_emb"], out["txt_emb"], cfg.temperature, valid)
    nce_ij = L.info_nce(out["img_emb"], out["joint_emb"], cfg.temperature, valid)
    nce_tj = L.info_nce(out["txt_emb"], out["joint_emb"], cfg.temperature, valid)
    cont_loss = nce_it + cfg.weight_img_joint * nce_ij + cfg.weight_text_joint * nce_tj

    total = cfg.cls_weight * cls_loss + cfg.cont_weight * cont_loss
    metrics = {"loss/cls": cls_loss, "loss/contrastive": cont_loss,
               "loss/nce_img_txt": nce_it}
    if kg_proj is not None and "kg_target" in batch:
        target_valid = batch.get("kg_target_valid")
        if target_valid is None:
            target_valid = torch.ones(labels.shape[0], device=labels.device)
        kg_loss = L.kg_alignment_loss(out["joint_emb"], kg_proj, batch["kg_target"],
                                      target_valid, method=cfg.kg_method, valid=valid)
        total = total + cfg.kg_weight * kg_loss
        metrics["loss/kg_align"] = kg_loss
    metrics["loss/total"] = total
    return total, metrics


def make_train_step(model: MultiModalRetrievalModel, cfg: Config,
                    pos_weight=None) -> Callable[[TrainState, Batch],
                                                 Tuple[TrainState, Dict[str, float]]]:
    """``step(state, batch) -> (state, metrics)``: one forward and backward
    of the training route with dropout drawn from the state's step generator,
    then clip and AdamW on the masters, which go back into the model. The
    state and the model are updated in place; the same state is returned.
    ``metrics`` holds the loss terms and ``grad_norm``, the global norm of the
    unclipped gradients, as Python floats."""
    device = next(model.parameters()).device
    pw = None if pos_weight is None else torch.as_tensor(pos_weight, dtype=torch.float32,
                                                         device=device)
    named = dict(model.named_parameters())
    windows = [m for m in model.modules() if isinstance(m, WindowAttention)]

    def step(state: TrainState, batch: Batch):
        generator = state.step_generator(device)
        kg_proj = state.params.get("kg_proj")
        if kg_proj is not None:
            kg_proj.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        total, metrics = compute_losses(model, kg_proj, batch, generator, cfg, pw)
        total.backward()
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
                 for name, p in named.items()}
        if kg_proj is not None:
            grads["kg_proj"] = kg_proj.grad
            kg_proj.requires_grad_(False)
            kg_proj.grad = None
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = state.tx.apply(state, grads)
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            # the masters of the parameters the model holds in bf16
            pairs = [(p, state.params[name]) for name, p in named.items()
                     if state.params[name].data_ptr() != p.data_ptr()]
            if pairs:
                torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])
            for m in windows:
                m.refresh_bias()
        return state, metrics

    return step
