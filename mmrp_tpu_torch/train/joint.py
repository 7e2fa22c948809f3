"""The joint multi-modal train step: loss assembly, backward, clip, AdamW.

Counterpart of ``mmrp_tpu/train/joint.py`` (``init_train_state``,
``compute_losses``, ``assemble_losses``, ``make_train_step``):

    loss = cls_weight * hybrid(BCE + focal, pos_weight)
         + cont_weight * (InfoNCE(img, txt) + weight_img_joint * InfoNCE(img, joint)
                          + weight_text_joint * InfoNCE(txt, joint))
         + kg_weight * kg_alignment(joint @ kg_proj, kg_target)

The model runs its training route (``deterministic=False``: Swin through the
raw-layout attention core C-F / C-B, BERT and fusion on their XLA branches
with dropout; with ``cfg.augment`` the images rotated and flipped first by
``ops/preprocess.py::augment_batch``), in its own dtypes; ``train/state.py``
says how the f32 master weights meet it. A step updates the state and the
model in place and rebuilds every Swin block's cached serving bias from its
updated table, so the serving route reads the stepped weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.ops import preprocess
from mmrp_tpu_torch.train import losses as L
from mmrp_tpu_torch.train.state import TrainState, make_optimizer, make_write_back, master_params

Batch = Dict[str, torch.Tensor]


def init_train_state(model: MultiModalRetrievalModel, cfg: Config, seed: int = 0,
                     total_steps: int = 10_000, kg_dim: Optional[int] = None) -> TrainState:
    """The state of an initialised ``model``: f32 masters of its parameters
    (an f32 parameter is its own master), and with ``kg_dim`` a ``kg_proj``
    (joint_dim, kg_dim) drawn N(0, 1) / sqrt(joint_dim) from ``seed``."""
    params = master_params(model)
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
    image = batch["image"]
    if not deterministic and cfg.augment:
        # drawn before the dropout masks, from the same generator (JAX
        # splits its step key into the augmentation's and dropout's)
        image = preprocess.augment_batch(image, generator)
    out = model(image, batch["input_ids"], batch["attention_mask"],
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
    unclipped gradients, as Python floats. A ``remat_backbone`` model
    recomputes each tower block's activations in the backward
    (``models/layers.py::remat``): the same gradients, less memory."""
    device = next(model.parameters()).device
    pw = None if pos_weight is None else torch.as_tensor(pos_weight, dtype=torch.float32,
                                                         device=device)
    named = dict(model.named_parameters())
    write_back = make_write_back(model)

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
            # zero where the batch has no kg_target, as JAX's grad of an unused leaf
            grads["kg_proj"] = kg_proj.grad if kg_proj.grad is not None else \
                torch.zeros_like(kg_proj)
            kg_proj.requires_grad_(False)
            kg_proj.grad = None
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = state.tx.apply(state, grads)
        model.zero_grad(set_to_none=True)
        write_back(state.params)
        return state, metrics

    return step


def make_eval_step(model: MultiModalRetrievalModel,
                   return_attention: bool = False) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``eval_step(batch) -> {probs, joint_emb, img_emb, txt_emb [,
    patch_attention (B, Np)]}``: the deterministic forward of the weights the
    model holds (its serving routes; with ``return_attention`` the fusion
    layers take the XLA branch that returns their attention weights, as
    JAX's), under ``torch.inference_mode``. ``patch_attention`` is the
    text-to-image attention averaged over layers and heads, then over the
    valid text tokens: the per-sample vector the joint stage keeps at its
    best epoch (``val_attention.npy``)."""

    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            out = model(batch["image"], batch["input_ids"], batch["attention_mask"],
                        return_attention=return_attention)
            res = {"probs": torch.sigmoid(out["logits"]), "joint_emb": out["joint_emb"],
                   "img_emb": out["img_emb"], "txt_emb": out["txt_emb"]}
            if return_attention:
                t2i = torch.stack([a["txt2img"].float() for a in out["attention"]])
                w = batch["attention_mask"][:, : t2i.shape[3]].float()
                t2i = t2i.mean(dim=(0, 2))  # (B, Lt, Np)
                res["patch_attention"] = (t2i * w[:, :, None]).sum(1) / torch.clamp(
                    w.sum(1, keepdim=True), min=1.0)
        return res

    return eval_step
