"""The joint multi-modal train step: loss assembly, backward, clip, AdamW.

Counterpart of ``mmrp_tpu/train/joint.py`` (``init_train_state``,
``compute_losses``, ``assemble_losses``, ``make_train_step``,
``make_train_step_dp``, ``make_eval_step``):

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

A step's host time is spanned (``utils/trace.py``) under its count:
``train.step`` holds ``train.forward`` (the towers' own spans inside),
``train.loss``, ``train.backward``, ``train.read_losses`` (one per loss
term read to the host), ``train.optimizer`` (with ``train.read_norm``, the
gradient norm read for the clip) and ``train.write_back``. Those reads are
the step's only waits on the device: 5 a step with the KG loss, 4 without,
and the norm, each counted in ``host_reads``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.ops import preprocess
from mmrp_tpu_torch.train import losses as L
from mmrp_tpu_torch.train.state import TrainState, make_optimizer, make_write_back, master_params
from mmrp_tpu_torch.utils.trace import host_read, span

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
    with span("train.forward"):
        image = batch["image"]
        if not deterministic and cfg.augment:
            # drawn before the dropout masks, from the same generator (JAX
            # splits its step key into the augmentation's and dropout's)
            image = preprocess.augment_batch(image, generator)
        out = model(image, batch["input_ids"], batch["attention_mask"],
                    deterministic=deterministic, generator=generator)
    with span("train.loss"):
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
    return _make_step(model, cfg, pos_weight)


# the model outputs and the batch entries the loss of a data-parallel step
# reads across ranks
_GATHER_OUT = ("logits", "img_emb", "txt_emb", "joint_emb")
_GATHER_BATCH = ("labels", "valid", "kg_target", "kg_target_valid")


def make_train_step_dp(model: MultiModalRetrievalModel, cfg: Config, mesh, pos_weight=None,
                       *, axis_name: str = "dp",
                       core_kernel: Optional[bool] = None) -> Callable:
    """Data-parallel ``step(state, batch)``: every rank of ``mesh`` calls it
    with its own rows of the global batch (``data/pipeline.py::
    device_put_sharded_batch``) and the same state, and gets the same
    updated state and metrics as ``make_train_step`` on the whole batch.

    Each rank runs the training route on its rows, so the attention core
    (C-F / C-B) takes per-rank shapes, as JAX's ``shard_map`` hands its
    Pallas core per-shard shapes. The batch-coupled losses (in-batch InfoNCE
    negatives, global masked means) see the whole batch: ``logits``,
    ``img_emb``, ``txt_emb`` and ``joint_emb``, and the batch's ``labels``,
    ``valid``, ``kg_target`` and ``kg_target_valid``, are all-gathered over
    ``axis_name`` with autograd (``parallel/collectives.py::
    all_gather_rows``), and every rank assembles the global loss. The
    gather's backward sums the ranks' identical cotangents, so each rank's
    gradients are n times its rows' share; their all-reduce divided by n is
    the global gradient (``parallel/collectives.py::all_reduce_mean``: one
    concatenation, one cast to f32 and one all-reduce; the optimizer takes
    the f32 views as they are).

    Dropout is drawn from the same per-step generator on every rank over its
    local shape: the masks differ from the single-program step's (same
    distribution; exact comparisons use dropout 0). ``core_kernel``: None
    or True, the model's training route (C-F / C-B on the card); False, the
    plain core (``models/swin.py::force_core``).

    A state placed by ``parallel/mesh.py::shard_state`` keeps its
    rule-matched masters and moments as ``DTensor`` blocks: the norm is
    taken over the whole gradients, each rank updates its blocks, and the
    masters are gathered whole into the model."""
    return _make_step(model, cfg, pos_weight, mesh=mesh, axis_name=axis_name,
                      core_kernel=core_kernel)


def _make_step(model: MultiModalRetrievalModel, cfg: Config, pos_weight, mesh=None,
               axis_name: str = "dp", core_kernel: Optional[bool] = None) -> Callable:
    from mmrp_tpu_torch.models.swin import force_core

    device = next(model.parameters()).device
    pw = None if pos_weight is None else torch.as_tensor(pos_weight, dtype=torch.float32,
                                                         device=device)
    named = dict(model.named_parameters())
    write_back = make_write_back(model)
    if mesh is not None:
        from mmrp_tpu_torch.parallel import mesh as M
        from mmrp_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_mean

        group = M.axis_group(mesh, axis_name)

    def losses(kg_proj, batch, generator):
        if mesh is None:
            return compute_losses(model, kg_proj, batch, generator, cfg, pw)
        with span("train.forward"):
            image = batch["image"]
            if cfg.augment:
                image = preprocess.augment_batch(image, generator)
            with force_core(model, core_kernel):
                out = model(image, batch["input_ids"], batch["attention_mask"],
                            deterministic=False, generator=generator)
        with span("train.loss"):
            gout = {k: all_gather_rows(out[k], group) for k in _GATHER_OUT}
            gbatch = {k: all_gather_rows(batch[k], group) for k in _GATHER_BATCH if k in batch}
            return assemble_losses(kg_proj, gout, gbatch, cfg, pw)

    def step(state: TrainState, batch: Batch):
        with span("train.step", state.count):
            return _step(state, batch)

    def _step(state: TrainState, batch: Batch):
        generator = state.step_generator(device)
        kg_proj = state.params.get("kg_proj")
        if kg_proj is not None:
            kg_proj.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        total, metrics = losses(kg_proj, batch, generator)
        with span("train.backward"):
            total.backward()
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
                 for name, p in named.items()}
        if kg_proj is not None:
            # zero where the batch has no kg_target, as JAX's grad of an unused leaf
            grads["kg_proj"] = kg_proj.grad if kg_proj.grad is not None else \
                torch.zeros_like(kg_proj)
            kg_proj.requires_grad_(False)
            kg_proj.grad = None
        # each read waits for the device to reach it
        metrics = {k: host_read(v.detach(), "train.read_losses") for k, v in metrics.items()}
        with span("train.optimizer"):
            if mesh is None:
                metrics["grad_norm"], params = state.tx.apply(state, grads), state.params
            else:
                grads = dict(zip(grads, all_reduce_mean(list(grads.values()), group)))
                metrics["grad_norm"], params = _apply_placed(state, grads, mesh)
        with span("train.write_back"):
            model.zero_grad(set_to_none=True)
            write_back(params)
        return state, metrics

    return step


def _apply_placed(state: TrainState, grads: Dict[str, torch.Tensor], mesh
                  ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """AdamW on a state whose masters and moments may be ``DTensor`` blocks:
    the norm of the whole gradients, then the update of this rank's blocks
    (each rank holds the whole, identical gradients). Returns the norm and
    the whole masters (the placed ones gathered)."""
    from torch.distributed.tensor import DTensor

    from mmrp_tpu_torch.parallel.mesh import local, local_block, whole
    from mmrp_tpu_torch.train.state import global_norm

    placed = {k: v.placements for k, v in state.params.items() if isinstance(v, DTensor)}
    if not placed:
        return state.tx.apply(state, grads), state.params
    norm = host_read(global_norm([grads[k].float() for k in state.params]), "train.read_norm")
    blocks = TrainState({k: local(v) for k, v in state.params.items()},
                        {k: local(v) for k, v in state.mu.items()},
                        {k: local(v) for k, v in state.nu.items()},
                        state.count, state.seed, state.tx)
    gl = {k: local_block(g, mesh, placed[k]) if k in placed else g for k, g in grads.items()}
    out = state.tx.apply(blocks, gl, norm=norm)  # masters' blocks updated in place
    for moments, new in ((state.mu, blocks.mu), (state.nu, blocks.nu)):
        for k, v in new.items():
            moments[k] = (DTensor.from_local(v, mesh, placed[k], run_check=False)
                          if k in placed else v)
    state.count = blocks.count
    return out, {k: whole(v) if k in placed else v for k, v in state.params.items()}


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
