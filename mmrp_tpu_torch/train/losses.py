"""Loss functions of the joint trainer, in f32.

Counterpart of ``mmrp_tpu/train/losses.py``: BCE with logits (optional
per-class ``pos_weight``), focal loss, their hybrid, the asymmetric loss,
symmetric InfoNCE over in-batch negatives and the KG alignment loss. Each
takes an optional ``valid`` (B,) mask, so that padded batch rows drop out of
the means; InfoNCE also masks them as negatives, in both directions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements, counting only rows with valid > 0."""
    if valid is None:
        return x.mean()
    while valid.ndim < x.ndim:
        valid = valid[..., None]
    w = valid.expand(x.shape)
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted binary cross entropy with logits, computed stably."""
    log_p = -F.softplus(-logits)
    log_not_p = -F.softplus(logits)
    w_pos = pos_weight if pos_weight is not None else 1.0
    loss = -(w_pos * targets * log_p + (1.0 - targets) * log_not_p)
    return _masked_mean(loss, valid)


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 1.0,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-label focal loss: BCE scaled by (1 - p_t)^gamma."""
    p = torch.sigmoid(logits)
    ce = targets * F.softplus(-logits) + (1 - targets) * F.softplus(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    return _masked_mean(ce * (1.0 - p_t) ** gamma, valid)


def hybrid_bce_focal(logits: torch.Tensor, targets: torch.Tensor, focal_ratio: float = 0.3,
                     gamma: float = 1.0, pos_weight: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 - r) * BCE + r * focal."""
    return (1.0 - focal_ratio) * bce_with_logits(logits, targets, pos_weight, valid) \
        + focal_ratio * focal_loss(logits, targets, gamma, valid)


def asymmetric_loss(logits: torch.Tensor, targets: torch.Tensor, gamma_pos: float = 0.0,
                    gamma_neg: float = 4.0, clip: float = 0.05,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ASL: shifted negative probabilities and asymmetric focusing."""
    p = torch.sigmoid(logits)
    p_neg = torch.clamp(p - clip, 0.0, 1.0) if clip and clip > 0 else p
    loss_pos = targets * torch.log(torch.clamp(p, min=1e-8)) * (1 - p) ** gamma_pos
    loss_neg = (1 - targets) * torch.log(torch.clamp(1 - p_neg, min=1e-8)) * p_neg ** gamma_neg
    return _masked_mean(-(loss_pos + loss_neg), valid)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def info_nce(a: torch.Tensor, b: torch.Tensor, temperature: float = 0.125,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives; rows with valid == 0 are
    neither anchors nor negatives."""
    sim = _l2_normalize(a) @ _l2_normalize(b).T / temperature  # (B, B)
    if valid is not None:
        col_mask = torch.where(valid > 0, 0.0, -1e9).to(sim.dtype)
    else:
        col_mask = torch.zeros(a.shape[0], dtype=sim.dtype, device=sim.device)
    ce_ab = -torch.diagonal(torch.log_softmax(sim + col_mask[None, :], dim=1))
    ce_ba = -torch.diagonal(torch.log_softmax(sim.T + col_mask[None, :], dim=1))
    return _masked_mean(0.5 * (ce_ab + ce_ba), valid)


def kg_alignment_loss(joint_emb: torch.Tensor, kg_proj_w: torch.Tensor,
                      kg_targets: torch.Tensor, target_valid: torch.Tensor,
                      method: str = "cosine",
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Align ``joint_emb @ kg_proj_w`` (B, Dk) to per-sample KG vectors by
    cosine distance (or MSE), over rows with a target (and valid)."""
    proj = joint_emb @ kg_proj_w
    both_valid = target_valid if valid is None else target_valid * valid
    if method == "mse":
        per = ((proj - kg_targets) ** 2).mean(-1)
    else:
        per = 1.0 - (_l2_normalize(proj) * _l2_normalize(kg_targets)).sum(-1)
    return _masked_mean(per, both_valid)
