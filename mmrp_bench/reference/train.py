"""The plain float32 joint train step: the loss terms of the reference's
training (hybrid BCE + focal classification with per-class positive weights,
symmetric InfoNCE between the image, text and joint embeddings, cosine
alignment of the projected joint embedding to each pair's KG vector), their
gradients, then clip by global norm and AdamW (decoupled weight decay) on a
linear warm-up and cosine decay, with Adam's first moment stored in
bfloat16 after the update has used it: the optimizer as ``optax.chain(
clip_by_global_norm, adamw(warmup_cosine_decay_schedule, mu_dtype=bf16))``
defines it.

The forward reads each weight that the model holds in a narrower type than
float32 (``served``: bfloat16 for a model served in it) as its float32
master rounded to that type, as the configuration states it trains (bf16
compute on f32 masters), and its gradient goes to the master unchanged; the
arithmetic is float32 throughout.

The batch's losses couple its rows (in-batch negatives), so the gradients
are taken in two passes that fit in memory at any batch: the model's outputs
for every row without autograd, the loss and its gradient with respect to
those outputs, then the forward and backward again in blocks of rows with
those output gradients. The sum over blocks is the whole batch's gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from mmrp_bench.reference.model import Ref

OUT_KEYS = ("logits", "img_emb", "txt_emb", "joint_emb")


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def info_nce(a, b, t: float):
    sim = _unit(a) @ _unit(b).T / t
    ce_ab = -torch.diagonal(torch.log_softmax(sim, dim=1))
    ce_ba = -torch.diagonal(torch.log_softmax(sim.T, dim=1))
    return (0.5 * (ce_ab + ce_ba)).mean()


def losses(out: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
           kg_proj: torch.Tensor, loss_cfg: Mapping, pos_weight: torch.Tensor):
    """(total, {term: value}) for a batch in which every row is valid and
    has a KG target."""
    z, y = out["logits"], batch["labels"]
    bce = -(pos_weight * y * -F.softplus(-z) + (1 - y) * -F.softplus(z)).mean()
    p = torch.sigmoid(z)
    ce = y * F.softplus(-z) + (1 - y) * F.softplus(z)
    p_t = p * y + (1 - p) * (1 - y)
    focal = (ce * (1 - p_t) ** loss_cfg["gamma_focal"]).mean()
    r = loss_cfg["focal_ratio"]
    cls = (1 - r) * bce + r * focal
    t = loss_cfg["temperature"]
    cont = (info_nce(out["img_emb"], out["txt_emb"], t)
            + loss_cfg["weight_img_joint"] * info_nce(out["img_emb"], out["joint_emb"], t)
            + loss_cfg["weight_text_joint"] * info_nce(out["txt_emb"], out["joint_emb"], t))
    proj = out["joint_emb"] @ kg_proj
    kg = (1.0 - (_unit(proj) * _unit(batch["kg_target"])).sum(-1)).mean()
    total = (loss_cfg["cls_weight"] * cls + loss_cfg["cont_weight"] * cont
             + loss_cfg["kg_weight"] * kg)
    return total, {"cls": cls, "contrastive": cont, "kg_align": kg, "total": total}


def gradients(cfg: Mapping, params: Dict[str, torch.Tensor], batch: Mapping, loss_cfg: Mapping,
              pos_weight: torch.Tensor, rows: int = 16, quant: Optional[Callable] = None,
              served: Optional[Mapping[str, torch.dtype]] = None):
    """(total loss, terms, {name: f32 gradient}) of one batch; ``params``
    holds the model's f32 masters and ``kg_proj``; ``served``: the type each
    weight is held in by the model (module docstring)."""
    served = served or {}
    model_w = {k: v.to(served[k]).float() if served.get(k, torch.float32) != torch.float32 else v
               for k, v in params.items() if k != "kg_proj"}
    image, ids, mask = batch["image"], batch["input_ids"], batch["attention_mask"]
    B = ids.shape[0]
    with torch.no_grad():
        ref = Ref(cfg, model_w, quant)
        parts = [ref.forward(image[i:i + rows], ids[i:i + rows], mask[i:i + rows])
                 for i in range(0, B, rows)]
    out = {k: torch.cat([o[k] for o in parts]).requires_grad_(True) for k in OUT_KEYS}
    kg_proj = params["kg_proj"].detach().requires_grad_(True)
    total, terms = losses(out, batch, kg_proj, loss_cfg, pos_weight)
    total.backward()
    cot = {k: out[k].grad for k in OUT_KEYS}
    leaves = {k: v.detach().requires_grad_(True) for k, v in model_w.items()}
    ref = Ref(cfg, leaves, quant)
    for i in range(0, B, rows):
        o = ref.forward(image[i:i + rows], ids[i:i + rows], mask[i:i + rows])
        s = sum((o[k] * cot[k][i:i + rows]).sum() for k in OUT_KEYS)
        s.backward()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    grads["kg_proj"] = kg_proj.grad
    return float(total.detach()), {k: float(v.detach()) for k, v in terms.items()}, grads


class AdamW:
    """Clip, then AdamW, as the module docstring says. ``opt`` holds the
    schedule: lr, total_steps, warmup_frac, weight_decay, clip_norm,
    mu_bf16."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, opt: Mapping, params: Dict[str, torch.Tensor]):
        self.o = opt
        mu_dtype = torch.bfloat16 if opt["mu_bf16"] else torch.float32
        self.mu = {k: torch.zeros_like(v, dtype=mu_dtype) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def lr(self, count: int) -> float:
        o = self.o
        lr = o["lr"]
        warmup = max(1, int(o["total_steps"] * o["warmup_frac"]))
        if count < warmup:
            return lr * count / warmup
        decay = max(o["total_steps"], warmup + 1) - warmup
        c = min(count - warmup, decay)
        return lr * (0.99 * 0.5 * (1 + math.cos(math.pi * c / decay)) + 0.01)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> float:
        norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
        scale = self.o["clip_norm"] / norm if norm >= self.o["clip_norm"] else 1.0
        step_size = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k] * scale
            # b1 * mu in mu's dtype, b1 rounded to it (0.8984375 in bf16), as a
            # Python scalar times a bf16 array is in JAX; the sum in f32
            b1_mu = self.mu[k] * torch.tensor(self.b1, dtype=self.mu[k].dtype)
            mu = (1 - self.b1) * g + b1_mu.float()
            nu = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.o["weight_decay"] * p
            p.sub_(step_size * u)
            self.mu[k] = mu.to(self.mu[k].dtype)
            self.nu[k] = nu
        return norm
