"""Train state and optimizers: AdamW with warmup-cosine on f32 master weights,
and the constant-rate Adam / AdamW of the other trainers.

Counterpart of ``mmrp_tpu/train/state.py``. :class:`Adam` is ``optax.adam``
(the KG and LabelAttention trainers) and ``optax.adamw`` with its default
weight decay 1e-4 (the Swin finetune's two rates), operation for operation.
:func:`make_optimizer` reproduces
optax 0.2.6's ``chain(clip_by_global_norm(clip_norm), adamw(schedule,
weight_decay, mu_dtype))`` with ``warmup_cosine_decay_schedule``, operation
for operation:

- schedule: ``warmup = max(1, int(total_steps * warmup_frac))``, linear from 0
  to ``lr`` over the warmup, then cosine down to ``0.01 * lr`` at
  ``max(total_steps, warmup + 1)``; it reads the count *before* the
  increment, so the first update has step size 0;
- clip: where the global norm ``g`` of the gradients is at least
  ``clip_norm``, each gradient becomes ``t / g * clip_norm``;
- moments, in f32 against the stored ``mu``: ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``; bias corrections with the incremented
  count; update ``mu_hat / (sqrt(nu_hat) + 1e-8) + weight_decay * p`` times
  ``-lr(count)``; ``mu`` is rounded to bf16 (``mu_bf16``) only after the
  update has used its f32 value; weight decay applies to every parameter.

Master weights. The model keeps its serving dtypes: bf16 dense weights,
embeddings and positional tables, f32 LayerNorms, ``rel_bias_table``,
``alpha`` and ``cls_out``. The state keeps an f32 master of every parameter,
plus ``kg_proj``, and Adam's ``mu`` and ``nu`` beside it. Each step runs the
forward and backward in the model's dtypes, casts the gradients to f32,
clips and updates the master, and copies the master back into the model's
parameters (rounding to bf16 where the parameter is bf16). That gives the JAX
trainer's numbers, whose f32 parameters are cast to bf16 at each use: the VJP
of ``w.astype(bf16)`` is the bf16 cotangent cast up. A parameter the model
already holds in f32 is its own master: the state holds that same tensor,
and the update changes it in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar, Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


@dataclass(frozen=True)
class AdamW:
    """The optimizer of :func:`make_optimizer`: a schedule and one update rule."""

    lr: float
    total_steps: int
    warmup_frac: float = 0.1
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    mu_bf16: bool = False
    # optax.adamw's defaults, which make_optimizer leaves as they are
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8

    @property
    def warmup(self) -> int:
        return max(1, int(self.total_steps * self.warmup_frac))

    def schedule(self, count: int) -> float:
        """The learning rate at optimizer count ``count`` (0 for the first
        update), in f32 as optax computes it."""
        warmup = self.warmup
        if count < warmup:
            frac = 1 - _f32(min(max(count, 0), warmup)) / warmup
            return float((0.0 - self.lr) * frac + self.lr)
        decay = float(max(self.total_steps, warmup + 1) - warmup)
        alpha = self.lr * 0.01 / self.lr
        c = torch.clamp(_f32(count - warmup), max=decay)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay))
        return float(self.lr * ((1 - alpha) * cosine + alpha))

    def init(self, params: Params) -> Tuple[Params, Params]:
        mu_dtype = torch.bfloat16 if self.mu_bf16 else torch.float32
        return ({k: torch.zeros_like(p, dtype=mu_dtype) for k, p in params.items()},
                {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()})

    @torch.no_grad()
    def apply(self, state: "TrainState", grads: Params, norm: float = None) -> float:
        """One update of ``state`` in place from ``grads`` (any float dtype;
        each is cast to f32). Returns the global norm of the unclipped
        gradients. Every step is one ``torch._foreach_*`` op over all the
        parameters, in optax's order of operations; only the dtype casts go
        tensor by tensor. ``norm``: the global norm of the whole gradients,
        where ``state`` and ``grads`` hold one rank's blocks of sharded
        parameters (``train/joint.py::make_train_step_dp``)."""
        keys = list(state.params)
        params = [state.params[k] for k in keys]
        g = [grads[k].float() for k in keys]
        if norm is None:
            norm = float(global_norm(g))
        if norm >= self.clip_norm:
            g = torch._foreach_div(g, norm)
            torch._foreach_mul_(g, self.clip_norm)
        count = state.count + 1
        step_size = -self.schedule(state.count)
        bc1 = float(1 - _f32(self.b1) ** count)
        bc2 = float(1 - _f32(self.b2) ** count)
        mu_dtype = torch.bfloat16 if self.mu_bf16 else torch.float32
        # mu = (1 - b1) g + b1 mu: b1 mu in mu's dtype, with b1 cast to it as
        # JAX casts a Python scalar (0.8984375 for bf16), then the sum in f32
        b1_mu = torch._foreach_mul([state.mu[k] for k in keys],
                                   float(torch.tensor(self.b1, dtype=mu_dtype)))
        mu = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(mu, [t.float() for t in b1_mu])
        # nu = (1 - b2) g^2 + b2 nu, in f32
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul([state.nu[k] for k in keys], self.b2))
        # u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay p;  p += -lr u
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(u, step_size)
        torch._foreach_add_(params, u)
        for k, m, n in zip(keys, mu, nu):
            state.mu[k] = m.to(mu_dtype)  # rounded only after the update used it
            state.nu[k] = n
        state.count = count
        return norm


@dataclass
class AdamState:
    """Adam's moments ``mu`` / ``nu`` (f32, the parameters' names) and count."""

    mu: Params
    nu: Params
    count: int = 0


@dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)`` (``weight_decay`` 0) or ``optax.adamw(lr)`` (its
    default ``weight_decay`` 1e-4, decoupled: ``wd * p`` is added to the
    update before the rate scales it), at a constant rate, eps 1e-8, betas
    (0.9, 0.999), no clipping. Unlike ``torch.optim.AdamW`` the decay is
    scaled by the rate once, not folded in as ``p *= 1 - lr * wd``."""

    lr: float
    weight_decay: float = 0.0
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8

    def init(self, params: Params) -> AdamState:
        return AdamState({k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                         {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Params, grads: Params, opt: AdamState,
             mask: Dict[str, float] = None) -> None:
        """One update of ``params`` (f32, in place) and ``opt`` from ``grads``
        (f32). ``mask`` (name -> 0.0 / 1.0, as the finetune's freeze masks)
        multiplies each gradient before the moments and each update after
        them: a frozen parameter is neither decayed nor moved."""
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        if mask is not None:
            g = [t * mask[k] for t, k in zip(g, keys)]
        count = opt.count + 1
        bc1 = float(1 - _f32(self.b1) ** count)
        bc2 = float(1 - _f32(self.b2) ** count)
        mu = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul([opt.mu[k] for k in keys], self.b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul([opt.nu[k] for k in keys], self.b2))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -self.lr)
        if mask is not None:
            u = [t * mask[k] for t, k in zip(u, keys)]
        torch._foreach_add_(p, u)
        for k, m, n in zip(keys, mu, nu):
            opt.mu[k], opt.nu[k] = m, n
        opt.count = count


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of f32 ``tensors`` (a
    0-dim tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def make_optimizer(lr: float, total_steps: int, warmup_frac: float = 0.1,
                   weight_decay: float = 0.01, clip_norm: float = 1.0,
                   mu_bf16: bool = False) -> AdamW:
    """Clip, then AdamW on the warmup-cosine schedule (module docstring)."""
    return AdamW(lr, total_steps, warmup_frac, weight_decay, clip_norm, mu_bf16)


@dataclass
class TrainState:
    """f32 master ``params`` (the model's parameter names, plus ``kg_proj``),
    Adam's ``mu`` and ``nu``, the optimizer ``count`` (updates taken so far,
    the JAX ``TrainState.step``), the base ``seed`` of the per-step dropout
    generator and the optimizer ``tx``."""

    params: Params
    mu: Params
    nu: Params
    count: int
    seed: int
    tx: AdamW

    def step_generator(self, device) -> torch.Generator:
        """The dropout generator of the next step, seeded from (seed, count):
        the JAX ``fold_in(base_rng, step)`` idea, with other bits."""
        bits = np.random.SeedSequence([self.seed, self.count]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(bits))


def master_params(model: nn.Module) -> Params:
    """f32 masters of ``model``'s parameters under their names: an f32
    parameter is its own master (the same tensor), any other is copied up."""
    return {name: p.detach() if p.dtype == torch.float32 else p.detach().float()
            for name, p in model.named_parameters()}


def make_write_back(model: nn.Module):
    """``write_back(params)``: the masters of the parameters the model holds
    in another dtype copied into them (rounded), then every Swin block's
    serving bias rebuilt from its table and every int8 weight cache from its
    weight, so that the serving route reads the new weights."""
    from mmrp_tpu_torch.models.swin import WindowAttention
    from mmrp_tpu_torch.ops.quant import int8_linears, refresh_int8

    named = dict(model.named_parameters())
    windows = [m for m in model.modules() if isinstance(m, WindowAttention)]
    int8 = [lin for _, lin in int8_linears(model)]

    @torch.no_grad()
    def write_back(params: Params) -> None:
        pairs = [(p, params[name]) for name, p in named.items()
                 if params[name].data_ptr() != p.data_ptr()]
        if pairs:
            torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])
        for m in windows:
            m.refresh_bias()
        for lin in int8:
            refresh_int8(lin)

    return write_back
