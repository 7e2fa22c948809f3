"""Shared building blocks: f32 LayerNorms, sinusoidal positions, parameter holders.

Counterpart of ``mmrp_tpu/models/layers.py``. Parameters keep the Flax tree's
names (``LayerNorm_0``, ``query``/``key``/``value``/``out``, ``Dense_0``) so
that every port module maps onto its JAX module path; dense weights use the
nn.Linear (out, in) layout (``utils/convert.py`` transposes Flax kernels).

Dtypes follow the JAX model's casts: dense weights and biases live in the
compute dtype (the JAX model casts them to it at every use), LayerNorm
parameters stay f32. Training keeps f32 master copies outside the model
(``train/state.py``). Dropout and DropPath draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           out_dtype: torch.dtype, affine_in_f32: bool = False,
           eps: float = 1e-6) -> torch.Tensor:
    """The hand-rolled f32 LayerNorm of the JAX model's unfused paths:
    two-pass statistics in f32, then the affine in ``out_dtype`` after the
    cast (default) or in f32 before it (``affine_in_f32``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    if affine_in_f32:
        return (n * scale.float() + bias.float()).to(out_dtype)
    n = n.to(out_dtype)
    return n * scale.to(out_dtype) + bias.to(out_dtype)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Classic sin/cos positional table (length, dim) f32."""
    pos = np.arange(length)[:, None].astype(np.float64)
    half = (dim + 1) // 2
    div = np.exp(np.arange(half).astype(np.float64) * (-2.0 * np.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: dim // 2])
    return table


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` (eps 1e-6): f32 statistics and affine, output
    cast to ``dtype``. Also the holder of LN parameters that a fused kernel
    consumes directly (``weight``/``bias``, f32)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class MhaParams(nn.Module):
    """query/key/value/out projections (``MhaParams`` of the JAX model): the
    parameters a fused attention kernel consumes."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.query = nn.Linear(dim, dim, **kw)
        self.key = nn.Linear(dim, dim, **kw)
        self.value = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)

    def weights(self):
        """(wq, bq, wk, bk, wv, bv, wo, bo) in the order the kernels take."""
        return (self.query.weight, self.query.bias, self.key.weight, self.key.bias,
                self.value.weight, self.value.bias, self.out.weight, self.out.bias)


class MlpParams(nn.Module):
    """Dense_0 (dim -> hidden) / Dense_1 (hidden -> dim) of a transformer MLP."""

    def __init__(self, hidden: int, dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden, dtype=dtype, device=device)
        self.Dense_1 = nn.Linear(hidden, dim, dtype=dtype, device=device)

    def weights(self):
        """(w1, b1, w2, b2) in the order the kernels take."""
        return (self.Dense_0.weight, self.Dense_0.bias, self.Dense_1.weight,
                self.Dense_1.bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Flax ``nn.Dropout`` in training: keep each element with probability
    1 - rate, drawn from ``generator`` (never the global one), and compute
    ``where(mask, x / keep, 0)``. Rate 0 returns x."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth in training (``layers.py::DropPath`` of the JAX
    model): one keep/drop draw per sample for the whole residual branch,
    ``where(mask, x / keep, 0)``; identity at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    """Transformer MLP (``layers.py::Mlp``): dense -> GELU -> dropout ->
    dense -> dropout; ``generator`` None runs it deterministic."""

    def __init__(self, dim: int, hidden: int, out_dim: int = 0, rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.rate = rate
        self.Dense_0 = nn.Linear(dim, hidden, dtype=dtype, device=device)
        self.Dense_1 = nn.Linear(hidden, out_dim or dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
        x = gelu(self.Dense_0(x))
        if generator is not None:
            x = dropout(x, self.rate, generator)
        x = self.Dense_1(x)
        return x if generator is None else dropout(x, self.rate, generator)
