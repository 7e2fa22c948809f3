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

from typing import Dict

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

    def linears(self):
        return (self.query, self.key, self.value, self.out)

    def weights(self, int8: bool = False):
        """(wq, bq, wk, bk, wv, bv, wo, bo) in the order the kernels take;
        with ``int8`` the weights are the int8 caches (``ops/quant.py``)."""
        return tuple(t for lin in self.linears()
                     for t in (lin.weight_q if int8 else lin.weight, lin.bias))

    def scales(self):
        """The int8 caches' per-output-channel scales, q/k/v/out."""
        return tuple(lin.weight_scale for lin in self.linears())


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


def remat(fn, generator: torch.Generator, *args):
    """``fn(*args, generator)`` under ``torch.utils.checkpoint``: its
    activations are dropped after the forward and recomputed in the backward
    (JAX's ``nn.remat``). The recomputation draws its dropout masks from a
    generator restored to the state ``generator`` had before the first call,
    so both passes see the same masks, and ``generator`` leaves in the state
    the first call left it in, as without remat."""
    from torch.utils.checkpoint import checkpoint

    start = generator.get_state()
    end = []

    def run(*a):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = fn(*a, g)
        if not end:
            end.append(g.get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end[0])
    return out


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

    weights = MlpParams.weights

    def forward(self, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
        x = gelu(self.Dense_0(x))
        if generator is not None:
            x = dropout(x, self.rate, generator)
        x = self.Dense_1(x)
        return x if generator is None else dropout(x, self.rate, generator)


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention``: ``query`` / ``key`` /
    ``value`` projections to ``num_heads`` heads (the Flax DenseGeneral
    kernels (D, h, d) as nn.Linear (h * d, D), heads contiguous), scores and
    softmax in f32 (``mask``: bool, True where a key may be attended,
    broadcastable to (B, h, Lq, Lk)), dropout on the weights in training
    (``generator`` given), the context rounded to the compute dtype, then the
    ``out`` projection."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.rate = dropout
        kw = dict(dtype=dtype, device=device)
        self.query = nn.Linear(dim, dim, **kw)
        self.key = nn.Linear(dim, dim, **kw)
        self.value = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor, mask=None,
                generator: torch.Generator = None) -> torch.Tensor:
        B, Lq, D = inputs_q.shape
        h = self.num_heads
        d = D // h
        q = self.query(inputs_q).reshape(B, Lq, h, d)
        k = self.key(inputs_kv).reshape(B, -1, h, d)
        v = self.value(inputs_kv).reshape(B, -1, h, d)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
        w = torch.softmax(scores, dim=-1)
        if generator is not None:
            w = dropout(w, self.rate, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v).to(q.dtype)
        return self.out(ctx.reshape(B, Lq, D))


class SelfAttentionBlock(nn.Module):
    """LN -> MHA -> residual (``layers.py::SelfAttentionBlock``): the generic
    full-attention block of the finetune head's enhancer; ``generator`` None
    runs it deterministic."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype, device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads, dropout, dtype, device)

    def forward(self, x: torch.Tensor, mask=None,
                generator: torch.Generator = None) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        return x + self.MultiHeadDotProductAttention_0(y, y, mask, generator)


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) padding of Flax / XLA ``padding="SAME"`` along one axis:
    the output has ceil(size / stride) positions and an odd total pad puts the
    extra element after (at 224 px a 3x3/2 conv pads (0, 1), a 7x7/2 (2, 3),
    where torch's ``padding=k // 2`` would pad both sides alike)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """``x`` (B, C, H, W) padded as Flax's ``SAME`` for a ``kernel`` x
    ``kernel`` window at ``stride`` (``value``: -inf for a max-pool)."""
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Conv2d):
    """Flax ``nn.Conv`` on NCHW tensors: a square kernel, ``SAME`` padding
    (:func:`pad_same`), optional groups (depthwise) and bias. The weight is
    torch's (out, in / groups, kh, kw), the Flax kernel (kh, kw, in / groups,
    out) transposed by ``utils/convert.py``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, groups=groups, bias=bias,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(pad_same(x, self.kernel_size[0], self.stride[0]))


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Flax ``nn.max_pool(..., padding="SAME")`` on NCHW: pads with -inf."""
    return F.max_pool2d(pad_same(x, window, stride, float("-inf")), window, stride)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` (eps 1e-6, not torch's 1e-5) on NCHW tensors:
    statistics and affine in f32, output cast to ``dtype``; ``weight`` /
    ``bias`` are Flax's ``scale`` / ``bias``."""

    def __init__(self, num_groups: int, dim: int, dtype: torch.dtype = torch.float32,
                 device=None, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


def nchw_to_tokens(y: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A conv tower's (B, C, H, W) output -> dict(patches (B, H*W, C) in
    row-major order, global: their mean)."""
    patches = y.flatten(2).transpose(1, 2)
    return {"patches": patches, "global": patches.float().mean(dim=1).to(patches.dtype)}
