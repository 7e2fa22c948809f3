"""BERT-family text encoder (post-LN) on the fused-kernel route.

Counterpart of ``mmrp_tpu/models/text_encoder.py``: learned word + position +
token-type embeddings, then post-LN layers whose attention half is the fused
attention kernel (K3, ``ops/fused_attention.py``, ``ln_mode="post"``) and
whose FFN is plain GEMMs, as on the JAX serving route. Training
(``deterministic=False``) takes the JAX XLA branch with dropout
(``text_encoder.py:149-178, 210-214``): plain q/k/v GEMMs, f32 scores and
softmax, dropout on the probabilities, after the output GEMM and after the FFN.

``TextConfig.quant`` sets the serving precision, with the JAX meanings
(``text_encoder.py:37-41, 115-178, 205-209``): "int8" runs every GEMM in
W8A8 on the XLA branch (``ops/quant.py``); "int8_ffn" keeps the bf16 K3 and
runs the FFN in W8A8; "int8_kernel" runs K3 with its in-kernel W8A8
projections and the FFN in W8A8. Training stays full precision.

The attention's route is fixed at construction (:func:`attention_route`):
``kernel`` where K3 takes the width, heads and ``max_positions`` tokens,
``plain`` (K3's plain version, counted in ``fused_attention.plain_calls``)
where it does not, ``int8`` for the XLA W8A8 branch.

Given a :class:`~mmrp_tpu_torch.ops.fused_attention.Packed` plan of the
batch's valid lengths (:func:`pack_text`), the serving forward runs packed:
every report's valid tokens back to back in T rows, K3's packed form, the
FFN and LayerNorms on T rows; ``tokens`` is then (T, D). Counters
(``utils/trace.py::count``): ``text.packed`` / ``text.padded``, the forwards
of each route, and ``text.rows`` / ``text.rows_padded``, the rows run and the
B x L the padded route runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import LayerNorm, MhaParams, dropout, gelu, ln_f32, remat
from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops import fused_attention as K3
from mmrp_tpu_torch.ops.fused_attention import (
    Packed,
    attention_plain,
    attention_plain_packed,
    fused_attention,
    fused_attention_packed,
    pack,
)
from mmrp_tpu_torch.ops.quant import attach_int8, quant_dot, quant_dot_multi
from mmrp_tpu_torch.utils.trace import count


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 28996
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_dim: int = 3072
    max_positions: int = 512
    dropout: float = 0.1  # training only
    type_vocab_size: int = 2
    quant: str = "none"  # serving: none | int8 | int8_ffn | int8_kernel (module docstring)

    @staticmethod
    def clinicalbert(**kw) -> "TextConfig":
        return TextConfig(**kw)

    @staticmethod
    def small(**kw) -> "TextConfig":
        defaults = dict(vocab_size=8192, hidden_dim=256, num_layers=4, num_heads=4,
                        intermediate_dim=1024, max_positions=512)
        defaults.update(kw)
        return TextConfig(**defaults)


QUANTS = ("none", "int8", "int8_ffn", "int8_kernel")


def attention_route(config: TextConfig) -> str:
    """The BERT layers' attention: "int8" (the XLA branch with W8A8 GEMMs),
    else "kernel" where K3 takes every text length up to ``max_positions``,
    else "plain"."""
    if config.quant == "int8":
        return "int8"
    D, L = config.hidden_dim, config.max_positions
    return "kernel" if K3.kernel_takes(D, config.num_heads, L, L) else "plain"


def qlinear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` as a W8A8 GEMM on its int8 cache (``ops/quant.quant_dot``)."""
    return quant_dot(x, lin.weight_q, lin.bias, wscale=lin.weight_scale)


def qlinear_multi(x: torch.Tensor, lins) -> list:
    """Several cached linears on one activation tensor, quantized once."""
    return quant_dot_multi(x, [(lin.weight_q, lin.bias) for lin in lins],
                           wscales=[lin.weight_scale for lin in lins])


def prefix_lengths(mask: np.ndarray) -> Optional[np.ndarray]:
    """Each row's length where every row of the host mask (B, L) is a prefix
    of at least one valid token; else None."""
    mask = np.asarray(mask) != 0
    if mask.ndim != 2 or mask.shape[1] == 0:
        return None
    lengths = mask.sum(1)
    if lengths.min() < 1 or not (mask == (np.arange(mask.shape[1]) < lengths[:, None])).all():
        return None
    return lengths


def pack_text(lengths: np.ndarray, width: int, device) -> Optional[Packed]:
    """The packed plan of a batch of prefix ``lengths`` (host) padded to
    ``width`` tokens (those past ``width`` cut, as the encoder cuts them),
    or None where the batch holds no padding."""
    lengths = np.minimum(lengths, width)
    if lengths.sum() >= len(lengths) * width:
        return None
    return pack(lengths, width, device)


def run_attention(route: str, *args, **kwargs):
    """K3 on a kernel route, its plain version (counted) on a plain one; the
    packed form where ``rows`` or ``kv_rows`` is given."""
    packed = kwargs.get("rows") is not None or kwargs.get("kv_rows") is not None
    if route == "kernel":
        return (fused_attention_packed if packed else fused_attention)(*args, **kwargs)
    plain = attention_plain_packed if packed else attention_plain
    return _build.run_plain(fused_attention, plain, *args, **kwargs)


def additive_key_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) 0/1 validity -> (B, N) additive f32 (0 / -1e9)."""
    return torch.where(mask > 0, 0.0, -1e9).to(torch.float32)


def mha_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              key_mask, rate: float, generator: torch.Generator,
              return_weights: bool = False):
    """The JAX models' XLA attention with dropout: q (B, Lq, D), k/v (B, Lk, D)
    projected, scores and softmax in f32 (+ additive (B, Lk) ``key_mask``),
    dropout on the probabilities, which are rounded to v's dtype for the
    product; the context is summed in f32 and rounded to q's dtype. With
    ``return_weights``: (context, the f32 softmax (B, h, Lq, Lk) before
    dropout)."""
    B, Lq, D = q.shape
    h, d = num_heads, D // num_heads
    q, k, v = q.reshape(B, Lq, h, d), k.reshape(B, -1, h, d), v.reshape(B, -1, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    if key_mask is not None:
        scores = scores + key_mask.float()[:, None, None, :]
    weights = torch.softmax(scores, dim=-1)
    p = dropout(weights, rate, generator)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype).reshape(B, Lq, D)
    return (ctx, weights) if return_weights else ctx


class BertEmbeddings(nn.Module):
    def __init__(self, config: TextConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.word = nn.Embedding(config.vocab_size, config.hidden_dim, **kw)
        self.position = nn.Embedding(config.max_positions, config.hidden_dim, **kw)
        self.token_type = nn.Embedding(config.type_vocab_size, config.hidden_dim, **kw)
        self.LayerNorm_0 = LayerNorm(config.hidden_dim, dtype, device)

    def forward(self, input_ids: torch.Tensor,
                pos_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``pos_ids``: each token's position, else 0 .. L - 1 along dim 1."""
        if pos_ids is None:
            pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = self.word(input_ids) + self.position(pos_ids) \
            + self.token_type(torch.zeros_like(input_ids))
        return self.LayerNorm_0(x)


class BertLayer(nn.Module):
    """LN(x + attn(x)) through K3, then LN(x + FFN(x)); ``config.quant``
    picks the W8A8 GEMMs (module docstring)."""

    def __init__(self, config: TextConfig, dtype=torch.float32, device=None):
        super().__init__()
        if config.quant not in QUANTS:
            raise ValueError(f"TextConfig.quant must be one of {QUANTS}, got {config.quant!r}")
        D = config.hidden_dim
        self.num_heads = config.num_heads
        self.quant = config.quant
        self.route = attention_route(config)
        self.attention = MhaParams(D, dtype, device)
        self.attn_norm = LayerNorm(D, dtype, device)
        self.ffn_in = nn.Linear(D, config.intermediate_dim, dtype=dtype, device=device)
        self.ffn_out = nn.Linear(config.intermediate_dim, D, dtype=dtype, device=device)
        self.ffn_norm = LayerNorm(D, dtype, device)
        # int8 caches: the XLA branch's quant_dot quantizes the f32 parameters
        # (from_master); K3's in-kernel _qdot the weights it is given
        if config.quant != "none":
            for lin in (self.ffn_in, self.ffn_out):
                attach_int8(lin, from_master=True)
        if config.quant in ("int8", "int8_kernel"):
            for lin in self.attention.linears():
                attach_int8(lin, from_master=config.quant == "int8")

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor],
                rows: Optional[Packed] = None) -> torch.Tensor:
        """x: (B, L, D); key_mask: (B, L) additive f32 (0 valid / -1e9 pad).
        With ``rows``: x (T, D) packed, no key mask, bf16 weights only."""
        if rows is not None and self.quant != "none":
            raise ValueError("BertLayer: the packed form runs the bf16 weights only")
        if self.route == "int8":
            a = self.attention
            q, k, v = qlinear_multi(x, (a.query, a.key, a.value))
            ctx = mha_train(q, k, v, self.num_heads, key_mask, 0.0, None)
            x = ln_f32(x + qlinear(ctx, a.out), self.attn_norm.weight, self.attn_norm.bias,
                       x.dtype)
        else:
            q8 = self.quant == "int8_kernel"
            # in grad mode K3's W8A8 gradient route takes the float weights
            # (ops/_build.py::quant_grad_route), which the kernel quantizes to
            # the numbers of their int8 caches
            c8 = q8 and not torch.is_grad_enabled()
            args = (x, self.attn_norm.weight, self.attn_norm.bias, *self.attention.weights(c8))
            keys = dict(rows=rows) if rows is not None else dict(
                key_mask=key_mask, quant=q8, wscales=self.attention.scales() if c8 else None)
            x = run_attention(self.route, *args, **keys, num_heads=self.num_heads,
                              ln_mode="post")
        if self.quant == "none":
            y = self.ffn_out(gelu(self.ffn_in(x)))
        else:
            y = qlinear(gelu(qlinear(x, self.ffn_in)), self.ffn_out)
        return ln_f32(x + y, self.ffn_norm.weight, self.ffn_norm.bias, x.dtype)

    def forward_train(self, x: torch.Tensor, key_mask: torch.Tensor, rate: float,
                      generator: torch.Generator) -> torch.Tensor:
        a = self.attention
        ctx = mha_train(a.query(x), a.key(x), a.value(x), self.num_heads, key_mask, rate,
                        generator)
        y = dropout(a.out(ctx), rate, generator)
        x = ln_f32(x + y, self.attn_norm.weight, self.attn_norm.bias, x.dtype)
        y = dropout(self.ffn_out(gelu(self.ffn_in(x))), rate, generator)
        return ln_f32(x + y, self.ffn_norm.weight, self.ffn_norm.bias, x.dtype)


class TextEncoder(nn.Module):
    """(ids, mask) -> dict(tokens (B, L, D), cls (B, D)). Built on the card
    unless ``device`` names another."""

    def __init__(self, config: TextConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "TextEncoder")
        self.config = config
        self.remat = False  # training: each layer under activation checkpointing
        self.embeddings = BertEmbeddings(config, dtype, device)
        for i in range(config.num_layers):
            self.add_module(f"layer{i}", BertLayer(config, dtype, device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                deterministic: bool = True, generator: torch.Generator = None,
                rows: Optional[Packed] = None) -> Dict[str, torch.Tensor]:
        """``deterministic=False`` takes the training route, with dropout
        drawn from ``generator``. ``rows`` (serving): the packed route, whose
        ``tokens`` are each report's valid rows back to back (T, D)."""
        cfg = self.config
        # truncate to max positions, like the JAX encoder
        input_ids = input_ids[:, : cfg.max_positions]
        attention_mask = attention_mask[:, : cfg.max_positions]
        B, L = input_ids.shape
        count("text.packed" if rows is not None else "text.padded")
        count("text.rows", rows.T if rows is not None else B * L)
        count("text.rows_padded", B * L)
        if rows is not None:
            if not deterministic or rows.width != L:
                raise ValueError(f"TextEncoder: a packed plan of width {rows.width} for "
                                 f"{L} tokens, deterministic={deterministic}")
            ids = input_ids[:, : rows.max_len].reshape(-1).index_select(0, rows.slot)
            x = self.embeddings(ids, rows.pos)
            for i in range(cfg.num_layers):
                x = self._modules[f"layer{i}"](x, None, rows)
            return {"tokens": x, "cls": x.index_select(0, rows.offsets[:-1])}
        x = self.embeddings(input_ids)
        key_mask = additive_key_mask(attention_mask)
        if not deterministic:
            if generator is None:
                raise ValueError("TextEncoder: the training route needs a torch.Generator")
            x = dropout(x, cfg.dropout, generator)
        for i in range(cfg.num_layers):
            layer = self._modules[f"layer{i}"]
            if deterministic:
                x = layer(x, key_mask)
            elif self.remat:
                x = remat(lambda x, g, m=layer: m.forward_train(x, key_mask, cfg.dropout, g),
                          generator, x)
            else:
                x = layer.forward_train(x, key_mask, cfg.dropout, generator)
        return {"tokens": x, "cls": x[:, 0, :]}
