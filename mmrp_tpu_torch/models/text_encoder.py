"""BERT-family text encoder (post-LN) on the fused-kernel route.

Counterpart of ``mmrp_tpu/models/text_encoder.py``: learned word + position +
token-type embeddings, then post-LN layers whose attention half is the fused
attention kernel (K3, ``ops/fused_attention.py``, ``ln_mode="post"``) and
whose FFN is plain GEMMs, as on the JAX serving route. Training
(``deterministic=False``) takes the JAX XLA branch with dropout
(``text_encoder.py:149-178, 210-214``): plain q/k/v GEMMs, f32 scores and
softmax, dropout on the probabilities, after the output GEMM and after the FFN.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import LayerNorm, MhaParams, dropout, gelu, ln_f32
from mmrp_tpu_torch.ops.fused_attention import fused_attention


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

    @staticmethod
    def clinicalbert(**kw) -> "TextConfig":
        return TextConfig(**kw)

    @staticmethod
    def small(**kw) -> "TextConfig":
        defaults = dict(vocab_size=8192, hidden_dim=256, num_layers=4, num_heads=4,
                        intermediate_dim=1024, max_positions=512)
        defaults.update(kw)
        return TextConfig(**defaults)


def additive_key_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) 0/1 validity -> (B, N) additive f32 (0 / -1e9)."""
    return torch.where(mask > 0, 0.0, -1e9).to(torch.float32)


def mha_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              key_mask, rate: float, generator: torch.Generator) -> torch.Tensor:
    """The JAX models' XLA attention with dropout: q (B, Lq, D), k/v (B, Lk, D)
    projected, scores and softmax in f32 (+ additive (B, Lk) ``key_mask``),
    dropout on the probabilities, which are rounded to v's dtype for the
    product; the context is summed in f32 and rounded to q's dtype."""
    B, Lq, D = q.shape
    h, d = num_heads, D // num_heads
    q, k, v = q.reshape(B, Lq, h, d), k.reshape(B, -1, h, d), v.reshape(B, -1, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    if key_mask is not None:
        scores = scores + key_mask.float()[:, None, None, :]
    p = dropout(torch.softmax(scores, dim=-1), rate, generator)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype).reshape(B, Lq, D)


class BertEmbeddings(nn.Module):
    def __init__(self, config: TextConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.word = nn.Embedding(config.vocab_size, config.hidden_dim, **kw)
        self.position = nn.Embedding(config.max_positions, config.hidden_dim, **kw)
        self.token_type = nn.Embedding(config.type_vocab_size, config.hidden_dim, **kw)
        self.LayerNorm_0 = LayerNorm(config.hidden_dim, dtype, device)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        L = input_ids.shape[1]
        pos_ids = torch.arange(L, device=input_ids.device)[None, :]
        x = self.word(input_ids) + self.position(pos_ids) \
            + self.token_type(torch.zeros_like(input_ids))
        return self.LayerNorm_0(x)


class BertLayer(nn.Module):
    """LN(x + attn(x)) through K3, then LN(x + FFN(x))."""

    def __init__(self, config: TextConfig, dtype=torch.float32, device=None):
        super().__init__()
        D = config.hidden_dim
        self.num_heads = config.num_heads
        self.attention = MhaParams(D, dtype, device)
        self.attn_norm = LayerNorm(D, dtype, device)
        self.ffn_in = nn.Linear(D, config.intermediate_dim, dtype=dtype, device=device)
        self.ffn_out = nn.Linear(config.intermediate_dim, D, dtype=dtype, device=device)
        self.ffn_norm = LayerNorm(D, dtype, device)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """x: (B, L, D); key_mask: (B, L) additive f32 (0 valid / -1e9 pad)."""
        x = fused_attention(x, self.attn_norm.weight, self.attn_norm.bias,
                            *self.attention.weights(), key_mask=key_mask,
                            num_heads=self.num_heads, ln_mode="post")
        y = self.ffn_out(gelu(self.ffn_in(x)))
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
        self.embeddings = BertEmbeddings(config, dtype, device)
        for i in range(config.num_layers):
            self.add_module(f"layer{i}", BertLayer(config, dtype, device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """``deterministic=False`` takes the training route, with dropout
        drawn from ``generator``."""
        cfg = self.config
        # truncate to max positions, like the JAX encoder
        input_ids = input_ids[:, : cfg.max_positions]
        attention_mask = attention_mask[:, : cfg.max_positions]
        x = self.embeddings(input_ids)
        key_mask = additive_key_mask(attention_mask)
        if not deterministic:
            if generator is None:
                raise ValueError("TextEncoder: the training route needs a torch.Generator")
            x = dropout(x, cfg.dropout, generator)
        for i in range(cfg.num_layers):
            layer = self._modules[f"layer{i}"]
            x = layer(x, key_mask) if deterministic else \
                layer.forward_train(x, key_mask, cfg.dropout, generator)
        return {"tokens": x, "cls": x[:, 0, :]}
