"""BERT-family text encoder (post-LN) on the fused-kernel route.

Counterpart of ``mmrp_tpu/models/text_encoder.py``: learned word + position +
token-type embeddings, then post-LN layers whose attention half is the fused
attention kernel (K3, ``ops/fused_attention.py``, ``ln_mode="post"``) and
whose FFN is plain GEMMs, as on the JAX serving route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import LayerNorm, MhaParams, gelu, ln_f32
from mmrp_tpu_torch.ops.fused_attention import fused_attention


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 28996
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_dim: int = 3072
    max_positions: int = 512
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

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.config
        # truncate to max positions, like the JAX encoder
        input_ids = input_ids[:, : cfg.max_positions]
        attention_mask = attention_mask[:, : cfg.max_positions]
        x = self.embeddings(input_ids)
        key_mask = additive_key_mask(attention_mask)
        for i in range(cfg.num_layers):
            x = self._modules[f"layer{i}"](x, key_mask)
        return {"tokens": x, "cls": x[:, 0, :]}
