"""ViT vision encoder: a plain pre-LN ViT.

Counterpart of ``mmrp_tpu/models/vit.py``: a conv patch embed (Flax ``SAME``
padding), a cls token and learned positions (f32, cast to the compute dtype),
pre-LN blocks of Flax ``nn.MultiHeadDotProductAttention`` (per-head kernels
(in, heads, head_dim) / (heads, head_dim, out), mapped by
``utils/convert.py``) and the transformer MLP, a final LayerNorm. ``global``
is the cls token, ``patches`` the rest. JAX computes this tower in XLA,
outside any Pallas kernel: here plain PyTorch, dropout drawn from the
``generator`` in training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import Conv, LayerNorm, Mlp, MultiHeadDotProductAttention


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout: float = 0.0

    @staticmethod
    def small(**kw) -> "ViTConfig":
        d = dict(hidden_dim=192, num_layers=4, num_heads=3, mlp_dim=768)
        d.update(kw)
        return ViTConfig(**d)

    @property
    def num_features(self) -> int:
        return self.hidden_dim

    @property
    def num_patches(self) -> int:
        return (-(-self.img_size // self.patch_size)) ** 2  # SAME: ceil per side


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype, device):
        super().__init__()
        D = cfg.hidden_dim
        self.LayerNorm_0 = LayerNorm(D, dtype, device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            D, cfg.num_heads, cfg.dropout, dtype, device)
        self.LayerNorm_1 = LayerNorm(D, dtype, device)
        self.Mlp_0 = Mlp(D, cfg.mlp_dim, rate=cfg.dropout, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(y, y, None, generator)
        return x + self.Mlp_0(self.LayerNorm_1(x), generator)


class ViTEncoder(nn.Module):
    """NHWC image -> dict(patches (B, Np, F), global (B, F): the cls token)."""

    def __init__(self, config: ViTConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "ViTEncoder")
        self.config = config
        D = config.hidden_dim
        self.patch_embed = Conv(3, D, config.patch_size, config.patch_size, bias=True,
                                dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, config.num_patches + 1, D, device=device))
        for i in range(config.num_layers):
            self.add_module(f"block{i}", ViTBlock(config, dtype, device))
        self.norm = LayerNorm(D, dtype, device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        dt = self.patch_embed.weight.dtype
        y = self.patch_embed(x.permute(0, 3, 1, 2).to(dt)).flatten(2).transpose(1, 2)
        B, _, D = y.shape
        y = torch.cat([self.cls_token.to(dt).expand(B, 1, D), y], dim=1)
        y = y + self.pos_embed.to(dt)
        g = None if deterministic else generator
        for i in range(self.config.num_layers):
            y = self._modules[f"block{i}"](y, g)
        y = self.norm(y)
        return {"patches": y[:, 1:, :], "global": y[:, 0, :]}
