"""EfficientNet-B0 vision encoder: MBConv blocks, GroupNorm in place of BatchNorm.

Counterpart of ``mmrp_tpu/models/efficientnet.py``: the B0 stage table, each
MBConv block expand (1x1) -> depthwise (k x k, the stride) -> squeeze-excite
over the pre-expansion width -> project (1x1), residual where the shapes
match; ``GroupNorm(8)`` and SiLU; a 1x1 head to 1,280 channels. Flax's
``SAME`` padding (``models/layers.py::pad_same``). NHWC in; the last map
flattens to patches (49 at 224 px) and ``global`` is their mean. JAX computes
this tower in XLA, outside any Pallas kernel: here ``F.conv2d``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import Conv, GroupNorm, nchw_to_tokens

# (expand_ratio, channels, num_blocks, stride, kernel): the B0 stage table
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


@dataclass(frozen=True)
class EfficientNetConfig:
    stem_channels: int = 32
    head_channels: int = 1280
    se_ratio: float = 0.25
    stages: Tuple[Tuple[int, int, int, int, int], ...] = _B0_STAGES

    @staticmethod
    def b0(**kw) -> "EfficientNetConfig":
        return EfficientNetConfig(**kw)

    @property
    def num_features(self) -> int:
        return self.head_channels

    def num_patches(self, img_size: int) -> int:
        """Positions of the last map: the stem and each stage's stride divide
        each side, rounding up (``SAME``); 49 at 224 px."""
        side = -(-img_size // 2)
        for _, _, _, stride, _ in self.stages:
            side = -(-side // stride)
        return side * side


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, strides: int, kernel: int,
                 se_ratio: float, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        mid = in_ch * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand = Conv(in_ch, mid, 1, **kw)
            self.expand_norm = GroupNorm(8, mid, **kw)
        self.depthwise = Conv(mid, mid, kernel, strides, groups=mid, **kw)
        self.dw_norm = GroupNorm(8, mid, **kw)
        se_dim = max(1, int(in_ch * se_ratio))  # over the pre-expansion width
        self.se_reduce = nn.Linear(mid, se_dim, **kw)
        self.se_expand = nn.Linear(se_dim, mid, **kw)
        self.project = Conv(mid, out_ch, 1, **kw)
        self.project_norm = GroupNorm(8, out_ch, **kw)
        self.residual = strides == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.expand_norm(self.expand(x))) if self.has_expand else x
        y = F.silu(self.dw_norm(self.depthwise(y)))
        s = y.float().mean(dim=(2, 3)).to(y.dtype)  # (B, mid)
        s = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(s))))
        y = y * s[:, :, None, None]
        y = self.project_norm(self.project(y))
        return x + y if self.residual else y


class EfficientNetEncoder(nn.Module):
    """NHWC image -> dict(patches (B, H*W, 1280), global (B, 1280))."""

    def __init__(self, config: EfficientNetConfig, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "EfficientNetEncoder")
        self.config = config
        kw = dict(dtype=dtype, device=device)
        self.stem = Conv(3, config.stem_channels, 3, 2, **kw)
        self.stem_norm = GroupNorm(8, config.stem_channels, **kw)
        ch = config.stem_channels
        for s, (expand, out_ch, n_blocks, stride, kernel) in enumerate(config.stages):
            for b in range(n_blocks):
                self.add_module(f"stage{s}_block{b}", MBConv(
                    ch, out_ch, expand, stride if b == 0 else 1, kernel, config.se_ratio,
                    dtype, device))
                ch = out_ch
        self.head = Conv(ch, config.head_channels, 1, **kw)
        self.head_norm = GroupNorm(8, config.head_channels, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        y = x.permute(0, 3, 1, 2).to(self.stem.weight.dtype)
        y = F.silu(self.stem_norm(self.stem(y)))
        for s, (_, _, n_blocks, _, _) in enumerate(self.config.stages):
            for b in range(n_blocks):
                y = self._modules[f"stage{s}_block{b}"](y)
        return nchw_to_tokens(F.silu(self.head_norm(self.head(y))))
