"""ResNet vision encoder: bottleneck v1.5, GroupNorm in place of BatchNorm.

Counterpart of ``mmrp_tpu/models/resnet.py``: a 7x7/2 stem, a 3x3/2 max-pool,
Bottleneck stages (1x1 -> 3x3 with the stride -> 1x1 x4, a 1x1 projection on
the residual of each stage's first block), ``GroupNorm(32)`` after every conv,
Flax's ``SAME`` padding (``models/layers.py::pad_same``). NHWC in; the last
map flattens to patches (49 at 224 px) and ``global`` is their mean. JAX
computes this tower in XLA, outside any Pallas kernel: here ``F.conv2d``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import Conv, GroupNorm, max_pool_same, nchw_to_tokens


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # resnet50
    width: int = 64

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), **kw)

    @property
    def num_features(self) -> int:
        return self.width * 2 ** (len(self.stage_sizes) - 1) * 4  # 2048 for resnet50

    def num_patches(self, img_size: int) -> int:
        """Positions of the last map: the stem, the pool and each later stage
        halve each side, rounding up (``SAME``); 49 at 224 px."""
        side = img_size
        for _ in range(len(self.stage_sizes) + 1):
            side = -(-side // 2)
        return side * side


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(in_ch, filters, 1, **kw)
        self.bn1 = GroupNorm(32, filters, **kw)
        self.conv2 = Conv(filters, filters, 3, strides, **kw)
        self.bn2 = GroupNorm(32, filters, **kw)
        self.conv3 = Conv(filters, 4 * filters, 1, **kw)
        self.bn3 = GroupNorm(32, 4 * filters, **kw)
        # the residual is projected where its shape differs from the branch's
        self.has_down = in_ch != 4 * filters or strides != 1
        if self.has_down:
            self.down = Conv(in_ch, 4 * filters, 1, strides, **kw)
            self.bn_down = GroupNorm(32, 4 * filters, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.bn_down(self.down(x)) if self.has_down else x
        return torch.relu(residual + y)


class ResNetEncoder(nn.Module):
    """NHWC image -> dict(patches (B, H*W, F), global (B, F))."""

    def __init__(self, config: ResNetConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "ResNetEncoder")
        self.config = config
        kw = dict(dtype=dtype, device=device)
        self.stem = Conv(3, config.width, 7, 2, **kw)
        self.stem_bn = GroupNorm(32, config.width, **kw)
        ch = config.width
        for stage, n_blocks in enumerate(config.stage_sizes):
            for b in range(n_blocks):
                filters = config.width * 2 ** stage
                self.add_module(f"stage{stage}_block{b}", Bottleneck(
                    ch, filters, 2 if stage > 0 and b == 0 else 1, dtype, device))
                ch = 4 * filters

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        y = x.permute(0, 3, 1, 2).to(self.stem.weight.dtype)
        y = torch.relu(self.stem_bn(self.stem(y)))
        y = max_pool_same(y, 3, 2)
        for stage, n_blocks in enumerate(self.config.stage_sizes):
            for b in range(n_blocks):
                y = self._modules[f"stage{stage}_block{b}"](y)
        return nchw_to_tokens(y)
