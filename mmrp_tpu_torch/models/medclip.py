"""MedCLIP vision encoder: Swin-Tiny followed by a bias-free 512-wide projection.

Counterpart of ``mmrp_tpu/models/medclip.py``. MedCLIP's "ViT" vision tower
is an HF SwinModel (``microsoft/swin-tiny-patch4-window7-224``) with a
``projection_head`` Linear(768 -> 512, no bias): the port's ``SwinEncoder``
(its kernels included: K1 + K2 at C 96 / 192, the chain and the windows
blocks at 224 px) and one projection applied to both the patches and the
pooled vector. Weights: ``models/port.py::convert_medclip_vit``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder


class MedCLIPVisionEncoder(nn.Module):
    """NHWC image -> dict(patches (B, Np, 512), global (B, 512))."""

    def __init__(self, swin: SwinConfig, proj_dim: int = 512, dtype=torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "MedCLIPVisionEncoder")
        self.proj_dim = proj_dim
        self.swin = SwinEncoder(swin, dtype, device)
        self.projection = nn.Linear(swin.num_features, proj_dim, bias=False, dtype=dtype,
                                    device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        feats = self.swin(x, deterministic, generator)
        # one head for both: pool-then-project equals project-then-pool
        return {"patches": self.projection(feats["patches"]),
                "global": self.projection(feats["global"])}
