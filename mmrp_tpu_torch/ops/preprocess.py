"""Batched on-device DICOM preprocessing + augmentation.

Counterpart of ``mmrp_tpu/ops/preprocess.py``: the math after decode
(window/level, resize, 3-channel expansion, mean/std; rotation and flip
augmentation) over a whole batch, as plain tensor functions on the batch's
device. The JAX package computes them in XLA outside any Pallas kernel, so
no kernel of the port stands behind them.

``preprocess_batch`` takes raw decoded pixel batches (B, H, W) float32 and
emits model-ready NHWC tensors. Its resize is
``F.interpolate(..., "bilinear", antialias=True)`` at every size: JAX's
``jax.image.resize(..., "bilinear")`` widens its triangle kernel by the scale
when it shrinks an image (antialiasing), which a plain bilinear resize does
not (``tests/test_torch_data.py`` shows the two far apart at 1024 -> 224).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def window_normalize(raw: torch.Tensor, window_center: torch.Tensor,
                     window_width: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 raw pixels, (B,) centers and widths -> per-sample
    window/level clip scaled to [0, 1]. The one copy of the windowing math,
    shared by ``preprocess_batch`` and the stream's compact ingest
    (``serve/stream.py``)."""
    lower = (window_center - window_width / 2.0)[:, None, None]
    upper = (window_center + window_width / 2.0)[:, None, None]
    x = torch.minimum(torch.maximum(raw, lower), upper)
    return (x - lower) / torch.clamp(upper - lower, min=1e-8)


def preprocess_batch(raw: torch.Tensor, window_center: torch.Tensor,
                     window_width: torch.Tensor, out_hw: Tuple[int, int] = (224, 224),
                     mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """window -> [0, 1] -> resize -> normalize -> 3 channels: (B, H', W', 3)."""
    x = window_normalize(raw, window_center, window_width)
    x = F.interpolate(x[:, None], size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=True)[:, 0]
    x = (x - mean) / std
    return x[..., None].repeat(1, 1, 1, 3)


def augment_batch(images: torch.Tensor, generator: Optional[torch.Generator],
                  max_rotate_deg: float = 5.0, hflip_prob: float = 0.1) -> torch.Tensor:
    """A rotation within ±``max_rotate_deg`` and a horizontal flip with
    probability ``hflip_prob`` per image of a (B, H, W, C) batch, drawn from
    ``generator`` on the batch's device (:func:`augment_with` does the
    gather)."""
    B = images.shape[0]
    u = torch.rand(B, generator=generator, device=images.device)
    theta = (u * 2.0 - 1.0) * (max_rotate_deg * math.pi / 180.0)
    flip = torch.rand(B, generator=generator, device=images.device) < hflip_prob
    return augment_with(images, theta, flip)


def augment_with(images: torch.Tensor, theta: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Rotate image b by ``theta[b]`` radians about its centre, then mirror
    it where ``flip[b]``: one bilinear gather per image with edge clamping,
    the arithmetic of the JAX ``augment_batch``."""
    B, H, W, C = images.shape
    dev = images.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yc, xc = yy - cy, xx - cx
    cos = torch.cos(theta.float())[:, None, None]
    sin = torch.sin(theta.float())[:, None, None]
    src_y = cos * yc - sin * xc + cy
    src_x = sin * yc + cos * xc + cx
    src_x = torch.where(flip.bool()[:, None, None], (W - 1) - src_x, src_x)
    y0 = torch.clamp(torch.floor(src_y), 0, H - 1).long()
    x0 = torch.clamp(torch.floor(src_x), 0, W - 1).long()
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(src_y - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(src_x - x0, 0.0, 1.0)[..., None]
    b = torch.arange(B, device=dev)[:, None, None]
    a, bb = images[b, y0, x0], images[b, y0, x1]
    c, d = images[b, y1, x0], images[b, y1, x1]
    return a * (1 - wy) * (1 - wx) + bb * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
