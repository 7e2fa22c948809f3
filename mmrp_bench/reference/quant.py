"""The control's lower precision: int8, the step below bfloat16.

``int8`` rounds a tensor to symmetric int8 with one scale per row of its
last dimension (an activation row, or a weight's output channel, since
weights are (out, in)) and returns the dequantized f32 values; the gradient
passes straight through.
"""

from __future__ import annotations

import torch


def int8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.detach().abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.detach() / scale), -127, 127) * scale
    return x + (q - x).detach()
