"""Calibration and weight caches for static W8A8 Swin serving.

Counterpart of ``mmrp_tpu/models/quant_calib.py``:

- :func:`calibrate_swin_act_amax` runs the Swin encoder's plain f32 forward
  (the JAX XLA formulation, no kernel, as the JAX calibration's
  ``force_core(False)`` forces) over a calibration set and returns each
  block's (qkv_in, proj_in, mlp1_in, mlp2_in) activation abs-max: the four
  GEMM inputs the JAX model sows (``swin.py:291, 394, 634-642``);
- :func:`save_act_amax` / :func:`load_act_amax` read and write the same
  ``swin_act_amax_v1`` JSON, so a file written by either package loads in
  the other;
- :func:`build_quant_cache` quantizes the int8 weight caches of a model
  (``ops/quant.py``); the caches marked ``from_master`` take the f32 arrays
  of ``master`` where given (a JAX tree's, ``utils/convert.py``), as the JAX
  ``build_quant_cache`` quantizes the f32 parameters.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmrp_tpu_torch.models.layers import gelu, ln_f32
from mmrp_tpu_torch.ops.quant import int8_linears, int8_stale, refresh_int8
from mmrp_tpu_torch.ops.window_attention import (
    build_rel_bias,
    shift_attn_mask_on,
    window_attention_xla_direct,
    window_partition,
    window_reverse,
)

AmaxTree = Tuple[Tuple[float, float, float, float], ...]
FORMAT = "swin_act_amax_v1"


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.float(), None if lin.bias is None else lin.bias.float())


def _block_f32(blk, x: torch.Tensor, stats: np.ndarray) -> torch.Tensor:
    """One Swin block on the JAX XLA branch in f32 (``swin.py:289-401,
    633-646``), folding its four GEMM inputs' abs-max into ``stats``."""
    B, H, W, C = x.shape
    attn = blk.attn
    ws, s, h = attn.window_size, attn.shift, blk.num_heads
    nW, N = (H // ws) * (W // ws), ws * ws
    f32 = torch.float32
    amax = []
    y = ln_f32(x, blk.LayerNorm_0.weight, blk.LayerNorm_0.bias, f32)
    amax.append(y.abs().max())
    if s:
        y = torch.roll(y, (-s, -s), (1, 2))
    win = window_partition(_dense(y, attn.qkv), ws).reshape(B, nW, N, 3, h, C // h)
    smask = shift_attn_mask_on(H, W, ws, s, x.device) if s else None
    o = window_reverse(window_attention_xla_direct(
        win, build_rel_bias(attn.rel_bias_table.float(), ws), smask, (C // h) ** -0.5),
        ws, H, W)
    amax.append(o.abs().max())
    out = _dense(o, attn.proj)
    if s:
        out = torch.roll(out, (s, s), (1, 2))
    x = x + out
    y = ln_f32(x, blk.LayerNorm_1.weight, blk.LayerNorm_1.bias, f32)
    amax.append(y.abs().max())
    y = gelu(_dense(y, blk.mlp.Dense_0))
    amax.append(y.abs().max())
    np.maximum(stats, torch.stack(amax).double().cpu().numpy(), out=stats)
    return x + _dense(y, blk.mlp.Dense_1)


@torch.no_grad()
def _encoder_f32(enc, x: torch.Tensor, stats: np.ndarray) -> None:
    """The encoder's blocks in f32 on ``x`` (B, H, W, 3), ``stats`` (blocks, 4)."""
    pe = enc.patch_embed
    B, H, W, C = x.shape
    ps = pe.patch_size
    x = x.float().reshape(B, H // ps, ps, W // ps, ps, C).permute(0, 1, 3, 2, 4, 5)
    x = _dense(x.reshape(B, H // ps, W // ps, ps * ps * C), pe.proj)
    x = F.layer_norm(x, x.shape[-1:], pe.LayerNorm_0.weight, pe.LayerNorm_0.bias,
                     pe.LayerNorm_0.eps)
    i = 0
    for stage, depth in enumerate(enc.config.depths):
        for b in range(depth):
            x = _block_f32(enc._modules[f"stage{stage}_block{b}"], x, stats[i])
            i += 1
        merge = enc._modules.get(f"merge{stage}")
        if merge is not None:
            _, H, W, C = x.shape
            if H % 2 or W % 2:
                x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
                _, H, W, C = x.shape
            x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(B, H // 2, W // 2, 4 * C)
            ln = merge.LayerNorm_0
            x = _dense(F.layer_norm(x, x.shape[-1:], ln.weight, ln.bias, ln.eps), merge.Dense_0)


def calibrate_swin_act_amax(encoder, images, batch_size: int = 8) -> AmaxTree:
    """Per-block (qkv_in, proj_in, mlp1_in, mlp2_in) activation abs-max of
    ``encoder`` (a ``SwinEncoder``; its weights in f32 whatever its dtype)
    over ``images``: an (N, H, W, 3) array or tensor, or an iterable of
    batches. Runs on the encoder's device with no kernel."""
    device = encoder.norm.weight.device
    if hasattr(images, "shape") and len(images.shape) == 4:
        batches: Iterable = (images[i:i + batch_size]
                             for i in range(0, images.shape[0], batch_size))
    else:
        batches = images
    total = np.zeros((sum(encoder.config.depths), 4), np.float64)
    seen = 0
    for xb in batches:
        xb = xb if torch.is_tensor(xb) else torch.from_numpy(np.asarray(xb, np.float32))
        _encoder_f32(encoder, xb.to(device), total)
        seen += 1
    if seen == 0:
        raise ValueError("calibration set is empty")
    if not np.all(np.isfinite(total)) or np.any(total <= 0):
        raise ValueError(f"degenerate calibration stats: {total}")
    return tuple(tuple(float(v) for v in row) for row in total)


def save_act_amax(path: str, amax: AmaxTree) -> None:
    """Write the calibration artifact (write, then rename over ``path``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"format": FORMAT, "blocks": [list(row) for row in amax]}, fh, indent=1)
    os.replace(tmp, path)


def load_act_amax(path: str) -> AmaxTree:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} artifact")
    return tuple(tuple(float(v) for v in row) for row in doc["blocks"])


def build_quant_cache(model: nn.Module, master: Optional[Mapping[str, torch.Tensor]] = None,
                      stale_only: bool = False) -> None:
    """Quantize the int8 weight caches of ``model``: those marked
    ``from_master`` from ``master[name + ".weight"]`` (f32) where ``master``
    has it, every other one from its module's weight. ``stale_only`` skips
    caches built from the weight as it stands (``ops/quant.int8_stale``)."""
    for name, lin in int8_linears(model):
        key = f"{name}.weight"
        if master is not None and lin.int8_from_master and key in master:
            refresh_int8(lin, master[key].float())
        elif not stale_only or int8_stale(lin):
            refresh_int8(lin)
