"""Whole Swin block — LN0 + qkv + biased softmax + proj + residual + LN1 + MLP + residual.

Counterpart of ``mmrp_tpu/ops/fused_swin_block.py`` (bf16 form; the W8A8
``quant`` options are not ported yet):

    y   = x + proj(attention(LN0 x))          kept in f32
    out = y + FC2(gelu_tanh(FC1(LN1 y)))      rounded once, at the end

over every ws x ws window. :func:`fused_swin_block_windows` takes the windows
``(B, nW, N, C)``; :func:`fused_swin_block_raw` takes the pre-rolled map
``(B, H, W, C)`` and returns the block on its windows, reversed to the map,
with no roll. On a CUDA tensor both launch the hand-written kernel in
``csrc/swin_block.cu``, which gathers a window's rows from the map and
scatters them back by index arithmetic; on a CPU tensor they run
:func:`swin_block_plain`, the JAX ``xla_equivalent`` in plain PyTorch.
The roll-chain and pair flavors are in :mod:`mmrp_tpu_torch.ops.fused_swin_pair`.

Weights use the nn.Linear layout, in the JAX argument order ("blk"):
``ln0_scale, ln0_bias`` (C,) f32, ``w_qkv`` (3C, C) rows [q | k | v],
``b_qkv`` (3C,), ``w_proj`` (C, C), ``b_proj``, ``ln1_scale, ln1_bias`` f32,
``w1`` (Hd, C), ``b1`` (Hd,), ``w2`` (C, Hd), ``b2`` (C,). ``bias_full``
(nW, h, N, N) f32 is the relative-position bias plus the shifted-window mask
(``fused_window_attention.build_bias_full``, which equals the JAX
``build_bias_padded(...)[:, :, :N, :N]``). The TPU kernel's tiling knobs
(``block_windows``, ``image_block``, ``pad_gemm``) choose VMEM blocks and
have no counterpart here.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops.fused_window_attention import attention_half_f32
from mmrp_tpu_torch.ops.window_attention import window_partition, window_reverse

# number of weight tensors of one block, in the JAX argument order
BLOCK_ARGS = 12


def swin_block_plain(xw, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                     ln1_scale, ln1_bias, w1, b1, w2, b2, bias_full, num_heads: int,
                     ln_eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function on windows (B, nW, N, C) in plain PyTorch, with
    the casts of the JAX ``xla_equivalent``: qkv, p, the attention output,
    LN1(y) and the GELU output rounded to the activation dtype; y in f32."""
    dt = xw.dtype
    y = attention_half_f32(xw, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                           bias_full, num_heads, ln_eps)
    z = F.layer_norm(y, y.shape[-1:], ln1_scale.float(), ln1_bias.float(), ln_eps).to(dt)
    hdn = F.gelu(z.float() @ w1.float().t() + b1.float(), approximate="tanh").to(dt)
    return (y + (hdn.float() @ w2.float().t() + b2.float())).to(dt)


def raw_plain(x, *blk_bias, num_heads: int, ws: int, ln_eps: float = 1e-6) -> torch.Tensor:
    """:func:`swin_block_plain` on the map: partition, block, reverse."""
    _, H, W, _ = x.shape
    out = swin_block_plain(window_partition(x, ws), *blk_bias, num_heads, ln_eps)
    return window_reverse(out, ws, H, W)


def launch_block(op: str, x: torch.Tensor, blk: Sequence[torch.Tensor],
                 bias_full: torch.Tensor, num_heads: int, ln_eps: float,
                 map_ws: int = 0, roll: int = 0) -> torch.Tensor:
    """One launch of the whole-block kernel on CUDA tensors. ``map_ws == 0``:
    x is windows (B, nW, N, C). ``map_ws > 0``: x is the (B, H, W, C) map in
    windows of ``map_ws``, and the output is rolled by (roll, roll)."""
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for {x.device}")
    if len(blk) != BLOCK_ARGS:
        raise ValueError(f"{op}: a block has {BLOCK_ARGS} weight tensors, got {len(blk)}")
    if map_ws:
        B, H, W, C = x.shape
        if H % map_ws or W % map_ws:
            raise ValueError(f"{op}: map {H}x{W} is not tiled by {map_ws}x{map_ws} windows")
        nW, N = (H // map_ws) * (W // map_ws), map_ws * map_ws
    else:
        B, nW, N, C = x.shape
        H = W = 0
    Hd = blk[8].shape[0]
    if C % num_heads or C // num_heads not in (32, 64, 128) or N > 64 or Hd % 128:
        raise ValueError(
            f"{op}: the kernel takes head dims 32/64/128, at most 64 tokens per window "
            f"and a hidden width % 128 == 0, got C={C}, heads={num_heads}, N={N}, Hd={Hd}")
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("ln0_scale", "ln0_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
             "ln1_scale", "ln1_bias", "w1", "b1", "w2", "b2")
    specs = ((f32, (C,)), (f32, (C,)), (bf16, (3 * C, C)), (bf16, (3 * C,)),
             (bf16, (C, C)), (bf16, (C,)), (f32, (C,)), (f32, (C,)),
             (bf16, (Hd, C)), (bf16, (Hd,)), (bf16, (C, Hd)), (bf16, (C,)))
    _build.check_cuda_inputs(op, x.device, [
        ("x", x, bf16, tuple(x.shape)),
        *((n, t, dt, shape) for n, t, (dt, shape) in zip(names, blk, specs)),
        ("bias_full", bias_full, f32, (nW, num_heads, N, N)),
    ])
    ctx = torch.empty((_build.round16(B * nW * N), C), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    _build.launch(
        "mmrp_swin_block", x.device,
        *map(_build.ptr, (x, *blk, bias_full, ctx, out)),
        B, nW, N, C, num_heads, Hd, H, W, map_ws, int(roll), float(ln_eps),
        _build.stream_of(x))
    return out


def fused_swin_block_windows(xw, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                             ln1_scale, ln1_bias, w1, b1, w2, b2, bias_full,
                             num_heads: int, ln_eps: float = 1e-6) -> torch.Tensor:
    """One whole Swin block on windows ``xw`` (B, nW, N, C), raw (pre-LN),
    already rolled and partitioned."""
    blk = (ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj, ln1_scale, ln1_bias,
           w1, b1, w2, b2)
    if xw.device.type == "cpu":
        return swin_block_plain(xw, *blk, bias_full, num_heads, ln_eps)
    out = launch_block("fused_swin_block_windows", xw, blk, bias_full, num_heads, ln_eps)
    fused_swin_block_windows.launches += 1
    return out


fused_swin_block_windows.launches = 0


def fused_swin_block_raw(x, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                         ln1_scale, ln1_bias, w1, b1, w2, b2, bias_full, num_heads: int,
                         ws: int, ln_eps: float = 1e-6) -> torch.Tensor:
    """One whole Swin block on the un-partitioned map ``x`` (B, H, W, C),
    pre-rolled for shifted blocks; returns the map, not rolled back."""
    blk = (ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj, ln1_scale, ln1_bias,
           w1, b1, w2, b2)
    if x.device.type == "cpu":
        return raw_plain(x, *blk, bias_full, num_heads=num_heads, ws=ws, ln_eps=ln_eps)
    out = launch_block("fused_swin_block_raw", x, blk, bias_full, num_heads, ln_eps,
                       map_ws=ws)
    fused_swin_block_raw.launches += 1
    return out


fused_swin_block_raw.launches = 0
