"""K1: fused Swin window attention — LN + qkv + biased softmax + proj [+ x].

Counterpart of ``mmrp_tpu/ops/fused_window_attention.py``. On a CUDA tensor
:func:`fused_window_attention_windows` launches the hand-written kernel in
``csrc/window_attention.cu``; on a CPU tensor it runs
:func:`window_attention_plain`, the same function in plain PyTorch with the
dtype discipline of the JAX ``xla_equivalent``: LN, softmax and every
accumulation in f32, GEMM operands in the activation dtype.

Weights use the nn.Linear layout: ``w_qkv`` is (3C, C) with rows [q | k | v]
(the transpose of the Flax (C, 3C) kernel), ``w_proj`` is (C, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops.window_attention import build_rel_bias, shift_attn_mask_on


def _ln(xf, scale, bias, eps):
    return F.layer_norm(xf, xf.shape[-1:], scale.float(), bias.float(), eps)


def window_attention_plain(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                           bias_full, num_heads: int, ln_eps: float = 1e-6,
                           include_residual: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference it is held to)."""
    return attention_half_f32(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                              bias_full, num_heads, ln_eps, include_residual).to(xw.dtype)


def attention_half_f32(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias_full,
                       num_heads: int, ln_eps: float = 1e-6,
                       include_residual: bool = True) -> torch.Tensor:
    """[x +] proj(attention(LN(x))) in f32, before the final cast: K1's
    function, and the first half of the whole Swin block, which keeps it in
    f32 (``ops/fused_swin_block.py``)."""
    B, nW, N, C = xw.shape
    h, d = num_heads, C // num_heads
    dt = xw.dtype
    xf = xw.float()
    xn = _ln(xf, ln_scale, ln_bias, ln_eps).to(dt)
    qkv = (xn.float() @ w_qkv.float().t() + b_qkv.float()).to(dt)
    q, k, v = qkv.reshape(B, nW, N, 3, h, d).unbind(3)
    scores = torch.einsum("bwqhd,bwkhd->bwhqk", q.float(), k.float())
    scores = scores * d**-0.5 + bias_full.float()[None]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    attn = torch.einsum("bwhqk,bwkhd->bwqhd", p.float(), v.float()).to(dt)
    proj = attn.reshape(B, nW, N, C).float() @ w_proj.float().t() + b_proj.float()
    return xf + proj if include_residual else proj


def fused_window_attention_windows(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                   b_proj, bias_full, num_heads: int,
                                   ln_eps: float = 1e-6,
                                   include_residual: bool = True) -> torch.Tensor:
    """proj(attention(LN(x))) [+ x] over windows ``xw`` (B, nW, N, C), RAW
    (pre-LN), already rolled and partitioned. ``bias_full`` (nW, h, N, N) f32
    is the relative-position bias plus the shifted-window mask."""
    if xw.device.type == "cpu":
        return window_attention_plain(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                      b_proj, bias_full, num_heads, ln_eps,
                                      include_residual)
    if xw.device.type != "cuda":
        raise ValueError(f"fused_window_attention_windows: no kernel for {xw.device}")
    B, nW, N, C = xw.shape
    if C % num_heads or C // num_heads not in (32, 64, 128) or N > 64:
        raise ValueError(
            "fused_window_attention_windows: the kernel takes head dims 32/64/128 "
            f"and at most 64 tokens per window, got C={C}, heads={num_heads}, N={N}")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_cuda_inputs("fused_window_attention_windows", xw.device, [
        ("xw", xw, bf16, (B, nW, N, C)),
        ("ln_scale", ln_scale, f32, (C,)), ("ln_bias", ln_bias, f32, (C,)),
        ("w_qkv", w_qkv, bf16, (3 * C, C)), ("b_qkv", b_qkv, bf16, (3 * C,)),
        ("w_proj", w_proj, bf16, (C, C)), ("b_proj", b_proj, bf16, (C,)),
        ("bias_full", bias_full, f32, (nW, num_heads, N, N)),
    ])
    ctx = torch.empty((_build.round16(B * nW * N), C), dtype=bf16, device=xw.device)
    out = torch.empty_like(xw)
    _build.launch(
        "mmrp_window_attention", xw.device,
        *map(_build.ptr, (xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                          bias_full, ctx, out)),
        B, nW, N, C, num_heads, int(include_residual), float(ln_eps),
        _build.stream_of(xw))
    fused_window_attention_windows.launches += 1
    return out


fused_window_attention_windows.launches = 0


def build_bias_full(rel_bias_table: torch.Tensor, ws: int, H: int, W: int,
                    shift: int) -> torch.Tensor:
    """(nW, h, N, N) f32: relative position bias + shifted-window mask."""
    rel = build_rel_bias(rel_bias_table.float(), ws)  # (h, N, N)
    nW = (H // ws) * (W // ws)
    if shift > 0:
        smask = shift_attn_mask_on(H, W, ws, shift, rel.device)
        return (smask[:, None] + rel[None]).contiguous()
    return rel[None].expand((nW,) + tuple(rel.shape)).contiguous()
