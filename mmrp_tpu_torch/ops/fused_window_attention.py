"""K1: fused Swin window attention — LN + qkv + biased softmax + proj [+ x].

Counterpart of ``mmrp_tpu/ops/fused_window_attention.py``. On a CUDA tensor
:func:`fused_window_attention_windows` launches the hand-written kernels in
``csrc/window_attention.cu``: the wgmma attention launch of
``csrc/attention.cuh`` (``window_attn_wgmma``, which the whole Swin block
shares) and the wgmma projection (``k1_proj_wgmma``); on a CPU tensor it runs
:func:`window_attention_plain`, the same function in plain PyTorch with the
dtype discipline of the JAX ``xla_equivalent``: LN, softmax and every
accumulation in f32, GEMM operands in the activation dtype.

:func:`kernel_takes` holds the kernel's shape limits (:func:`attention_smem` and
:func:`attn_splits` copy the header's layout and the host's split of a
window's head groups): the wrapper raises on a CUDA tensor it refuses, and
the Swin encoder's plan routes such stages to the plain version, counted in
``fused_window_attention_windows.plain_calls``.

Weights use the nn.Linear layout: ``w_qkv`` is (3C, C) with rows [q | k | v]
(the transpose of the Flax (C, 3C) kernel), ``w_proj`` is (C, C).

The two launches are the op ``torch.ops.mmrp.window_attention``
(``_build.kernel_op``), which a traced serving program records.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops.window_attention import build_rel_bias, shift_attn_mask_on


HEAD_DIMS = (32, 64, 128)
MAX_WINDOW_TOKENS = 64
# the limits and layout of csrc/attention.cuh (window_attn_wgmma), on the
# constants of csrc/gemm_sm90.cuh
MAX_C = 1024  # a LayerNorm row on one warp: 32 lanes of 4 pieces of 8 (ln_rows)
TILE_M, TILE_N = 64, 128  # rows of a window tile; columns of a head group
CHUNK_A, CHUNK_W = TILE_M * 128, TILE_N * 128  # bytes of a row chunk, a weight chunk
SLOTS = 3  # weight chunks in the ring
MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90 (common.cuh)


def attention_smem(C: int, D: int) -> int:
    """Shared memory of one attention block (``attention.cuh::attn_layout``):
    the staged rows (64 x C bf16 in 8 KB chunks), the ring of :data:`SLOTS`
    weight chunks, the k and v tiles of one 128-column head group (64 x
    (D + 8) bf16 a head), 64 row scales and the base's alignment."""
    rows = (C * 2 + 127) // 128 * CHUNK_A
    kv = 2 * (TILE_N // D) * TILE_M * (D + 8) * 2
    return rows + SLOTS * CHUNK_W + kv + TILE_M * 4 + 1024


def attn_splits(windows: int, C: int, sms: int) -> int:
    """Blocks per window (``attention.cuh::attn_splits``): the fewest splits of
    the C / 128 head groups with windows x splits >= sms, at most one per
    group."""
    groups = -(-C // TILE_N)
    splits = 1
    while splits < groups and windows * splits < sms:
        splits += 1
    return splits


def kernel_takes(C: int, num_heads: int, N: int) -> bool:
    """Whether the CUDA window attention (K1, and the whole Swin block's
    attention launch) takes width C, ``num_heads`` heads and N tokens per
    window: head dims 32, 64 or 128, 1 to 64 tokens, C % 16 == 0 up to
    :data:`MAX_C`, and a shared-memory layout (:func:`attention_smem`) that fits
    one block. The int8 forms also need C % 32 == 0
    (``fused_swin_block.kernel_takes``)."""
    return (num_heads > 0 and C % num_heads == 0 and C // num_heads in HEAD_DIMS
            and 1 <= N <= MAX_WINDOW_TOKENS and C % 16 == 0 and C <= MAX_C
            and attention_smem(C, C // num_heads) <= MAX_SMEM)


def _ln(xf, scale, bias, eps):
    return F.layer_norm(xf, xf.shape[-1:], scale.float(), bias.float(), eps)


def window_attention_plain(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                           bias_full, num_heads: int, ln_eps: float = 1e-6,
                           include_residual: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference it is held to)."""
    return attention_half_f32(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                              bias_full, num_heads, ln_eps, include_residual).to(xw.dtype)


def _gemm(x, w, b):
    return x.float() @ w.float().t() + b.float()


def attention_half_f32(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias_full,
                       num_heads: int, ln_eps: float = 1e-6,
                       include_residual: bool = True, gemms=(_gemm, _gemm)) -> torch.Tensor:
    """[x +] proj(attention(LN(x))) in f32, before the final cast: K1's
    function, and the first half of the whole Swin block, which keeps it in
    f32 (``ops/fused_swin_block.py``, whose int8 forms pass their qkv and
    proj GEMMs as ``gemms``: (x, w, b) -> f32 x w^T + b)."""
    B, nW, N, C = xw.shape
    h, d = num_heads, C // num_heads
    dt = xw.dtype
    xf = xw.float()
    xn = _ln(xf, ln_scale, ln_bias, ln_eps).to(dt)
    qkv = gemms[0](xn, w_qkv, b_qkv).to(dt)
    q, k, v = qkv.reshape(B, nW, N, 3, h, d).unbind(3)
    scores = torch.einsum("bwqhd,bwkhd->bwhqk", q.float(), k.float())
    scores = scores * d**-0.5 + bias_full.float()[None]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    attn = torch.einsum("bwhqk,bwkhd->bwqhd", p.float(), v.float()).to(dt)
    proj = gemms[1](attn.reshape(B, nW, N, C), w_proj, b_proj)
    return xf + proj if include_residual else proj


def fused_window_attention_windows(xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                   b_proj, bias_full, num_heads: int,
                                   ln_eps: float = 1e-6,
                                   include_residual: bool = True) -> torch.Tensor:
    """proj(attention(LN(x))) [+ x] over windows ``xw`` (B, nW, N, C), RAW
    (pre-LN), already rolled and partitioned. ``bias_full`` (nW, h, N, N) f32
    is the relative-position bias plus the shifted-window mask. With a
    gradient route (``_build.grad_route``: the kernel forward, the backward
    through :func:`window_attention_plain`)."""
    tensors = (xw, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, bias_full)
    flags = (num_heads, ln_eps, include_residual)
    if xw.device.type == "cpu":
        return window_attention_plain(*tensors, *flags)
    if xw.device.type != "cuda":
        raise ValueError(f"fused_window_attention_windows: no kernel for {xw.device}")
    return _build.grad_route(lambda *t: (_op if _build.traced() else _launch)(*t, *flags),
                             lambda *t: window_attention_plain(*t, *flags), tensors)


def _launch(xw: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
            w_qkv: torch.Tensor, b_qkv: torch.Tensor, w_proj: torch.Tensor,
            b_proj: torch.Tensor, bias_full: torch.Tensor, num_heads: int,
            ln_eps: float, include_residual: bool) -> torch.Tensor:
    """The kernel's launches on CUDA tensors
    (:func:`fused_window_attention_windows`)."""
    B, nW, N, C = xw.shape
    if not kernel_takes(C, num_heads, N):
        raise ValueError(
            "fused_window_attention_windows: the kernel takes head dims 32/64/128, "
            "at most 64 tokens per window and C % 16 == 0 up to 1024, "
            f"got C={C}, heads={num_heads}, N={N}")
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


def _fake(xw, *args):
    return xw.new_empty(xw.shape)


_op = _build.kernel_op("window_attention", _launch, _fake)
fused_window_attention_windows.launches = 0
fused_window_attention_windows.plain_calls = 0


def build_bias_full(rel_bias_table: torch.Tensor, ws: int, H: int, W: int,
                    shift: int) -> torch.Tensor:
    """(nW, h, N, N) f32: relative position bias + shifted-window mask."""
    rel = build_rel_bias(rel_bias_table.float(), ws)  # (h, N, N)
    nW = (H // ws) * (W // ws)
    if shift > 0:
        smask = shift_attn_mask_on(H, W, ws, shift, rel.device)
        return (smask[:, None] + rel[None]).contiguous()
    return rel[None].expand((nW,) + tuple(rel.shape)).contiguous()
