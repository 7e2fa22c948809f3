"""Swin window layout, static biases and the unfused window attentions.

Counterpart of ``mmrp_tpu/ops/window_attention.py``: window partition and
reverse, relative-position index, shifted-window mask, relative bias, the
combined head-major bias (:func:`build_combined_bias`), the attention on the
natural window layout (:func:`window_attention_xla_direct`, Swin's training
route where a stage has one window), and the head-major attention
(:func:`window_attention_xla`) with its kernel W (:func:`window_attention_heads`,
``csrc/wattn_core.cu``), the counterpart of ``window_attention_pallas``. No
route of the model calls W; the serving route's attention is the fused kernel
in :mod:`mmrp_tpu_torch.ops.fused_window_attention`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from mmrp_tpu_torch.ops import _build


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, ws*ws, C) with row-major window order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // ws) * (W // ws), ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B, nW, ws*ws, C) -> (B, H, W, C)."""
    B, nW, N, C = x.shape
    x = x.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(N, N) indices into the (2*ws-1)^2 relative-position bias table.
    Cached and shared, so returned read-only."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    out = (rel[:, :, 0] + rel[:, :, 1]).astype(np.int32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (0 / -1e9) for shifted-window attention.
    Cached and shared, so returned read-only."""
    img = np.zeros((H, W), dtype=np.int32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    img = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = img.reshape(-1, ws * ws)
    out = np.where(win[:, :, None] != win[:, None, :], -1e9, 0.0).astype(np.float32)
    out.setflags(write=False)
    return out


# The two tables above on a device, made once per (shape, device): a copy
# from host memory waits for the card to finish its queue, and the training
# route builds its biases at every call.
@functools.lru_cache(maxsize=None)
def relative_position_index_on(ws: int, device: torch.device) -> torch.Tensor:
    """:func:`relative_position_index` flattened, int64, on ``device``."""
    with torch.inference_mode(False):  # usable by autograd whoever asks first
        idx = relative_position_index(ws).astype(np.int64).reshape(-1)
        return torch.from_numpy(idx).to(device)


@functools.lru_cache(maxsize=None)
def shift_attn_mask_on(H: int, W: int, ws: int, shift: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`shift_attn_mask` on ``device``; callers must not write to it."""
    with torch.inference_mode(False):
        return torch.from_numpy(shift_attn_mask(H, W, ws, shift).copy()).to(device)


def build_rel_bias(rel_bias_table: torch.Tensor, ws: int) -> torch.Tensor:
    """((2ws-1)^2, h) learned table -> (h, N, N) additive bias."""
    N = ws * ws
    idx = relative_position_index_on(ws, rel_bias_table.device)
    return rel_bias_table[idx].reshape(N, N, -1).permute(2, 0, 1)


def build_combined_bias(rel_bias_table: torch.Tensor, ws: int, H: int, W: int, shift: int,
                        n_pad: int) -> torch.Tensor:
    """Relative bias + shift mask + padding as one (G, n_pad, n_pad) f32
    tensor, G = heads * nW ordered head-major; pad key columns get -1e9."""
    N = ws * ws
    nW = (H // ws) * (W // ws)
    rel = build_rel_bias(rel_bias_table.float(), ws)  # (h, N, N)
    h = rel.shape[0]
    if shift > 0:
        smask = shift_attn_mask_on(H, W, ws, shift, rel.device)
    else:
        smask = torch.zeros((nW, N, N), dtype=torch.float32, device=rel.device)
    bias = (rel[:, None] + smask[None]).reshape(h * nW, N, N)
    if n_pad > N:
        pad = n_pad - N
        bias = torch.nn.functional.pad(bias, (0, pad, 0, pad))
        col_mask = torch.cat([torch.zeros(N), torch.full((pad,), -1e9)]).to(bias.device)
        bias = bias + col_mask[None, None, :]
    return bias


def window_attention_xla_direct(qkv_win: torch.Tensor, rel_bias: torch.Tensor,
                                smask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Attention on the natural window layout: ``qkv_win`` (B, nW, N, 3, h, d),
    ``rel_bias`` (h, N, N), ``smask`` (nW, N, N) or None -> (B, nW, N, h*d).
    Scores are in the input dtype; the softmax's exponentials and sums are f32."""
    q, k, v = qkv_win.unbind(3)  # (B, nW, N, h, d) each
    sdt = q.dtype
    scores = torch.einsum("bwqhd,bwkhd->bwhqk", q, k)
    scores = scores * torch.tensor(scale, dtype=sdt) + rel_bias[None, None].to(sdt)
    if smask is not None:
        scores = scores + smask[None, :, None].to(sdt)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp((scores - m).float())
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bwhqk,bwkhd->bwqhd", p, v)
    B, nW, N, h, d = out.shape
    return out.reshape(B, nW, N, h * d)


def window_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias2: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + bias2) v over head-major (B, G, N, d) q/k/v:
    scores and softmax in f32, probabilities rounded to v's dtype, the
    product summed in f32 and rounded to q's dtype. Kernel W's plain version."""
    scores = torch.einsum("bgnd,bgmd->bgnm", q.float(), k.float())
    scores = scores * scale + bias2[None].float()
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bgnm,bgmd->bgnd", p.float(), v.float()).to(q.dtype)


def window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias2: torch.Tensor, scale: float) -> torch.Tensor:
    """Head-major window attention, ``window_attention_pallas``'s function:
    q, k, v (B, G, N, d), bias2 (G, N, N) f32 from :func:`build_combined_bias`.
    A CUDA tensor goes to kernel W (bf16, d = 32, N <= 64); a CPU tensor to
    :func:`window_attention_xla`."""
    if q.device.type == "cpu":
        return window_attention_xla(q, k, v, bias2, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_heads: no kernel for {q.device}")
    B, G, N, d = q.shape
    if d != 32 or N > 64:
        raise ValueError("window_attention_heads: the kernel takes head dim 32 (every Swin-B "
                         f"and Swin-T stage) and at most 64 tokens, got d={d}, N={N}")
    bf16 = torch.bfloat16
    _build.check_cuda_inputs("window_attention_heads", q.device, [
        ("q", q, bf16, (B, G, N, d)), ("k", k, bf16, (B, G, N, d)),
        ("v", v, bf16, (B, G, N, d)), ("bias2", bias2, torch.float32, (G, N, N)),
    ])
    out = torch.empty_like(q)
    _build.launch("mmrp_window_attention_heads", q.device,
                  *map(_build.ptr, (q, k, v, bias2, out)), B, G, N, d, float(scale),
                  _build.stream_of(q))
    window_attention_heads.launches += 1
    return out


window_attention_heads.launches = 0
