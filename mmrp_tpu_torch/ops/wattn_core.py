"""The raw-layout window-attention core, differentiable: kernels C-F and C-B.

Counterpart of ``mmrp_tpu/ops/wattn_core.py``: on the raw qkv map (B, H, W, 3C)
([q | k | v] along the last axis, heads contiguous in each) and the combined
bias (nW, h, N, N) f32 (relative bias + shift mask, ``build_bias_full``),

    roll(-shift) -> window partition -> per head softmax(q k^T * scale + bias) v
    -> window reverse -> roll(+shift)   =>   (B, H, W, C)

with no rolled or partitioned copy of the map in either direction. This is
the Swin training route's attention wherever a stage has more than one window.

:func:`window_attention_core` on a CUDA tensor is a ``torch.autograd.Function``:
its forward launches C-F (:func:`core_forward`) and saves ``qkv`` and ``bias``,
the JAX residuals; its backward launches C-B (:func:`core_backward`), which
recomputes the softmax and returns ``dqkv`` in the raw layout and
``dbias = sum over images of dS``. Both kernels are in ``csrc/wattn_core.cu``.
On a CPU tensor it runs :func:`window_attention_core_plain`, the composition of
the JAX test oracle, and autograd runs through it.
"""

from __future__ import annotations

import torch

from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops.window_attention import window_partition, window_reverse

# C-B gives each block one (window, head) and a chunk of the images; the
# chunk is picked so that the grid holds about this many blocks
_BWD_BLOCKS = 1024


def window_attention_core_plain(qkv: torch.Tensor, bias: torch.Tensor, *, ws: int,
                                shift: int, num_heads: int, scale: float) -> torch.Tensor:
    """The core in plain PyTorch: roll, partition, f32 scores + bias, f32
    softmax, P rounded to v's dtype, P.V summed in f32, reverse, unroll."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    N = ws * ws
    nW = (H // ws) * (W // ws)
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    win = window_partition(x, ws).reshape(B, nW, N, 3, num_heads, d)
    q, k, v = win.unbind(3)
    scores = torch.einsum("bwqhd,bwkhd->bwhqk", q.float(), k.float())
    scores = scores * scale + bias.float()[None]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bwhqk,bwkhd->bwqhd", p.float(), v.float()).to(qkv.dtype)
    out = window_reverse(out.reshape(B, nW, N, C), ws, H, W)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def core_backward_plain(qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor, *,
                        ws: int, shift: int, num_heads: int, scale: float):
    """(dqkv, dbias) by autograd through :func:`window_attention_core_plain`:
    C-B's plain version."""
    with torch.enable_grad():
        q = qkv.detach().requires_grad_(True)
        b = bias.detach().requires_grad_(True)
        out = window_attention_core_plain(q, b, ws=ws, shift=shift, num_heads=num_heads,
                                          scale=scale)
        dqkv, dbias = torch.autograd.grad(out, (q, b), dout)
    return dqkv, dbias


def _check(op: str, qkv, bias, ws: int, shift: int, num_heads: int, extra=()):
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    nW = (H // ws) * (W // ws)
    if C3 % (3 * num_heads) or C // num_heads != 32 or ws * ws > 64 \
            or H % ws or W % ws or not 0 <= shift < ws:
        raise ValueError(f"{op}: the kernel takes head dim 32 (every Swin-B and Swin-T "
                         f"stage), windows of at most 64 "
                         f"tokens that tile the map and 0 <= shift < ws, got qkv "
                         f"{tuple(qkv.shape)}, heads={num_heads}, ws={ws}, shift={shift}")
    _build.check_cuda_inputs(op, qkv.device, [
        ("qkv", qkv, torch.bfloat16, (B, H, W, C3)),
        ("bias", bias, torch.float32, (nW, num_heads, ws * ws, ws * ws)), *extra])
    return B, H, W, C, nW


def core_forward(qkv: torch.Tensor, bias: torch.Tensor, *, ws: int, shift: int,
                 num_heads: int, scale: float) -> torch.Tensor:
    """C-F on CUDA tensors (bf16 qkv, f32 bias) -> out (B, H, W, C) bf16."""
    B, H, W, C, _ = _check("core_forward", qkv, bias, ws, shift, num_heads)
    out = torch.empty((B, H, W, C), dtype=qkv.dtype, device=qkv.device)
    _build.launch("mmrp_wattn_core_fwd", qkv.device, qkv.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), B, H, W, C, num_heads, ws, shift, float(scale),
                  _build.stream_of(qkv))
    core_forward.launches += 1
    return out


core_forward.launches = 0


def _images_per_block(B: int, nW: int, num_heads: int) -> int:
    chunks = min(B, max(1, -(-_BWD_BLOCKS // (nW * num_heads))))
    return -(-B // chunks)


def core_backward(qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor, *, ws: int,
                  shift: int, num_heads: int, scale: float):
    """C-B on CUDA tensors -> (dqkv (B, H, W, 3C) bf16, dbias (nW, h, N, N) f32).
    dbias is the same bit for bit from run to run: per-chunk sums, then a
    second launch that adds the chunks in order; no float atomics."""
    B, H, W, C, nW = _check("core_backward", qkv, bias, ws, shift, num_heads,
                            [("dout", dout, torch.bfloat16, tuple(qkv.shape[:3]) +
                              (qkv.shape[3] // 3,))])
    N = ws * ws
    per_block = _images_per_block(B, nW, num_heads)
    chunks = -(-B // per_block)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nW, num_heads, N, N), dtype=torch.float32, device=qkv.device)
    partial = (torch.empty((chunks, nW, num_heads, N, N), dtype=torch.float32,
                           device=qkv.device) if chunks > 1 else None)
    _build.launch("mmrp_wattn_core_bwd", qkv.device, qkv.data_ptr(), bias.data_ptr(),
                  dout.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), _build.ptr(partial),
                  B, H, W, C, num_heads, ws, shift, per_block, float(scale),
                  _build.stream_of(qkv))
    core_backward.launches += 1
    return dqkv, dbias


core_backward.launches = 0


class _Core(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, ws, shift, num_heads, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.geometry = dict(ws=ws, shift=shift, num_heads=num_heads, scale=scale)
        return core_forward(qkv, bias, **ctx.geometry)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = core_backward(qkv, bias, dout.contiguous(), **ctx.geometry)
        return dqkv, dbias, None, None, None, None


def window_attention_core(qkv: torch.Tensor, bias: torch.Tensor, *, ws: int, shift: int,
                          num_heads: int, scale: float) -> torch.Tensor:
    """Differentiable raw-layout window attention (module docstring). Requires
    H % ws == W % ws == 0; the Swin training route calls it where nW > 1."""
    if qkv.device.type == "cpu":
        return window_attention_core_plain(qkv, bias, ws=ws, shift=shift,
                                           num_heads=num_heads, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_core: no kernel for {qkv.device}")
    return _Core.apply(qkv, bias, ws, shift, num_heads, float(scale))
