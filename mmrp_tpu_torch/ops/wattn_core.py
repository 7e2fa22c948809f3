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

:func:`kernel_takes` holds the kernels' limits (head dim 32, windows of at
most 64 tokens, 0 <= shift < ws) and :func:`core_plan` copies the host's
sizing of their grids: the wrapper raises on a CUDA tensor they refuse, and
the Swin training route sends such a stage to the plain version on any
device (``models/swin.py::train_plan``), counted in
``window_attention_core.plain_calls``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops.window_attention import window_partition, window_reverse

# the limits and layout of csrc/wattn_core.cu
HEAD_DIM = 32
MAX_WINDOW_TOKENS = 64
BLOCKS_PER_SM = 4  # blocks of one warpgroup (a head's 64-row tile) an SM
BLOCK_SMEM = 233472 // BLOCKS_PER_SM - 1024  # shared memory a block may take for them to fit
FWD_STAGES, BWD_STAGES = 3, 2  # ring stages: q, k, v (C-F); q, k, v, dO (C-B)
PT_BYTES = 64 * 72 * 2  # C-B's P and dS tiles, 64 x 64 bf16 each, rows padded
ZERO_ROW = 128  # the row that rows past the window read
MAX_N7 = 49  # the largest window (ws^2) on 7 key tiles of 8; C-B stages its bias up to it
MAX_RANKS = 8  # portable cluster size


class CorePlan(NamedTuple):
    """One call's grids and layout (``wattn_core.cu::core_plan``, ``fwd_smem``,
    ``bwd_smem``): C-F walks the B x nW x heads items with ``fwd_blocks``
    persistent blocks; C-B runs a cluster of ``ranks`` blocks (1 to 8) per
    (window, head), rank q on the images [q per_rank, min(B, (q + 1)
    per_rank)); shared memory a block of each."""
    fwd_blocks: int
    ranks: int
    per_rank: int
    fwd_smem: int
    bwd_smem: int


def core_plan(B: int, nW: int, num_heads: int, ws: int, sms: int,
              fit: Optional[Sequence[int]] = None) -> CorePlan:
    """The host's sizing of C-F and C-B for windows of ``ws`` on ``sms`` SMs.
    C-F: BLOCKS_PER_SM persistent blocks an SM (at most one per item). C-B:
    of 1 to 8 ranks (at most B), the fewest waves of clusters times images a
    rank, the fewest ranks among equals, where ``fit[r - 1]`` is the clusters
    of r blocks the card holds at once (the launcher asks the card,
    ``cudaOccupancyMaxActiveClusters``; by default BLOCKS_PER_SM x sms over r).
    Shared memory: a ring of compact head tiles (the window's rows, 64 bytes
    each) and the zero row; C-F the head's bias [n][n] f32, C-B the P and dS
    tiles and, up to MAX_N7 tokens, the bias; at least the dbias
    sums (64 x 64 f32), which reuse it all at the end."""
    pairs = nW * num_heads
    if fit is None:
        fit = [BLOCKS_PER_SM * sms // r for r in range(1, MAX_RANKS + 1)]
    best, ranks = None, 1
    for r in range(1, min(B, MAX_RANKS) + 1):
        if fit[r - 1] < 1:
            continue
        cost = -(-pairs // fit[r - 1]) * -(-B // r)
        if best is None or cost < best:
            best, ranks = cost, r
    n = ws * ws
    row = HEAD_DIM * 2
    bias = n * n * 4
    return CorePlan(
        fwd_blocks=min(B * pairs, BLOCKS_PER_SM * max(sms, 1)), ranks=ranks,
        per_rank=-(-B // ranks), fwd_smem=FWD_STAGES * 3 * n * row + ZERO_ROW + bias,
        bwd_smem=max(BWD_STAGES * 4 * n * row + 2 * PT_BYTES + ZERO_ROW
                     + (bias if n <= MAX_N7 else 0), 64 * 64 * 4))


def kernel_takes(C: int, num_heads: int, ws: int, shift: int) -> bool:
    """Whether C-F and C-B take width C, ``num_heads`` heads, windows of
    ``ws`` and ``shift`` (on a map that ``ws`` tiles): head dim 32 (every
    Swin-B, -T and -S stage), ws^2 <= 64 (whose layouts let BLOCKS_PER_SM
    blocks share an SM) and 0 <= shift < ws."""
    return (num_heads >= 1 and C == HEAD_DIM * num_heads and ws >= 1
            and ws * ws <= MAX_WINDOW_TOKENS and 0 <= shift < ws)


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
    if C3 % 3 or not kernel_takes(C, num_heads, ws, shift) or H % ws or W % ws:
        raise ValueError(f"{op}: the kernel takes head dim 32 (every Swin-B, -T and -S "
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


def core_backward(qkv: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor, *, ws: int,
                  shift: int, num_heads: int, scale: float):
    """C-B on CUDA tensors -> (dqkv (B, H, W, 3C) bf16, dbias (nW, h, N, N) f32)
    in one launch. dbias is the same bit for bit from run to run: each
    cluster rank sums its images' dS in a fixed order, and the ranks add
    their partials in rank order; no float atomics."""
    B, H, W, C, nW = _check("core_backward", qkv, bias, ws, shift, num_heads,
                            [("dout", dout, torch.bfloat16, tuple(qkv.shape[:3]) +
                              (qkv.shape[3] // 3,))])
    N = ws * ws
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nW, num_heads, N, N), dtype=torch.float32, device=qkv.device)
    _build.launch("mmrp_wattn_core_bwd", qkv.device, qkv.data_ptr(), bias.data_ptr(),
                  dout.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), B, H, W, C, num_heads,
                  ws, shift, float(scale), _build.stream_of(qkv))
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
    H % ws == W % ws == 0; the Swin training route calls it where nW > 1 and
    :func:`kernel_takes` the stage, else runs the plain version through
    ``_build.run_plain``."""
    if qkv.device.type == "cpu":
        return window_attention_core_plain(qkv, bias, ws=ws, shift=shift,
                                           num_heads=num_heads, scale=scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_core: no kernel for {qkv.device}")
    return _Core.apply(qkv, bias, ws, shift, num_heads, float(scale))


window_attention_core.plain_calls = 0
