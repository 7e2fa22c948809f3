"""K2: fused transformer MLP — LN + FC1 + GELU + FC2 + residual.

Counterpart of ``mmrp_tpu/ops/fused_mlp.py``:
  pre-LN  (default): out = [x +] FC2(gelu_tanh(FC1(LN x)))
  post-LN:           out = LN(x + FC2(gelu_tanh(FC1 x)))
On a CUDA tensor :func:`fused_ln_mlp_residual` launches the hand-written
kernel in ``csrc/ln_mlp.cu`` (the wgmma MLP of ``csrc/mlp_sm90.cuh``), which
never writes the 4C hidden activation to device memory; on a CPU tensor it
runs :func:`ln_mlp_plain`, the same function in plain PyTorch with the JAX
``xla_equivalent``'s dtype discipline. :func:`kernel_takes` holds the
kernel's shape limits: the wrapper raises on a CUDA tensor it refuses, and
the models route such shapes to :func:`ln_mlp_plain` by their plan, counted
in ``fused_ln_mlp_residual.plain_calls``.

Weights use the nn.Linear layout: ``w1`` (Hd, C), ``w2`` (C, Hd).

The launch is the op ``torch.ops.mmrp.ln_mlp`` (``_build.kernel_op``), which a
traced serving program records.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mmrp_tpu_torch.ops import _build


# the limits of csrc/mlp_sm90.cuh, whose host code picks the cluster size
# (mlp_cluster_size) that this module's copy mirrors
SPAN_MAX = 512  # hidden columns one cluster rank keeps on chip
MAX_CLUSTER = 8
MAX_C = 1024  # the callers' row loops hold at most 1024 values a row
MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90 (common.cuh)
TILE_M, TILE_N = 64, 128  # rows of a tile; weight rows of a ring chunk
RING_BYTES = 4 * (TILE_M + TILE_N) * 128  # 4 slots of an A chunk and a weight chunk
RED_BYTES = TILE_M * (TILE_N + 4) * 4  # the partial-sum tile


def mlp_smem(span: int, staged_bytes: int) -> int:
    """Shared memory of one MLP block (``mlp_sm90.cuh::mlp_layout``): the
    hidden slice (64 x span bf16), the ring, the partial-sum tile, the
    caller's staged rows (``staged_bytes``) and the base's alignment."""
    return span * 2 * TILE_M + RING_BYTES + RED_BYTES + staged_bytes + 1024


def mlp_cluster_size(row_tiles: int, Hd: int, row_bytes: int, sms: int = 0) -> int:
    """The cluster size ``mlp_sm90.cuh::mlp_cluster_size`` picks for
    ``row_tiles`` tiles of 64 rows, hidden width Hd and ``row_bytes`` staged
    per row (K2: 2 C; the Swin block's epilogue: 4 C) on ``sms`` SMs: the
    fewest ranks whose hidden slice (a multiple of 128, at most
    ``SPAN_MAX``) and layout fit one block, then twice as many while the
    grid stays within one block per SM (``sms`` 0: the fewest). 0: no fit."""
    def fits(S):
        return (Hd % (S * TILE_N) == 0 and Hd // S <= SPAN_MAX
                and mlp_smem(Hd // S, TILE_M // S * row_bytes) <= MAX_SMEM)
    S = 1
    while S <= MAX_CLUSTER and not fits(S):
        S *= 2
    if S > MAX_CLUSTER:
        return 0
    while S < MAX_CLUSTER and fits(2 * S) and row_tiles * 2 * S <= sms:
        S *= 2
    return S


@functools.lru_cache(maxsize=None)
def kernel_takes(C: int, Hd: int, staged: int = 2) -> bool:
    """Whether the CUDA MLP takes width C and hidden width Hd, each rank
    staging ``staged`` bytes per element of its rows (K2: 2, bf16 x; the
    whole Swin block's epilogue: 4, f32 y): C % 16 == 0 up to 1024 and a
    cluster that splits Hd as :func:`mlp_cluster_size` says."""
    return (C % 16 == 0 and 0 < C <= MAX_C and Hd > 0
            and mlp_cluster_size(1, Hd, staged * C) > 0)


def _ln(xf, scale, bias, eps):
    return F.layer_norm(xf, xf.shape[-1:], scale.float(), bias.float(), eps)


def ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6,
                 post_ln: bool = False, include_residual: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference it is held to)."""
    dt = x.dtype
    xf = x.float()
    gin = x if post_ln else _ln(xf, ln_scale, ln_bias, eps).to(dt)
    h = F.gelu(gin.float() @ w1.float().t() + b1.float(), approximate="tanh")
    out = h.to(dt).float() @ w2.float().t()
    if post_ln:
        return _ln(xf + out + b2.float(), ln_scale, ln_bias, eps).to(dt)
    out = out + b2.float()
    if include_residual:
        out = xf + out
    return out.to(dt)


def fused_ln_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-6,
                          post_ln: bool = False,
                          include_residual: bool = True) -> torch.Tensor:
    """Fused LN + MLP [+ residual] over row-flattened activations x (M, C);
    with a gradient route (``_build.grad_route``: the kernel forward, the
    backward through :func:`ln_mlp_plain`)."""
    tensors = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    flags = (eps, post_ln, include_residual)
    if x.device.type == "cpu":
        return ln_mlp_plain(*tensors, *flags)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp_residual: no kernel for {x.device}")
    return _build.grad_route(lambda *t: (_op if _build.traced() else _launch)(*t, *flags),
                             lambda *t: ln_mlp_plain(*t, *flags), tensors)


def _launch(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
            w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            eps: float, post_ln: bool, include_residual: bool) -> torch.Tensor:
    """The kernel's launch on CUDA tensors (:func:`fused_ln_mlp_residual`)."""
    M, C = x.shape
    Hd = w1.shape[0]
    if not kernel_takes(C, Hd):
        raise ValueError("fused_ln_mlp_residual: the kernel takes C % 16 == 0 up to 1024 "
                         "and a hidden width that a cluster of up to 8 splits into "
                         f"multiples of 128 of at most 512, got C={C}, Hd={Hd}")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_cuda_inputs("fused_ln_mlp_residual", x.device, [
        ("x", x, bf16, (M, C)),
        ("ln_scale", ln_scale, f32, (C,)), ("ln_bias", ln_bias, f32, (C,)),
        ("w1", w1, bf16, (Hd, C)), ("b1", b1, bf16, (Hd,)),
        ("w2", w2, bf16, (C, Hd)), ("b2", b2, bf16, (C,)),
    ])
    # one allocation: the output, then the kernel's scratch: FC1's input
    # bf16(LN x) (pre-LN), or the post-LN form's x + FC2 + b2 in f32
    n = M * C * 2
    buf = torch.empty(n + M * C * (4 if post_ln else 2), dtype=torch.uint8, device=x.device)
    out = buf[:n].view(bf16).view(M, C)
    z, v = (None, buf[n:]) if post_ln else (buf[n:], None)
    _build.launch(
        "mmrp_ln_mlp", x.device,
        *map(_build.ptr, (x, ln_scale, ln_bias, w1, b1, w2, b2, z, v, out)),
        M, C, Hd, int(post_ln), int(include_residual), float(eps),
        _build.stream_of(x))
    fused_ln_mlp_residual.launches += 1
    return out


def _fake(x, *args):
    return x.new_empty(x.shape)


_op = _build.kernel_op("ln_mlp", _launch, _fake)
fused_ln_mlp_residual.launches = 0
fused_ln_mlp_residual.plain_calls = 0
