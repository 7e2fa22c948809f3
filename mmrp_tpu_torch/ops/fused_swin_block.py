"""Whole Swin block — LN0 + qkv + biased softmax + proj + residual + LN1 + MLP + residual.

Counterpart of ``mmrp_tpu/ops/fused_swin_block.py``:

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

W8A8 (``quant``), the int8 forms of ``_block_body``, for all four GEMMs:

- ``quant=True``, dynamic (``_qdot``): int8 weights per output channel, the
  bf16 GEMM inputs (LN0 rows, the attention output, LN1(y), the GELU output)
  quantized per row, dequantized ``acc * sx * sw``. The weights are the float
  ones, quantized here as the TPU kernel does per program, or their int8
  copies with ``wscales``;
- ``quant="static"`` (``_static_gemm``): the weights arrive as int8 with
  ``wscales`` (4 f32 vectors: qkv, proj, FC1, FC2), and ``act_scales`` holds 4
  calibrated per-tensor scales ``sa`` (``clip(rint(x * f32(1 / sa)), ±127)``,
  dequantized ``acc * sw * sa``) or is None for per-row scales (``acc * sw *
  sx``).

Launches are counted per flavor and form: ``launches`` (bf16),
``launches_dynamic`` and, on the windows flavor, ``launches_static``
(calibrated ``act_scales``) and ``launches_per_row`` (static without them).
The MLP half of every form runs on the wgmma epilogue of
``csrc/mlp_sm90.cuh``; the forms with per-row activation scales (static
without ``act_scales``, dynamic) exchange the row scales of the hidden
activation across the cluster. :func:`kernel_takes` holds the shape limits
of both launches, the same for every form: the wrapper raises on CUDA
tensors it refuses, and the Swin encoder's plan routes such steps to their
plain version, counted in each flavor's ``plain_calls``.

Each flavor's launches are an op (``_build.kernel_op``):
``torch.ops.mmrp.swin_block_windows`` and ``swin_block_raw`` here,
``swin_block_chain`` and ``swin_block_pair`` in ``ops/fused_swin_pair.py``;
a traced serving program records them. Gradients, as JAX's VJPs
(:func:`quant_route`): the bf16 and dynamic forms differentiate the unquantized
plain version recomputed on the saved inputs (the dynamic forms need the
float weights for it, ``wscales=None``), the kernel's forward on a CUDA
tensor and the plain version's on a CPU one; the static forms have no VJP
in JAX, and their backward raises.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from mmrp_tpu_torch.ops import _build, fused_mlp, fused_window_attention
from mmrp_tpu_torch.ops.fused_window_attention import _gemm, attention_half_f32
from mmrp_tpu_torch.ops.quant import exact_int_matmul, int8_weights, quant_dot, quantize_acts
from mmrp_tpu_torch.ops.window_attention import window_partition, window_reverse

# number of weight tensors of one block, in the JAX argument order
BLOCK_ARGS = 12
# the weights of the four GEMMs (qkv, proj, FC1, FC2) among them
GEMM_WEIGHTS = (2, 4, 8, 10)
QUANT_MODES = {False: 0, True: 1, "static": 2}
QUANT_FORMS = (False, True, "static")  # the inverse of QUANT_MODES


def kernel_takes(C: int, num_heads: int, N: int, Hd: int, quant=False) -> bool:
    """Whether the whole-block kernel takes a block of width C, ``num_heads``
    heads, N tokens per window and hidden width Hd in the W8A8 form
    ``quant``: the attention phase's limits
    (``fused_window_attention.kernel_takes``), C % 32 == 0 in int8, and the
    wgmma epilogue's (``fused_mlp.kernel_takes``, staging f32 rows)."""
    return _takes(C, num_heads, N, Hd, quant)


@functools.lru_cache(maxsize=None)
def _takes(C: int, num_heads: int, N: int, Hd: int, quant) -> bool:
    if quant not in QUANT_MODES or not fused_window_attention.kernel_takes(C, num_heads, N):
        return False
    return not (quant and C % 32) and fused_mlp.kernel_takes(C, Hd, staged=4)


def static_gemm(x, w8, sw, sa, b) -> torch.Tensor:
    """The JAX ``_static_gemm``: with a static scale ``sa`` (a Python float)
    ``clip(rint(x * f32(1 / sa)), -127, 127)`` and ``acc * sw * f32(sa)``,
    else per-row scales and ``acc * sw * sx``; then the bias in f32."""
    if sa is None:
        xq, sx = quantize_acts(x)
    else:
        f32 = torch.float32
        inv = torch.tensor(1.0 / sa, dtype=f32, device=x.device)
        xq = torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)
        sx = torch.tensor(sa, dtype=f32, device=x.device)
    return exact_int_matmul(xq, w8).float() * sw * sx + b.float()


def block_gemms(blk: Sequence[torch.Tensor], quant=False, wscales=None, act_scales=None):
    """The four GEMMs of ``_block_body`` as functions (x, w, b) -> f32
    x w^T + b, for ``quant`` False, True or "static" (module docstring)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be False, True or 'static', got {quant!r}")
    if not quant:
        return [_gemm] * 4
    w8 = int8_weights([blk[i] for i in GEMM_WEIGHTS], wscales)
    if quant is True:
        return [lambda x, _w, b, q=q, s=s: quant_dot(x, q, out_dtype=torch.float32, wscale=s)
                + b.float() for q, s in w8]
    if wscales is None:
        raise ValueError("static W8A8 takes int8 weights and their wscales")
    acts = (None,) * 4 if act_scales is None else tuple(act_scales)
    return [lambda x, _w, b, q=q, s=s, a=a: static_gemm(x, q, s, a, b)
            for (q, s), a in zip(w8, acts)]


def swin_block_plain(xw, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                     ln1_scale, ln1_bias, w1, b1, w2, b2, bias_full, num_heads: int,
                     ln_eps: float = 1e-6, quant=False, wscales=None,
                     act_scales=None) -> torch.Tensor:
    """The kernel's function on windows (B, nW, N, C) in plain PyTorch, with
    the casts of the JAX ``xla_equivalent``: qkv, p, the attention output,
    LN1(y) and the GELU output rounded to the activation dtype; y in f32.
    ``quant`` takes the GEMMs of :func:`block_gemms`."""
    dt = xw.dtype
    blk = (ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj, ln1_scale, ln1_bias,
           w1, b1, w2, b2)
    g = block_gemms(blk, quant, wscales, act_scales)
    y = attention_half_f32(xw, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                           bias_full, num_heads, ln_eps, gemms=g[:2])
    z = F.layer_norm(y, y.shape[-1:], ln1_scale.float(), ln1_bias.float(), ln_eps).to(dt)
    hdn = F.gelu(g[2](z, w1, b1), approximate="tanh").to(dt)
    return (y + g[3](hdn, w2, b2)).to(dt)


def raw_plain(x, *blk_bias, num_heads: int, ws: int, ln_eps: float = 1e-6,
              **quant) -> torch.Tensor:
    """:func:`swin_block_plain` on the map: partition, block, reverse."""
    _, H, W, _ = x.shape
    out = swin_block_plain(window_partition(x, ws), *blk_bias, num_heads, ln_eps, **quant)
    return window_reverse(out, ws, H, W)


def _quant_args(op, blk, C, Hd, quant, wscales, act_scales):
    """(QuantArgs, tensor specs) of a W8A8 launch, or (None, []) for bf16."""
    if quant not in QUANT_MODES:
        raise ValueError(f"{op}: quant must be False, True or 'static', got {quant!r}")
    if not quant:
        return None, []
    if C % 32:
        raise ValueError(f"{op}: the int8 kernel takes C % 32 == 0, got C={C}")
    if quant == "static" and wscales is None:
        raise ValueError(f"{op}: static W8A8 takes int8 weights and their wscales")
    if quant is True and act_scales is not None:
        raise ValueError(f"{op}: act_scales go with quant='static'")
    w8 = int8_weights([blk[i] for i in GEMM_WEIGHTS], wscales)
    names = ("w_qkv", "w_proj", "w1", "w2")
    shapes = ((3 * C, C), (C, C), (Hd, C), (C, Hd))
    specs = [spec for n, (w, s), shape in zip(names, w8, shapes)
             for spec in ((n, w, torch.int8, shape), (f"{n} scale", s, torch.float32,
                                                      shape[:1]))]
    return _build.quant_args(QUANT_MODES[quant], w8, act_scales), specs


def launch_block(op: str, x: torch.Tensor, blk: Sequence[torch.Tensor],
                 bias_full: torch.Tensor, num_heads: int, ln_eps: float,
                 map_ws: int = 0, roll: int = 0, quant=False, wscales=None,
                 act_scales=None) -> torch.Tensor:
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
    if not _takes(C, num_heads, N, Hd, quant):
        raise ValueError(
            f"{op}: the kernel takes head dims 32/64/128, at most 64 tokens per window, and "
            "C % 16 == 0 (int8: 32) up to 1024 with a hidden width that a cluster of up to 8 "
            f"splits into multiples of 128 of at most 512, got C={C}, heads={num_heads}, "
            f"N={N}, Hd={Hd}, quant={quant!r}")
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("ln0_scale", "ln0_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
             "ln1_scale", "ln1_bias", "w1", "b1", "w2", "b2")
    specs = ((f32, (C,)), (f32, (C,)), (bf16, (3 * C, C)), (bf16, (3 * C,)),
             (bf16, (C, C)), (bf16, (C,)), (f32, (C,)), (f32, (C,)),
             (bf16, (Hd, C)), (bf16, (Hd,)), (bf16, (C, Hd)), (bf16, (C,)))
    qa, qspecs = _quant_args(op, blk, C, Hd, quant, wscales, act_scales)
    if qa is not None:  # the kernel reads the int8 copies of the GEMM weights
        blk = [None if i in GEMM_WEIGHTS else t for i, t in enumerate(blk)]
    _build.check_cuda_inputs(op, x.device, [
        ("x", x, bf16, tuple(x.shape)),
        *((n, t, dt, shape) for n, t, (dt, shape) in zip(names, blk, specs)),
        ("bias_full", bias_full, f32, (nW, num_heads, N, N)), *qspecs,
    ])
    M = B * nW * N
    # one allocation: the attention context (bf16, round16(M) rows), then the
    # MLP launch's y (f32), LN1(y) and int8 context, by rows
    nctx = _build.round16(M) * C * 2
    buf = torch.empty(nctx + M * C * 7, dtype=torch.uint8, device=x.device)
    ctx, scratch = buf[:nctx], buf[nctx:]
    out = torch.empty_like(x)
    _build.launch(
        "mmrp_swin_block", x.device,
        *map(_build.ptr, (x, *blk, bias_full, ctx, scratch, out)),
        B, nW, N, C, num_heads, Hd, H, W, map_ws, int(roll), float(ln_eps),
        _build.addr(qa), _build.stream_of(x))
    return out


def count_launch(fn, quant, per_row: bool = False) -> None:
    """One more launch of ``fn``'s kernel in the flavor ``quant`` (static:
    ``per_row`` without calibrated activation scales)."""
    name = {False: "launches", True: "launches_dynamic",
            "static": "launches_per_row" if per_row else "launches_static"}[quant]
    setattr(fn, name, getattr(fn, name) + 1)


def op_args(quant, wscales, act_scales) -> tuple:
    """(wscales, quant, act_scales) in the ops' argument types."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be False, True or 'static', got {quant!r}")
    return (list(wscales or ()), QUANT_MODES[quant],
            None if act_scales is None else [float(a) for a in act_scales])


def quant_route(op: str, quant, kernel, plain, tensors, wscales):
    """``kernel(*tensors)`` with the gradient route of the form ``quant``
    (module docstring); ``plain`` is the unquantized plain version."""
    if quant == "static":
        return _build.static_route(op, kernel, tensors)
    if quant:
        return _build.quant_grad_route(op, kernel, plain, tensors, wscales is not None)
    return _build.grad_route(kernel, plain, tensors)


def block_fake(x, *args):
    return x.new_empty(x.shape)


def fused_swin_block_windows(xw, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                             ln1_scale, ln1_bias, w1, b1, w2, b2, bias_full,
                             num_heads: int, ln_eps: float = 1e-6, *, quant=False,
                             wscales=None, act_scales=None) -> torch.Tensor:
    """One whole Swin block on windows ``xw`` (B, nW, N, C), raw (pre-LN),
    already rolled and partitioned; ``quant`` and the gradient routes as in
    the module docstring."""
    blk = (ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj, ln1_scale, ln1_bias,
           w1, b1, w2, b2)

    def plain(*t):
        return swin_block_plain(*t, num_heads, ln_eps)

    if xw.device.type == "cpu":
        if not quant:
            return plain(xw, *blk, bias_full)

        def kernel(*t):
            return swin_block_plain(*t, num_heads, ln_eps, quant=quant, wscales=wscales,
                                    act_scales=act_scales)
    else:
        args = op_args(quant, wscales, act_scales)

        def kernel(xw, *t):
            launch = _windows_op if _build.traced() else _windows
            ws, q, acts = args
            return launch(xw, list(t[:-1]), t[-1], ws, num_heads, ln_eps, q, acts)
    return quant_route("fused_swin_block_windows", quant, kernel, plain, (xw, *blk, bias_full),
                 wscales)


def _windows(xw: torch.Tensor, blk: List[torch.Tensor], bias_full: torch.Tensor,
             wscales: List[torch.Tensor], num_heads: int, ln_eps: float, quant: int,
             act_scales: Optional[List[float]]) -> torch.Tensor:
    """The launch of :func:`fused_swin_block_windows` (``quant`` a mode of
    ``QUANT_MODES``, ``wscales`` empty for float weights), counted."""
    q = QUANT_FORMS[quant]
    out = launch_block("fused_swin_block_windows", xw, blk, bias_full, num_heads, ln_eps,
                       quant=q, wscales=wscales or None, act_scales=act_scales)
    count_launch(fused_swin_block_windows, q, act_scales is None)
    return out


_windows_op = _build.kernel_op("swin_block_windows", _windows, block_fake)
fused_swin_block_windows.launches = 0
fused_swin_block_windows.launches_dynamic = 0
fused_swin_block_windows.launches_static = 0
fused_swin_block_windows.launches_per_row = 0
fused_swin_block_windows.plain_calls = 0


def fused_swin_block_raw(x, ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj,
                         ln1_scale, ln1_bias, w1, b1, w2, b2, bias_full, num_heads: int,
                         ws: int, ln_eps: float = 1e-6, *, quant: bool = False,
                         wscales=None) -> torch.Tensor:
    """One whole Swin block on the un-partitioned map ``x`` (B, H, W, C),
    pre-rolled for shifted blocks; returns the map, not rolled back.
    ``quant=True`` is the dynamic W8A8 form, as in JAX the raw flavor's only
    int8 one. Both forms have a gradient route through the unquantized
    :func:`raw_plain`."""
    if quant not in (False, True):
        raise ValueError(f"fused_swin_block_raw: quant must be False or True, got {quant!r}")
    blk = (ln0_scale, ln0_bias, w_qkv, b_qkv, w_proj, b_proj, ln1_scale, ln1_bias,
           w1, b1, w2, b2)

    def plain(*t):
        return raw_plain(*t, num_heads=num_heads, ws=ws, ln_eps=ln_eps)

    if x.device.type == "cpu":
        if not quant:
            return plain(x, *blk, bias_full)

        def kernel(*t):
            return raw_plain(*t, num_heads=num_heads, ws=ws, ln_eps=ln_eps, quant=quant,
                             wscales=wscales)
    else:
        wl, q, _ = op_args(quant, wscales, None)

        def kernel(x, *t):
            launch = _raw_op if _build.traced() else _raw
            return launch(x, list(t[:-1]), t[-1], wl, num_heads, ws, ln_eps, q)
    return quant_route("fused_swin_block_raw", quant, kernel, plain, (x, *blk, bias_full), wscales)


def _raw(x: torch.Tensor, blk: List[torch.Tensor], bias_full: torch.Tensor,
         wscales: List[torch.Tensor], num_heads: int, ws: int, ln_eps: float,
         quant: int) -> torch.Tensor:
    """The launch of :func:`fused_swin_block_raw`, counted."""
    q = QUANT_FORMS[quant]
    out = launch_block("fused_swin_block_raw", x, blk, bias_full, num_heads, ln_eps,
                       map_ws=ws, quant=q, wscales=wscales or None)
    count_launch(fused_swin_block_raw, q)
    return out


_raw_op = _build.kernel_op("swin_block_raw", _raw, block_fake)
fused_swin_block_raw.launches = 0
fused_swin_block_raw.launches_dynamic = 0
fused_swin_block_raw.plain_calls = 0
