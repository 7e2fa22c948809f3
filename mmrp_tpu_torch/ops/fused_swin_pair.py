"""Whole Swin blocks on the raw map: the roll-chain step and the shifted pair.

Counterpart of ``mmrp_tpu/ops/fused_swin_pair.py``, in bf16 and in its static
W8A8 form (``quant="static"``: the blocks' GEMM weights as int8 with
``wscales`` and optional calibrated ``act_scales``, as
:mod:`mmrp_tpu_torch.ops.fused_swin_block` describes):

- :func:`fused_swin_block_chain`: one block on the map ``x`` (B, H, W, C),
  already in this block's (rolled) frame, then the roll by ``roll_after``
  that puts the map in the NEXT block's frame:
  ``roll(reverse(block(partition(x))), roll_after)``;
- :func:`fused_swin_block_pair`: a block and its shifted partner,
  ``roll(block1(roll(block0(x), -s)), +s)``, the map rounded to the
  activation dtype between them as the TPU kernel does.

On CUDA tensors both launch the whole-block kernel of ``csrc/swin_block.cu``
(see :mod:`mmrp_tpu_torch.ops.fused_swin_block`), which folds partition,
reverse and roll into its row indexing; the pair is two launches of it, the
barrier across the map that the shifted block needs. On CPU tensors they run
:func:`chain_plain` / :func:`pair_plain`, the JAX ``_xla_chain`` / ``_xla_pair``
in plain PyTorch.

:func:`kernel_takes` holds the kernel's shape limits on the map
(``fused_swin_block.kernel_takes`` with ws x ws windows); each flavor counts
the calls its plain version serves on a plain route of the Swin encoder's
plan in ``plain_calls``.

``pair_vmem_ok`` and ``chain_vmem_ok`` are copies of the JAX gates. They
size TPU VMEM, not anything on the GPU; the port keeps them so that its
Swin encoder takes the same route as the reference at every geometry
(``models/swin.py::swin_plan``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from mmrp_tpu_torch.ops import fused_swin_block
from mmrp_tpu_torch.ops.fused_swin_block import count_launch, launch_block, raw_plain


def kernel_takes(C: int, num_heads: int, ws: int, Hd: int, quant=False) -> bool:
    """Whether the kernel takes a block on the map in ws x ws windows (the
    pair: each of its two blocks)."""
    return fused_swin_block.kernel_takes(C, num_heads, ws * ws, Hd, quant)


def pair_vmem_ok(C: int, H: int, W: int, num_heads: int, ws: int,
                 mlp_ratio: float = 4.0,
                 budget_bytes: int = 12 * 1024 * 1024,
                 weight_bytes: int = 2) -> bool:
    """The JAX gate of the pair kernel: map + both blocks' weights + both
    bias tables + the largest live intermediates within 12 MB of VMEM."""
    hidden = int(C * mlp_ratio)
    nW = (H // ws) * (W // ws)
    N = ws * ws
    per_block = 3 * C * C + C * C + 2 * C * hidden
    wbytes = 2 * weight_bytes * per_block
    if weight_bytes == 1:
        wbytes += 2 * 4 * (3 * C + C + hidden + C)
    bias = 2 * 4 * nW * num_heads * N * N
    xmap = 2 * H * W * C * 3
    inter = 2 * nW * N * 3 * C + 4 * nW * N * N + 2 * nW * N * hidden
    return wbytes + bias + xmap + inter <= budget_bytes


def chain_vmem_ok(C: int, H: int, W: int, num_heads: int, ws: int,
                  mlp_ratio: float = 4.0,
                  budget_bytes: int = 12 * 1024 * 1024,
                  weight_bytes: int = 2) -> bool:
    """The JAX gate of the chain kernel: :func:`pair_vmem_ok` for one block."""
    hidden = int(C * mlp_ratio)
    nW = (H // ws) * (W // ws)
    N = ws * ws
    wbytes = weight_bytes * (3 * C * C + C * C + 2 * C * hidden)
    if weight_bytes == 1:
        wbytes += 4 * (3 * C + C + hidden + C)
    bias = 4 * nW * num_heads * N * N
    xmap = 2 * H * W * C * 3
    inter = 2 * nW * N * 3 * C + 4 * nW * N * N + 2 * nW * N * hidden
    return wbytes + bias + xmap + inter <= budget_bytes


def _static(quant):
    if quant not in (False, "static"):
        raise ValueError(f"quant must be False or 'static', got {quant!r}")
    return quant


def chain_plain(x, blk: Sequence[torch.Tensor], bias, num_heads: int, ws: int,
                roll_after: int, ln_eps: float = 1e-6, quant=False, wscales=None,
                act_scales=None) -> torch.Tensor:
    """The chain step in plain PyTorch (``_xla_chain``)."""
    y = raw_plain(x, *blk, bias, num_heads=num_heads, ws=ws, ln_eps=ln_eps,
                  quant=_static(quant), wscales=wscales, act_scales=act_scales)
    return torch.roll(y, shifts=(roll_after, roll_after), dims=(1, 2)) if roll_after else y


def pair_plain(x, blk0, bias0, blk1, bias1, num_heads: int, ws: int, shift: int,
               ln_eps: float = 1e-6, quant=False, wscales0=None, wscales1=None,
               act_scales0=None, act_scales1=None) -> torch.Tensor:
    """The pair in plain PyTorch (``_xla_pair``)."""
    y = chain_plain(x, blk0, bias0, num_heads, ws, -shift, ln_eps, quant, wscales0,
                    act_scales0)
    return chain_plain(y, blk1, bias1, num_heads, ws, shift, ln_eps, quant, wscales1,
                       act_scales1)


def fused_swin_block_chain(x, blk: Sequence[torch.Tensor], bias, num_heads: int, ws: int,
                           roll_after: int, ln_eps: float = 1e-6, *, quant=False,
                           wscales=None, act_scales=None) -> torch.Tensor:
    """One whole block on the map ``x`` (B, H, W, C), pre-rolled for this
    block's frame (``bias`` is this block's (nW, h, N, N) bias_full), then
    the roll by ``roll_after = this_shift - next_shift``. Launches are
    counted as ``launches`` (bf16), ``launches_static`` (calibrated
    ``act_scales``) and ``launches_per_row`` (static without them)."""
    if x.device.type == "cpu":
        return chain_plain(x, blk, bias, num_heads, ws, roll_after, ln_eps, quant, wscales,
                           act_scales)
    out = launch_block("fused_swin_block_chain", x, blk, bias, num_heads, ln_eps,
                       map_ws=ws, roll=roll_after, quant=_static(quant), wscales=wscales,
                       act_scales=act_scales)
    count_launch(fused_swin_block_chain, quant, act_scales is None)
    return out


fused_swin_block_chain.launches = 0
fused_swin_block_chain.launches_static = 0
fused_swin_block_chain.launches_per_row = 0
fused_swin_block_chain.plain_calls = 0


def fused_swin_block_pair(x, blk0: Sequence[torch.Tensor], bias0,
                          blk1: Sequence[torch.Tensor], bias1, num_heads: int, ws: int,
                          shift: int, ln_eps: float = 1e-6, *, quant=False, wscales0=None,
                          wscales1=None, act_scales0=None, act_scales1=None) -> torch.Tensor:
    """A block (bias0, no shift) and its shifted partner (bias1, ``shift``)
    on the map ``x`` (B, H, W, C); returns the map in the unshifted frame.
    Launches are counted per pair as ``launches`` (bf16), ``launches_static``
    (both blocks with calibrated ``act_scales``) and ``launches_per_row``
    (static, a block without them)."""
    if x.device.type == "cpu":
        return pair_plain(x, blk0, bias0, blk1, bias1, num_heads, ws, shift, ln_eps, quant,
                          wscales0, wscales1, act_scales0, act_scales1)
    op = "fused_swin_block_pair"
    quant = _static(quant)
    y = launch_block(op, x, blk0, bias0, num_heads, ln_eps, map_ws=ws, roll=-shift,
                     quant=quant, wscales=wscales0, act_scales=act_scales0)
    out = launch_block(op, y, blk1, bias1, num_heads, ln_eps, map_ws=ws, roll=shift,
                       quant=quant, wscales=wscales1, act_scales=act_scales1)
    count_launch(fused_swin_block_pair, quant, act_scales0 is None or act_scales1 is None)
    return out


fused_swin_block_pair.launches = 0
fused_swin_block_pair.launches_static = 0
fused_swin_block_pair.launches_per_row = 0
fused_swin_block_pair.plain_calls = 0
