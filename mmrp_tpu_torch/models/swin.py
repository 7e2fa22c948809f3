"""Swin Transformer vision encoder on the fused-kernel routes of the JAX model.

Counterpart of ``mmrp_tpu/models/swin.py``. Each stage takes the route the
JAX ``SwinEncoder`` takes with its default environment (:func:`swin_plan`,
the conditions of ``swin.py:503-510, 718-765, 791-826``):

- ``k1k2``: every block's attention half is the fused window-attention kernel
  (K1, ``ops/fused_window_attention.py``) between a roll + partition and a
  reverse + roll in PyTorch, its MLP half the fused LN + MLP kernel (K2,
  ``ops/fused_mlp.py``) at C <= 256 and plain GEMMs at wider stages — Swin-B
  stage 1 (C = 128 < ``whole_min_c``), and every stage with
  ``whole_block=False`` (the JAX ``MMRP_SWIN_WHOLE=0``);
- ``pair``: a block and its shifted partner through the whole-block kernel,
  on the raw map (``ops/fused_swin_pair.py``) — Swin-B stage 2;
- ``chain``: one whole block per call on the raw map, each leaving the map
  in the next block's rolled frame — Swin-B stage 3;
- ``windows``: the whole-block kernel on the partitioned windows
  (``ops/fused_swin_block.py``) — Swin-B stage 4, where the chain's VMEM gate
  fails and the partition of a single window is a view.

Each step also says whether the CUDA kernels take its shapes
(``Step.kernel``, from each wrapper's ``kernel_takes``): a step they refuse
(a head dim other than 32 / 64 / 128, a window over 64 tokens, a width or
hidden width the MLP kernels do not take) is a ``plain`` route that runs the
plain version of its JAX route on any device, counted in the wrapper's
``plain_calls``; ``SwinConfig(use_pallas=False)`` makes every step one, on
the K1 + K2 route's plain versions, as JAX's ``use_pallas=False`` runs XLA.

``SwinConfig.quant`` picks the serving precision of the whole-block routes:
``"int8_static"`` runs pair, chain and windows in static W8A8 (int8 weights
kept per block, ``act_amax`` the calibrated per-block activation abs-max of
``models/quant_calib.py``, or None for per-row activation scales), with the
pair and chain gates sized for 1-byte weights; ``"int8"`` turns pair and
chain off and runs every whole-block stage on the windows kernel in dynamic
W8A8. K1 + K2 stages stay bf16 under both, as in JAX.

Training (``forward(x, deterministic=False, generator=...)``) takes the JAX
XLA branch of every block whatever the serving plan says (``swin.py:289-401,
584-646``): LN0, the qkv GEMM, the raw-layout attention core where a stage
has more than one window, else ``window_attention_xla_direct``, the proj GEMM
and DropPath; then LN1, the MLP with dropout, and DropPath. The core is a
call site of its own per stage (:func:`train_plan`): ``kernel`` (C-F / C-B,
``ops/wattn_core.py``) where the kernels take the stage's shapes, else
``plain`` (the plain core with autograd on any device, counted in
``window_attention_core.plain_calls``).

The routes share one parameter tree, so ``utils/convert.py`` loads the same
weights into every route. Layouts are the JAX model's: NHWC input, PatchEmbed
as a space-to-depth GEMM over ``(kh, kw, in)``-flattened patches,
PatchMerging concatenating in ``reshape(B, H/2, 2, W/2, 2, C).transpose(0, 1,
3, 2, 4, 5)`` order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    MlpParams,
    dropout,
    gelu,
    ln_f32,
    remat,
)
from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops import fused_mlp as K2
from mmrp_tpu_torch.ops import fused_swin_block as SB
from mmrp_tpu_torch.ops import fused_window_attention as K1
from mmrp_tpu_torch.ops import wattn_core as WC
from mmrp_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual, ln_mlp_plain
from mmrp_tpu_torch.ops.fused_swin_block import fused_swin_block_windows, swin_block_plain
from mmrp_tpu_torch.ops.fused_swin_pair import (
    chain_plain,
    chain_vmem_ok,
    fused_swin_block_chain,
    fused_swin_block_pair,
    pair_plain,
    pair_vmem_ok,
)
from mmrp_tpu_torch.ops.fused_window_attention import (
    build_bias_full,
    fused_window_attention_windows,
    window_attention_plain,
)
from mmrp_tpu_torch.ops.quant import attach_int8
from mmrp_tpu_torch.ops.wattn_core import window_attention_core, window_attention_core_plain
from mmrp_tpu_torch.ops.window_attention import (
    build_rel_bias,
    shift_attn_mask_on,
    window_attention_xla_direct,
    window_partition,
    window_reverse,
)

# Swin MLPs up to this width take the fused kernel; wider ones plain GEMMs
# (mmrp_tpu/models/swin.py:612-631)
FUSED_MLP_MAX_DIM = 256


@dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    # training only: DropPath rates rise linearly to drop_path_rate over the
    # blocks in order; dropout acts inside the MLPs
    drop_path_rate: float = 0.1
    dropout: float = 0.0
    # the JAX routing switches, at their defaults: MMRP_SWIN_WHOLE,
    # MMRP_SWIN_WHOLE_MINC, MMRP_SWIN_PAIR, MMRP_SWIN_PAIR_MAXC, MMRP_SWIN_CHAIN
    whole_block: bool = True
    whole_min_c: int = 256
    pair: bool = True
    pair_max_c: int = 256
    chain: bool = True
    # serving precision: "none" | "int8" (dynamic W8A8) | "int8_static"; and for
    # "int8_static" the calibrated (qkv_in, proj_in, mlp1_in, mlp2_in) abs-max
    # of every block in global order, or None for per-row activation scales
    quant: str = "none"
    act_amax: Optional[Tuple[Tuple[float, float, float, float], ...]] = None
    # False: every step on the plain versions (JAX's use_pallas=False)
    use_pallas: bool = True

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)

    @property
    def num_patches(self) -> int:
        """Tokens of the final stage (49 at 224 px)."""
        res = self.img_size // self.patch_size
        for _ in self.depths[1:]:
            res = (res + 1) // 2
        return res * res

    @staticmethod
    def tiny(**kw) -> "SwinConfig":
        return SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), **kw)

    @staticmethod
    def small(**kw) -> "SwinConfig":
        return SwinConfig(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24), **kw)

    @staticmethod
    def base(**kw) -> "SwinConfig":
        return SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), **kw)

    @staticmethod
    def micro(**kw) -> "SwinConfig":
        """Smoke-test scale: one 7x7-window stage."""
        kw.setdefault("img_size", 28)
        return SwinConfig(embed_dim=16, depths=(1,), num_heads=(2,), **kw)

    @staticmethod
    def from_name(name: str, **kw) -> "SwinConfig":
        """The preset of a backbone name, as the JAX ``SwinConfig.from_name``."""
        name = name.lower()
        if name in ("swin", "swin_base", "base"):
            return SwinConfig.base(**kw)
        if name in ("swin_small", "small"):
            return SwinConfig.small(**kw)
        if name in ("swin_tiny", "tiny"):
            return SwinConfig.tiny(**kw)
        if name in ("swin_micro", "micro"):
            return SwinConfig.micro(**kw)
        raise ValueError(f"unknown swin preset {name!r}")


class Step(NamedTuple):
    """One call of a stage's route: ``route`` (the JAX model's) on block
    ``block`` (and, for a pair, ``block + 1``); ``roll_after`` is a chain
    step's roll into the next block's frame; ``quant`` the kernel's W8A8 form:
    False, True (dynamic) or "static"; ``kernel`` False when the CUDA kernels
    do not take the step's shapes, which then runs the plain version of
    ``route`` (its name is "plain")."""

    route: str  # "k1k2" | "pair" | "chain" | "windows"
    block: int
    roll_after: int = 0
    quant: object = False
    kernel: bool = True

    @property
    def name(self) -> str:
        return self.route if self.kernel else "plain"


def stage_geometry(cfg: SwinConfig) -> List[Tuple[int, int, int]]:
    """(dim, resolution, window) of each stage; the window is clamped to the
    resolution, as the JAX model does."""
    out, dim, res = [], cfg.embed_dim, cfg.img_size // cfg.patch_size
    for stage in range(len(cfg.depths)):
        ws = min(cfg.window_size, res)
        if res % ws:
            raise ValueError(f"stage {stage}: resolution {res} not divisible by window {ws}")
        out.append((dim, res, ws))
        dim, res = dim * 2, (res + 1) // 2
    return out


def block_shift(blk: int, res: int, ws: int) -> int:
    """Odd blocks shift by ws // 2, unless the window covers the whole map
    (``mmrp_tpu`` swin.py:242, 462)."""
    return ws // 2 if blk % 2 and res > ws else 0


QUANTS = ("none", "int8", "int8_static")


def swin_plan(cfg: SwinConfig) -> List[List[Step]]:
    """The steps of every stage, with the JAX ``SwinEncoder``'s conditions
    (``swin.py:503-510, 718-765, 791-826``; the serving route: deterministic,
    Pallas on unless ``use_pallas`` is False): dynamic int8 turns pair and
    chain off, static int8 sizes their VMEM gates for 1-byte weights. Each
    step's ``kernel`` is whether the CUDA kernels take its shapes."""
    if cfg.quant not in QUANTS:
        raise ValueError(f"SwinConfig.quant must be one of {QUANTS}, got {cfg.quant!r}")
    wbytes = 1 if cfg.quant == "int8_static" else 2
    flavor = {"none": False, "int8": True, "int8_static": "static"}[cfg.quant]
    plan = []
    for stage, (dim, res, ws) in enumerate(stage_geometry(cfg)):
        depth, heads = cfg.depths[stage], cfg.num_heads[stage]
        hidden = int(dim * cfg.mlp_ratio)
        whole = cfg.use_pallas and cfg.whole_block and dim >= cfg.whole_min_c
        fused = whole and cfg.quant != "int8"
        use_pair = (cfg.pair and fused and dim <= cfg.pair_max_c and res > ws
                    and pair_vmem_ok(dim, res, res, heads, ws, cfg.mlp_ratio,
                                     weight_bytes=wbytes))
        use_chain = cfg.chain and fused and chain_vmem_ok(dim, res, res, heads, ws,
                                                          cfg.mlp_ratio, weight_bytes=wbytes)
        k1k2 = cfg.use_pallas and K1.kernel_takes(dim, heads, ws * ws) and (
            dim > FUSED_MLP_MAX_DIM or K2.kernel_takes(dim, hidden))
        block_ok = SB.kernel_takes(dim, heads, ws * ws, hidden, flavor)
        steps, blk = [], 0
        while blk < depth:
            if use_pair and blk % 2 == 0 and blk + 1 < depth:
                steps.append(Step("pair", blk, quant=flavor, kernel=block_ok))
                blk += 2
                continue
            if use_chain:
                nxt = block_shift(blk + 1, res, ws) if blk + 1 < depth else 0
                steps.append(Step("chain", blk, block_shift(blk, res, ws) - nxt, flavor,
                                  block_ok))
            elif whole:
                steps.append(Step("windows", blk, quant=flavor, kernel=block_ok))
            else:
                steps.append(Step("k1k2", blk, kernel=k1k2))
            blk += 1
        plan.append(steps)
    return plan


def stage_routes(cfg: SwinConfig) -> List[str]:
    """The JAX route of each stage's first step (a pair stage of odd depth
    ends with one chain or windows step)."""
    return [steps[0].route for steps in swin_plan(cfg)]


def plan_names(cfg: SwinConfig) -> List[List[str]]:
    """The name of every step of every stage: its route, or "plain"."""
    return [[step.name for step in steps] for steps in swin_plan(cfg)]


def train_plan(cfg: SwinConfig) -> List[Optional[str]]:
    """The training route's attention-core call site of each stage: "kernel"
    where C-F / C-B take its shapes at each of its blocks' shifts
    (``wattn_core.kernel_takes``), "plain" where they do not, None where the
    stage has one window (plain PyTorch attention, no core call site)."""
    plan = []
    for stage, (dim, res, ws) in enumerate(stage_geometry(cfg)):
        if res == ws:
            plan.append(None)
            continue
        heads = cfg.num_heads[stage]
        takes = all(WC.kernel_takes(dim, heads, ws, block_shift(b, res, ws))
                    for b in range(cfg.depths[stage]))
        plan.append("kernel" if takes else "plain")
    return plan


class PatchEmbed(nn.Module):
    """Non-overlapping ps x ps patches as space-to-depth + one GEMM, then LN."""

    def __init__(self, embed_dim: int, patch_size: int, in_chans: int, dtype, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(patch_size * patch_size * in_chans, embed_dim,
                              dtype=dtype, device=device)
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        B, H, W, C = x.shape
        ps = self.patch_size
        x = x.reshape(B, H // ps, ps, W // ps, ps, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // ps, W // ps, ps * ps * C)
        return self.LayerNorm_0(self.proj(x.to(self.proj.weight.dtype)))


class WindowAttention(nn.Module):
    """A block's window-attention parameters (``rel_bias_table``, ``qkv``,
    ``proj``) and the serving routes' cached ``bias_full`` (nW, h, N, N) f32
    — relative bias plus shifted-window mask, built from the table at init,
    after every ``load_state_dict`` and, in training, after every optimizer
    step (``train/joint.py``), never per call. The training route builds the
    bias per call with autograd (:meth:`bias_train`) so that the table gets
    its gradient."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 input_resolution: Tuple[int, int], dtype, device=None):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.input_resolution = input_resolution
        self.rel_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size - 1) ** 2, num_heads, dtype=torch.float32, device=device))
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)
        self.register_buffer("bias_full", torch.empty(0, device=device), persistent=False)
        self.refresh_bias()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.refresh_bias())

    @torch.no_grad()
    def refresh_bias(self) -> None:
        self.bias_full = self.bias_train()

    def bias_train(self) -> torch.Tensor:
        H, W = self.input_resolution
        return build_bias_full(self.rel_bias_table, self.window_size, H, W, self.shift)


def cached(quant) -> bool:
    """Whether a W8A8 step takes the int8 weight caches: always the static
    form; the dynamic one outside grad mode. In grad mode it takes the float
    weights, from which its gradient route recomputes the unquantized block
    (``ops/_build.py::quant_grad_route``), and the kernel quantizes them to
    the numbers its caches hold (``attach_int8(from_master=False)``)."""
    return quant == "static" or (bool(quant) and not torch.is_grad_enabled())


class SwinBlock(nn.Module):
    """A Swin block's parameters and its two single-block routes:
    ``forward`` is x + WindowAttention(LN0 x) (K1), then + MLP(LN1 x) (K2 at
    C <= 256); :meth:`forward_windows` is the whole-block kernel on the
    partitioned windows. The encoder runs the raw-map routes with
    :meth:`kernel_args`, and training with :meth:`forward_train`."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 input_resolution: Tuple[int, int], mlp_ratio: float = 4.0,
                 dtype=torch.float32, device=None, drop_path: float = 0.0,
                 dropout: float = 0.0):
        super().__init__()
        H, W = input_resolution
        # no shift when the window covers the whole map (mmrp_tpu swin.py:242)
        shift = shift if min(H, W) > window_size else 0
        self.dim = dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.drop_path = DropPath(drop_path)
        self.LayerNorm_0 = LayerNorm(dim, dtype, device)
        self.attn = WindowAttention(dim, num_heads, window_size, shift, input_resolution,
                                    dtype, device)
        self.LayerNorm_1 = LayerNorm(dim, dtype, device)
        self.mlp = MlpParams(int(dim * mlp_ratio), dim, dtype, device)
        # static W8A8: f32(sa) per GEMM (qkv, proj, FC1, FC2), None = per-row
        self.act_scales = None

    def gemm_linears(self):
        return (self.attn.qkv, self.attn.proj, self.mlp.Dense_0, self.mlp.Dense_1)

    def attach_int8(self, from_master: bool) -> None:
        """Int8 caches of the four GEMM weights (``ops/quant.py``): the
        counterpart of the JAX ``_static_qweights`` / ``build_quant_cache``
        (``from_master``: quantized from f32 parameters), or of the dynamic
        kernel's quantization of the weights it is given."""
        for lin in self.gemm_linears():
            attach_int8(lin, from_master)

    def forward_train(self, x: torch.Tensor, generator: torch.Generator,
                      core: Optional[str]) -> torch.Tensor:
        """The JAX XLA branch with autograd (``swin.py:289-401, 584-646``);
        ``core`` is the stage's attention-core route (:func:`train_plan`)."""
        B, H, W, C = x.shape
        attn = self.attn
        ws, s, h = attn.window_size, attn.shift, self.num_heads
        nW, N = (H // ws) * (W // ws), ws * ws
        scale = (C // h) ** -0.5
        y = ln_f32(x, self.LayerNorm_0.weight, self.LayerNorm_0.bias, x.dtype)
        if core is not None:
            args = (attn.qkv(y), attn.bias_train())
            kw = dict(ws=ws, shift=s, num_heads=h, scale=scale)
            out = attn.proj(window_attention_core(*args, **kw) if core == "kernel" else
                            _build.run_plain(window_attention_core,
                                             window_attention_core_plain, *args, **kw))
        else:
            if s:
                y = torch.roll(y, (-s, -s), (1, 2))
            smask = shift_attn_mask_on(H, W, ws, s, x.device) if s else None
            win = window_partition(attn.qkv(y), ws).reshape(B, nW, N, 3, h, C // h)
            o = window_attention_xla_direct(win, build_rel_bias(attn.rel_bias_table, ws),
                                            smask, scale)
            out = attn.proj(window_reverse(o, ws, H, W))
            if s:
                out = torch.roll(out, (s, s), (1, 2))
        x = x + self.drop_path(out, generator)
        y = ln_f32(x, self.LayerNorm_1.weight, self.LayerNorm_1.bias, x.dtype)
        y = dropout(gelu(self.mlp.Dense_0(y)), self.dropout, generator)
        y = dropout(self.mlp.Dense_1(y), self.dropout, generator)
        return x + self.drop_path(y, generator)

    def kernel_args(self, quant=False) -> Tuple[torch.Tensor, ...]:
        """The 12 weight tensors of the whole-block kernels, in JAX order;
        with ``quant`` the GEMM weights are the int8 caches (:func:`cached`)."""
        q, p, d0, d1 = self.gemm_linears()
        if cached(quant):
            return (self.LayerNorm_0.weight, self.LayerNorm_0.bias, q.weight_q, q.bias,
                    p.weight_q, p.bias, self.LayerNorm_1.weight, self.LayerNorm_1.bias,
                    d0.weight_q, d0.bias, d1.weight_q, d1.bias)
        return (self.LayerNorm_0.weight, self.LayerNorm_0.bias, q.weight, q.bias,
                p.weight, p.bias, self.LayerNorm_1.weight, self.LayerNorm_1.bias,
                d0.weight, d0.bias, d1.weight, d1.bias)

    def quant_kwargs(self, quant) -> dict:
        """``wscales`` (and for "static" ``act_scales``) of the W8A8 flavor."""
        if not quant:
            return {}
        kw = {"wscales": tuple(lin.weight_scale for lin in self.gemm_linears())
              if cached(quant) else None}
        if quant == "static":
            kw["act_scales"] = self.act_scales
        return kw

    def forward_windows(self, x: torch.Tensor, quant=False,
                        kernel: bool = True) -> torch.Tensor:  # (B, H, W, C)
        """The whole-block kernel on the partitioned windows; with ``kernel``
        False its plain version (a plain route of the plan)."""
        _, H, W, _ = x.shape
        ws, s = self.attn.window_size, self.attn.shift
        xs = torch.roll(x, shifts=(-s, -s), dims=(1, 2)) if s else x
        args = (window_partition(xs, ws).contiguous(), *self.kernel_args(quant),
                self.attn.bias_full, self.num_heads)
        kw = dict(quant=quant, **self.quant_kwargs(quant))
        ow = fused_swin_block_windows(*args, **kw) if kernel else \
            _build.run_plain(fused_swin_block_windows, swin_block_plain, *args, **kw)
        out = window_reverse(ow, ws, H, W)
        return torch.roll(out, shifts=(s, s), dims=(1, 2)) if s else out

    def forward(self, x: torch.Tensor, kernel: bool = True) -> torch.Tensor:  # (B, H, W, C)
        """K1, then K2 (C <= 256) or plain GEMMs; with ``kernel`` False the
        plain versions of K1 and K2 (a plain route of the plan)."""
        B, H, W, C = x.shape
        ws, s = self.attn.window_size, self.attn.shift
        xs = torch.roll(x, shifts=(-s, -s), dims=(1, 2)) if s else x
        args = (window_partition(xs, ws).contiguous(),
                self.LayerNorm_0.weight, self.LayerNorm_0.bias,
                self.attn.qkv.weight, self.attn.qkv.bias,
                self.attn.proj.weight, self.attn.proj.bias,
                self.attn.bias_full, self.num_heads)
        ow = fused_window_attention_windows(*args) if kernel else \
            _build.run_plain(fused_window_attention_windows, window_attention_plain, *args)
        x = window_reverse(ow, ws, H, W)
        if s:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        if self.dim <= FUSED_MLP_MAX_DIM:
            args = (x.reshape(B * H * W, C).contiguous(), self.LayerNorm_1.weight,
                    self.LayerNorm_1.bias, *self.mlp.weights())
            out = fused_ln_mlp_residual(*args) if kernel else \
                _build.run_plain(fused_ln_mlp_residual, ln_mlp_plain, *args)
            return out.reshape(B, H, W, C)
        y = ln_f32(x, self.LayerNorm_1.weight, self.LayerNorm_1.bias, x.dtype)
        return x + self.mlp.Dense_1(gelu(self.mlp.Dense_0(y)))


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C); odd sizes are padded."""

    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * dim, dtype, device)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return self.Dense_0(self.LayerNorm_0(x))


class SwinEncoder(nn.Module):
    """NHWC image -> dict(patches (B, Np, F), global (B, F)), the mean over
    patches as the global vector. Built on the card unless ``device`` names
    another; each stage runs the steps of :func:`swin_plan`."""

    def __init__(self, config: SwinConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "SwinEncoder")
        cfg = config
        total = sum(cfg.depths)
        if cfg.act_amax is not None and len(cfg.act_amax) != total:
            raise ValueError(
                f"act_amax has {len(cfg.act_amax)} entries, model has {total} blocks — "
                "recalibrate (models/quant_calib.py) for this architecture")
        self.config = cfg
        # training: each block under activation checkpointing (set by
        # MultiModalRetrievalModel from remat_backbone)
        self.remat = False
        self.plan = swin_plan(cfg)
        self.train_plan = train_plan(cfg)
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size, cfg.in_chans, dtype,
                                      device)
        geometry = stage_geometry(cfg)
        # DropPath rates in global block order (mmrp_tpu swin.py:686, 834)
        dpr = iter(np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths)))
        for stage, (dim, res, ws) in enumerate(geometry):
            for blk in range(cfg.depths[stage]):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, cfg.num_heads[stage], ws, 0 if blk % 2 == 0 else ws // 2,
                    (res, res), cfg.mlp_ratio, dtype, device, float(next(dpr)),
                    cfg.dropout))
            if stage < len(geometry) - 1:
                self.add_module(f"merge{stage}", PatchMerging(dim, dtype, device))
        self.norm = LayerNorm(cfg.num_features, dtype, device)
        # the int8 weights of the blocks a W8A8 step runs (static: quantized
        # from the f32 parameters, as the JAX cache is), and the calibrated
        # activation scales sa = amax / 127 in global block order
        blocks = [self._modules[f"stage{s}_block{b}"]
                  for s, depth in enumerate(cfg.depths) for b in range(depth)]
        for i, blk in enumerate(blocks):
            if cfg.act_amax is not None:
                blk.act_scales = tuple(float(a) / 127.0 for a in cfg.act_amax[i])
        for stage, steps in enumerate(self.plan):
            for step in (st for st in steps if st.quant):
                for b in range(step.block, step.block + (2 if step.route == "pair" else 1)):
                    self._modules[f"stage{stage}_block{b}"].attach_int8(step.quant == "static")

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """``deterministic=False`` takes the training route of every block,
        with dropout and DropPath drawn from ``generator``."""
        x = self.patch_embed(x)
        if not deterministic:
            if generator is None:
                raise ValueError("SwinEncoder: the training route needs a torch.Generator")
            for stage, depth in enumerate(self.config.depths):
                core = self.train_plan[stage]
                for blk in range(depth):
                    block = self._modules[f"stage{stage}_block{blk}"]
                    if self.remat:
                        x = remat(lambda x, g, b=block, c=core: b.forward_train(x, g, c),
                                  generator, x)
                    else:
                        x = block.forward_train(x, generator, core)
                if f"merge{stage}" in self._modules:
                    x = self._modules[f"merge{stage}"](x)
            return self._pool(x)
        for stage, steps in enumerate(self.plan):
            for step in steps:
                blk = self._modules[f"stage{stage}_block{step.block}"]
                ws = blk.attn.window_size
                q, kernel = step.quant, step.kernel
                if step.route == "k1k2":
                    x = blk(x, kernel)
                elif step.route == "windows":
                    x = blk.forward_windows(x, q, kernel)
                elif step.route == "chain":
                    args = (x, blk.kernel_args(q), blk.attn.bias_full, blk.num_heads, ws,
                            step.roll_after)
                    kw = dict(quant=q, **blk.quant_kwargs(q))
                    x = fused_swin_block_chain(*args, **kw) if kernel else \
                        _build.run_plain(fused_swin_block_chain, chain_plain, *args, **kw)
                else:
                    nxt = self._modules[f"stage{stage}_block{step.block + 1}"]
                    kw0, kw1 = blk.quant_kwargs(q), nxt.quant_kwargs(q)
                    args = (x, blk.kernel_args(q), blk.attn.bias_full, nxt.kernel_args(q),
                            nxt.attn.bias_full, blk.num_heads, ws, nxt.attn.shift)
                    kw = dict(quant=q, wscales0=kw0.get("wscales"),
                              wscales1=kw1.get("wscales"), act_scales0=kw0.get("act_scales"),
                              act_scales1=kw1.get("act_scales"))
                    x = fused_swin_block_pair(*args, **kw) if kernel else \
                        _build.run_plain(fused_swin_block_pair, pair_plain, *args, **kw)
            if f"merge{stage}" in self._modules:
                x = self._modules[f"merge{stage}"](x)
        return self._pool(x)

    def _pool(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.norm(x)
        B, H, W, C = x.shape
        patches = x.reshape(B, H * W, C)
        return {"patches": patches, "global": patches.mean(dim=1)}
