#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmrp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which fails the run (nonzero exit, no result line):
1. environment: the card's name and power limit, CUDA and nvcc versions;
2. build: the kernels from mmrp_tpu_torch/csrc with nvcc, timed;
3. kernels: each hand-written kernel against its plain-PyTorch version on
   the same bf16 inputs, at every shape the flagship serving path gives it
   (batch 8) on either Swin route and in the int8 serving mixes (K3 at every
   shape of a predict at text length 64, 128 and 512, with the CUDA launches
   of one call counted by the profiler; K3's W8A8 form at the BERT shape of
   each length; the whole-block kernel's static W8A8 pair, chain
   and windows with calibrated and with per-row activation scales; its
   dynamic windows at stages 2-4 and raw at stage 3),
   then the median CUDA-event time of each and its bound (bytes over 3.35
   TB/s, or bf16 FLOPs over 989 TFLOP/s plus int8 ops over 1,979 TOPS), and
   the device time of one call (the profiler's; the CUDA-event time also holds
   the host's launch time where the card waits), and for K1 and each
   whole-block flavor the device time of each of its launches (the attention
   launch, K1's projection, the MLP launch) beside that launch's own bound. Each
   int8 case also computes planted faults with its plain version (bf16
   activations; the other kind of activation scale), each of which must break
   the case's limits, and the static pair's difference is split by block;
4. slice: the flagship model (Swin-B 224 px, ClinicalBERT dims, 5 fusion
   layers at 1024, 43 labels) in bf16 from a seeded init, ``MMRPredictor
   .predict`` on 8 requests against a 100,000 x 1024 gallery that also holds
   the requests' own embeddings, on the default route (Swin stages 2-4
   through the whole-block kernels: pair, chain, windows) and on the K1 + K2
   route (``whole_block=False``) with the same weights: launch counts per
   predict on each, each request's own id at rank 1, and agreement with the
   plain path (the same weights in f32 on the CPU, where every wrapper runs
   its plain version). Every route's plan must have no plain route (a call
   site no kernel takes), and no predict may count a plain call. Then the
   default route again at text length 128 and
   512 (the JAX serving default): launch counts, rank 1 and the same
   agreement with the plain path.
4b. int8 serving: ``act_amax`` calibrated on 8 seeded images by the plain
   f32 Swin forward on the card (no kernel), then ``MMRPredictor.predict``
   with the same weights at ``serve_quant="int8_static"`` (through
   ``MultiModalConfig.from_config`` and the calibration file) and at
   ``"int8"``: launch counts per predict (int8 and bf16 K3 counted apart),
   each request's own id at rank 1 of a gallery that holds its int8
   embedding, and joint_emb cosine > 0.995 against the f32 unquantized plain
   path, and ``int8_static`` again at text length 512; then the same at
   ``serve_quant="int8_static"`` without a calibration file
   (``int8_static_per_row``: Swin stages 2-4 in static W8A8 with per-row
   activation scales). Then one Swin-B
   forward at ``SwinConfig(quant="int8")``: 22 dynamic whole-block launches,
   and one Swin-T forward (C 96 / 192 / 384 / 768: K1 + K2 at widths that
   are not multiples of 128) with every step on a kernel, its launches
   counted and its pooled features against its plain route (cosine).
   Embed pairs/s of every route at batch 8 and 64 (the default route and
   ``int8_static`` also at text length 128 and 512) and the top-10 latency
   over the gallery, for information.
5. training kernels: the raw-layout window-attention core's forward (C-F) and
   backward (C-B) against the plain composition (autograd through it for the
   backward) at the Swin-B stage 1-3 shapes of a batch-64 train step and the
   Swin-T stage 1-2 shapes (C 96 / 3 heads, C 192 / 6 heads: a partial head
   group) at batch 8, shift 0 and 3, with C-B's dbias and dqkv the same bit
   for bit over two launches, each launch's time beside its bound, and C-B's
   cluster sizing as the card answers it; and the
   head-major window attention (W) at the stage-1 geometry, batch 8, beside
   ``F.scaled_dot_product_attention`` as its library yardstick;
6. train agreement: one step's losses and per-tower gradients of the flagship
   in bf16 on the card (dropout and drop path 0, batch 2) against the same
   weights in f32 on the CPU, where every wrapper runs its plain version;
7. train slice: ``make_train_step`` on the flagship at batch 64 with the default
   dropout and drop path, f32 master weights, bf16 Adam mu and a 300-dim KG
   projection, 3 warm-up and 10 timed steps on one seeded batch: the training
   route's plan with no plain call site (``model_routes(cfg, train=True)``),
   22 C-F and 22 C-B launches, no plain core call and no serving kernel per
   step, finite losses and gradient norms, and a last loss below the first.
   Step time, train pairs/s and peak device memory are printed for
   information.
Each phase prints its seconds. The last two lines are the kernels' JSON record
and the result line {"ok": true, "device": {...}}.
"""

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B = 8
SEED = 0
# kernel vs plain: both round to bf16 at the same places and differ only in
# the order of f32 sums, so each output element agrees to a few bf16 ulps
# (2^-7 relative): |kernel - plain| <= 2^-5 * max(1, |plain|), i.e. 4 ulps
KERNEL_TOL = 2.0 ** -5
# bf16 kernel path vs the f32 plain path on the CPU, same weights (measured
# on an H100: cosine 0.999975, max |dprobs| 3.5e-3)
EMB_COS_MIN = 0.9999
PROBS_MAX_DIFF = 5e-3
# one H100 SXM at its 700 W limit (NVIDIA data sheet): dense bf16 tensor-core
# rate and HBM3 rate, for each kernel's bound
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12  # dense int8 tensor-core rate
# int8 kernel vs plain: the same int8 products (exact int32 sums), but a bf16
# GEMM input one ulp apart (LN, attention, GELU summed in another order) can
# land one int8 step away or move its row's scale: 8 bf16 ulps, twice the
# bf16 kernels' bound
INT8_TOL = 2.0 ** -4
# the static pair is two blocks deep: each of its launches is within 2^-5 of
# its plain block on the same input, but the first block's difference (up to
# 3.0e-2 measured on an H100) reaches the second block's output through its
# residual and moves the second block's int8 inputs across rounding
# boundaries: 8.4e-2 after the second block's plain version alone, the whole
# of the pair's (the kernels phase logs this split): twice INT8_TOL
INT8_PAIR_TOL = 2.0 ** -3
# A wrong int8 form (a GEMM input left in bf16, or the other kind of
# activation scale) moves nearly every output by the quantization noise,
# about as far as one flip of a sound kernel moves a few, so the largest
# difference alone cannot tell them apart. Each int8 kernel is also held to
# the share of its outputs more than a threshold (relative to max(1,
# |plain|)) from plain, and each case computes such faults with its plain
# version: the run fails unless every fault breaks a limit. Measured on an
# H100 (PERF.md): beyond 2^-5 (4 bf16 ulps, the bf16 kernels' limit) the
# one-block flavors showed shares of at most 2.5e-4 and their faults at least
# 1.8e-3; the pair, whose per-row form carries the first block's jitter into
# the second block's row scales, 1.1e-2 against 3.4e-2. K3, whose post-LN
# output dilutes the projections' noise, is held beyond 2^-8, per text length:
# its attention tile rounds P where the plain version does not, so its
# context, quantized per row for the output projection, jitters by an int8
# step more often than the L64-only kernel before it did (2.0e-2): measured
# 6.0e-2 / 4.0e-2 / 2.4e-2 at L64 / L128 / L512 against faults of 0.22 /
# 0.14 / 0.055; each limit sits between the two.
INT8_SHARE = {"fused_attention_int8": (2.0 ** -8, {64: 0.12, 128: 0.08, 512: 0.037}),
              "fused_swin_block_pair_static": (2.0 ** -5, 2e-2),
              "fused_swin_block_pair_per_row": (2.0 ** -5, 2e-2)}
# the two blocks deep pair, held to INT8_PAIR_TOL
PAIRS_INT8 = ("fused_swin_block_pair_static", "fused_swin_block_pair_per_row")
INT8_SHARE_BLOCK = (2.0 ** -5, 7e-4)  # (threshold, largest share) of the others
# int8 serving mixes against the f32 unquantized plain path: the JAX package's
# gate (tests/test_quant_model.py, tests/test_quant_static.py)
INT8_COS_MIN = 0.995
# text lengths of a predict: 64 (the benchmark default), 128, and 512, the
# JAX serving default (mmrp_tpu/serve/runner.py: min(text_dim, 512))
TEXT_LENGTHS = (64, 128, 512)
# launches per run of each serving path, worked out from the Swin routing
# (models/swin.py::swin_plan): on the default route ("whole") stage 1 is
# K1 + K2 (2 blocks), stage 2 one pair, stage 3 18 chain steps, stage 4 2
# windows blocks; K2 also carries the 5 fusion FFNs and K3 the 12 BERT layers
# and 5 x 5 fusion attentions. The K1 + K2 route runs all 24 Swin blocks on K1
# and their MLPs on K2 at C <= 256. The int8 mixes run BERT's attention on
# K3-int8 and the fusion stack without a kernel (W8A8 GEMMs through
# torch._int_mm and plain attention, as JAX's XLA branches); "int8_static"
# runs Swin stages 2-4 in static W8A8 with the calibrated scales,
# "int8_static_per_row" (no calibration file) with per-row scales, "int8" in
# bf16. "swin_int8" is one SwinEncoder forward at quant="int8": dynamic W8A8
# windows at stages 2-4.
SERVING = ("fused_window_attention", "fused_ln_mlp", "fused_attention",
           "fused_attention_int8", "fused_swin_block_windows",
           "fused_swin_block_windows_static", "fused_swin_block_windows_per_row",
           "fused_swin_block_windows_dynamic", "fused_swin_block_raw",
           "fused_swin_block_raw_dynamic", "fused_swin_block_chain",
           "fused_swin_block_chain_static", "fused_swin_block_chain_per_row",
           "fused_swin_block_pair", "fused_swin_block_pair_static",
           "fused_swin_block_pair_per_row")
ZERO = {name: 0 for name in SERVING}
EXPECTED = {
    "whole": {**ZERO, "fused_window_attention": 2, "fused_ln_mlp": 7, "fused_attention": 37,
              "fused_swin_block_windows": 2, "fused_swin_block_chain": 18,
              "fused_swin_block_pair": 1},
    "k1k2": {**ZERO, "fused_window_attention": 24, "fused_ln_mlp": 9, "fused_attention": 37},
    "int8_static": {**ZERO, "fused_window_attention": 2, "fused_ln_mlp": 2,
                    "fused_attention_int8": 12, "fused_swin_block_pair_static": 1,
                    "fused_swin_block_chain_static": 18,
                    "fused_swin_block_windows_static": 2},
    "int8_static_per_row": {**ZERO, "fused_window_attention": 2, "fused_ln_mlp": 2,
                            "fused_attention_int8": 12, "fused_swin_block_pair_per_row": 1,
                            "fused_swin_block_chain_per_row": 18,
                            "fused_swin_block_windows_per_row": 2},
    "int8": {**ZERO, "fused_window_attention": 2, "fused_ln_mlp": 2,
             "fused_attention_int8": 12, "fused_swin_block_pair": 1,
             "fused_swin_block_chain": 18, "fused_swin_block_windows": 2},
    "swin_int8": {**ZERO, "fused_window_attention": 2, "fused_ln_mlp": 2,
                  "fused_swin_block_windows_dynamic": 22},
    # Swin-T: K1 + K2 at stages 1-2 (C 96, 192), 6 chain steps, 2 windows
    "swin_tiny": {"fused_window_attention": 4, "fused_ln_mlp": 4, "fused_swin_block_chain": 6,
                  "fused_swin_block_windows": 2},
}
# the same paths at longer text: every launch count is the text length's own
for _L in TEXT_LENGTHS[1:]:
    EXPECTED[f"whole_L{_L}"] = EXPECTED["whole"]
EXPECTED["int8_static_L512"] = EXPECTED["int8_static"]
# the path whose run counts each kernel's launches (None: no route calls it)
PATH_OF = {name: "whole" for name in SERVING}
PATH_OF.update({name: "int8_static" for name in (
    "fused_attention_int8", "fused_swin_block_windows_static", "fused_swin_block_chain_static",
    "fused_swin_block_pair_static")})
PATH_OF.update({name: "int8_static_per_row" for name in (
    "fused_swin_block_windows_per_row", "fused_swin_block_chain_per_row",
    "fused_swin_block_pair_per_row")})
PATH_OF.update({"fused_swin_block_windows_dynamic": "swin_int8", "fused_swin_block_raw": None,
                "fused_swin_block_raw_dynamic": None, "wattn_core_fwd": "train",
                "wattn_core_bwd": "train", "window_attention_heads": None})
SOURCES = {  # kernel -> (CUDA source, the pallas_call of the TPU kernel it replaces)
    "fused_window_attention": ("mmrp_tpu_torch/csrc/window_attention.cu",
                               "mmrp_tpu/ops/fused_window_attention.py:152"),
    "fused_ln_mlp": ("mmrp_tpu_torch/csrc/ln_mlp.cu", "mmrp_tpu/ops/fused_mlp.py:181"),
    "fused_attention": ("mmrp_tpu_torch/csrc/seq_attention.cu",
                        "mmrp_tpu/ops/fused_attention.py:299"),
    "fused_attention_int8": ("mmrp_tpu_torch/csrc/seq_attention.cu",
                             "mmrp_tpu/ops/fused_attention.py:299"),
    "fused_swin_block_windows": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                 "mmrp_tpu/ops/fused_swin_block.py:435"),
    "fused_swin_block_windows_static": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                        "mmrp_tpu/ops/fused_swin_block.py:435"),
    "fused_swin_block_windows_per_row": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                         "mmrp_tpu/ops/fused_swin_block.py:435"),
    "fused_swin_block_windows_dynamic": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                         "mmrp_tpu/ops/fused_swin_block.py:435"),
    "fused_swin_block_raw": ("mmrp_tpu_torch/csrc/swin_block.cu",
                             "mmrp_tpu/ops/fused_swin_block.py:484"),
    "fused_swin_block_raw_dynamic": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                     "mmrp_tpu/ops/fused_swin_block.py:484"),
    "fused_swin_block_chain": ("mmrp_tpu_torch/csrc/swin_block.cu",
                               "mmrp_tpu/ops/fused_swin_pair.py:384"),
    "fused_swin_block_chain_static": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                      "mmrp_tpu/ops/fused_swin_pair.py:384"),
    "fused_swin_block_chain_per_row": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                       "mmrp_tpu/ops/fused_swin_pair.py:384"),
    "fused_swin_block_pair": ("mmrp_tpu_torch/csrc/swin_block.cu",
                              "mmrp_tpu/ops/fused_swin_pair.py:197"),
    "fused_swin_block_pair_static": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                     "mmrp_tpu/ops/fused_swin_pair.py:197"),
    "fused_swin_block_pair_per_row": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                      "mmrp_tpu/ops/fused_swin_pair.py:197"),
    "wattn_core_fwd": ("mmrp_tpu_torch/csrc/wattn_core.cu", "mmrp_tpu/ops/wattn_core.py:260"),
    "wattn_core_bwd": ("mmrp_tpu_torch/csrc/wattn_core.cu", "mmrp_tpu/ops/wattn_core.py:283"),
    "window_attention_heads": ("mmrp_tpu_torch/csrc/wattn_core.cu",
                               "mmrp_tpu/ops/window_attention.py:307"),
}

# training: batch 64, text length 64. The core runs at Swin-B stages 1-3
# (nW > 1); per train step each stage's blocks alternate shift 0 and 3, so
# stages 1 and 2 make one call of each and stage 3 nine of each, in both
# directions: 22 C-F and 22 C-B launches. Stage 4 (one window) takes plain
# PyTorch attention, and no serving kernel runs. The Swin-T stage 1-2 shapes
# (3 and 6 heads: head groups of 3, and of 4 + 2) at batch 8 are checked
# too; no flagship step makes them (calls 0).
TRAIN_B = 64
CORE_STAGES = ((TRAIN_B, 56, 128, 4, 1), (TRAIN_B, 28, 256, 8, 1), (TRAIN_B, 14, 512, 16, 9),
               (8, 56, 96, 3, 0), (8, 28, 192, 6, 0))  # B, res, C, heads, calls
EXPECTED_TRAIN = {**{name: 0 for name in SERVING}, "wattn_core_fwd": 22,
                  "wattn_core_bwd": 22, "window_attention_heads": 0}
# C-B's dbias sums 64 images' dS. The plain composition's autograd rounds dP
# to bf16 (the cotangent of P's cast) where the kernel keeps it in f32, as the
# TPU kernel does, so each summand differs by up to 2^-8 of |P dP|; the bound
# is relative to the largest |dbias| (measured on an H100: at most 2.1e-3)
DBIAS_TOL = 2.0 ** -6
# one train step, bf16 on the card against f32 on the CPU, same weights,
# dropout 0, batch 2; towers: Swin; text; projections + fusion stack; head +
# kg_proj. Measured on an H100: loss 3.1e-4 relative, cosine at least
# 0.99982; the bounds leave about 6x room for the bf16 rounding of other seeds
LOSS_RTOL = 2e-3
GRAD_COS_MIN = 0.999
AGREE_B = 2
KG_DIM = 300
# 3 warm-up + 10 timed steps on one batch; with total_steps 13 the warmup is
# one step, so the first update has step size 0 and the rest follow a cosine
# from TRAIN_LR
TRAIN_LR = 1e-4
TRAIN_WARMUP, TRAIN_TIMED = 3, 10


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tensor_bytes(torch, *objs) -> int:
    """Bytes of every tensor in objs (nested in tuples / lists / dicts)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(torch, *o)
        elif isinstance(o, dict):
            total += tensor_bytes(torch, *o.values())
    return total


def cuda_launches(torch, fn):
    """Kernels one call of fn puts on the card, by the profiler's count of
    device kernels; None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def device_ms_by_kernel(torch, fn, reps: int = 5) -> dict:
    """Device ms per call of fn by CUDA kernel name (the profiler's sums over
    ``reps`` calls after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
    return out


def mlp_launch_work(M: int, C: int, blocks: int, int8: bool):
    """(bf16 FLOPs, int8 ops, bytes) of the whole-block call's MLP launch(es)
    (``block_mlp_kernel``) over M rows of width C:
    proj, FC1 and FC2, 18 M C^2 operations a block; the context and the
    residual read once, the weights read once (int8: one byte each), the
    output written once."""
    ops = 18 * M * C * C * blocks
    nbytes = blocks * (3 * M * C * 2 + 9 * C * C * (1 if int8 else 2))
    return (0, ops, nbytes) if int8 else (ops, 0, nbytes)


def attn_launch_work(M: int, C: int, heads: int, nW: int, blocks: int = 1,
                     int8: bool = False, N: int = 49):
    """(bf16 FLOPs, int8 ops, bytes) of the K1 or whole-block call's attention
    launch(es) (``window_attn_wgmma``) over M rows of width C in nW windows of
    N tokens: the qkv GEMM, 6 C^2 a row (int8 ops in W8A8), and the scores and
    P.V, 4 N C a row; the rows read and the context written once, W_qkv (int8:
    one byte each, and its f32 scales) and b_qkv read once, and bias_full
    (nW, heads, N, N) f32."""
    gemm, att = 6 * M * C * C * blocks, 4 * M * N * C * blocks
    wbytes = 3 * C * C + 3 * C * 4 if int8 else 3 * C * C * 2
    nbytes = blocks * (2 * M * C * 2 + wbytes + 3 * C * 2 + nW * heads * N * N * 4)
    return (att, gemm, nbytes) if int8 else (gemm + att, 0, nbytes)


def proj_launch_work(M: int, C: int):
    """(bf16 FLOPs, int8 ops, bytes) of K1's projection launch
    (``k1_proj_wgmma``): 2 M C^2 FLOPs; the context and the residual read, W_o
    and b_o read, the output written once."""
    return 2 * M * C * C, 0, 3 * M * C * 2 + C * C * 2 + C * 2


# a K1 or whole-block call's launches, timed apart by the profiler: kind ->
# (short name of the record's keys, a substring of the CUDA kernel's name)
LAUNCH_KINDS = {"attention": ("attn", "window_attn_wgmma"),
                "projection": ("proj", "k1_proj_wgmma"), "mlp": ("mlp", "block_mlp")}


def attn_flops(M: int, Nk: int, C: int, kv_rows: int) -> int:
    """q and out projections over M query rows, k and v over kv_rows key
    rows, and q k^T plus p v (4 M Nk C over all heads)."""
    return 4 * M * C * C + 4 * kv_rows * C * C + 4 * M * Nk * C


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from mmrp_tpu_torch.api import MMRPredictor, serving_forward
        from mmrp_tpu_torch.config import Config
        from mmrp_tpu_torch.models.multimodal import (
            MultiModalConfig,
            MultiModalRetrievalModel,
            model_routes,
        )
        from mmrp_tpu_torch.models.quant_calib import calibrate_swin_act_amax, save_act_amax
        from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder, stage_routes
        from mmrp_tpu_torch.ops import _build
        from mmrp_tpu_torch.ops import fused_attention as K3
        from mmrp_tpu_torch.ops import fused_mlp as K2
        from mmrp_tpu_torch.ops import fused_swin_block as SB
        from mmrp_tpu_torch.ops import fused_swin_pair as SP
        from mmrp_tpu_torch.ops import fused_window_attention as K1
        from mmrp_tpu_torch.ops import wattn_core as WC
        from mmrp_tpu_torch.ops import window_attention as WA
        from mmrp_tpu_torch.ops.quant import quantize_weight
        from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
        from mmrp_tpu_torch.train.joint import (
            compute_losses,
            init_train_state,
            make_train_step,
        )
        from mmrp_tpu_torch.utils.convert import init_params
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    phase_done("environment")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_log = _build.build(force=True)
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH.relative_to(REPO)}")
    (_build.BUILD_DIR / "nvcc.log").write_text(nvcc_log)
    _build.library()
    phase_done("build")

    # -- 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def ln_params(C):
        return 1 + rnd((C,), 0.1, f32), rnd((C,), 0.1, f32)

    cases = []

    def add_case(name, label, calls, kern, plain, flops, ops8=0, inputs=(), launches=None,
                 faults=None):
        """One kernel case. calls: (calls per run of the kernel's path
        (PATH_OF), per predict on the K1 + K2 route[, {text length: calls per
        predict at that length}]); flops, ops8: bf16 FLOPs and int8 ops of one
        call; inputs: the tensors the wrapper is given, each read once for the
        bound (int8 weights at one byte); launches: {kind (LAUNCH_KINDS): (bf16
        FLOPs, int8 ops, bytes)} of the call's launches, timed and bounded apart;
        faults (int8 only): {planted fault: its plain fn}."""
        cases.append(dict(name=name, label=label, calls=calls, kern=kern, plain=plain,
                          flops=flops, ops8=ops8, inputs=inputs, launches=launches or {},
                          faults=faults or {}))

    def dequant(q, s):
        """The bf16 weight an int8 cache and its scales stand for."""
        return (q.float() * s[:, None]).to(bf16)

    ws = 7
    for C, heads, res, calls, shift in ((128, 4, 56, (2, 2), 3), (256, 8, 28, (0, 2), 3),
                                        (512, 16, 14, (0, 18), 3), (1024, 32, 7, (0, 2), 0)):
        nW = (res // ws) ** 2
        table = rnd(((2 * ws - 1) ** 2, heads), 0.5, f32)
        args = (rnd((B, nW, ws * ws, C)), *ln_params(C), rnd((3 * C, C), C ** -0.5),
                rnd((3 * C,), 0.1), rnd((C, C), C ** -0.5), rnd((C,), 0.1),
                K1.build_bias_full(table, ws, res, res, shift), heads)
        M = B * nW * ws * ws
        add_case("fused_window_attention", f"xw({B},{nW},49,{C}) h{heads}", calls,
                 lambda a=args: K1.fused_window_attention_windows(*a),
                 lambda a=args: K1.window_attention_plain(*a), attn_flops(M, ws * ws, C, M),
                 inputs=args, launches={"attention": attn_launch_work(M, C, heads, nW),
                                        "projection": proj_launch_work(M, C)})

    for M, C, Hd, calls in ((B * 3136, 128, 512, (2, 2)), (B * 784, 256, 1024, (0, 2)),
                            (B * 51, 1024, 4096, (5, 5))):
        args = (rnd((M, C)), *ln_params(C), rnd((Hd, C), C ** -0.5), rnd((Hd,), 0.1),
                rnd((C, Hd), Hd ** -0.5), rnd((C,), 0.1))
        add_case("fused_ln_mlp", f"x({M},{C}) hidden {Hd}", calls,
                 lambda a=args: K2.fused_ln_mlp_residual(*a),
                 lambda a=args: K2.ln_mlp_plain(*a), 4 * M * C * Hd, inputs=args)

    def key_mask(n):
        valid = torch.rand((B, n), generator=gen, device=dev) < 0.8
        valid[:, 0] = True
        return torch.where(valid, 0.0, -1e9).to(f32)

    alpha = torch.tensor(0.5, device=dev)
    # (label, calls per predict, C, heads, Nq, Nk, cross, mask, pos+alpha,
    # ln_mode) at text length L; the image enhancer and the fusion
    # self-attention keep 49 and 51 tokens at every length
    k3_shapes = [(L, shape) for L in TEXT_LENGTHS for shape in (
        ("bert", 12, 768, 12, L, L, False, True, False, "post"),
        ("txt_enh", 5, 1024, 8, L, L, False, True, True, "pre"),
        ("img_enh", 5, 1024, 8, 49, 49, False, False, True, "pre"),
        ("txt2img", 5, 1024, 8, L, 49, True, False, False, "post"),
        ("img2txt", 5, 1024, 8, 49, L, True, True, False, "post"),
        ("self", 5, 1024, 8, 51, 51, False, False, False, "pre"))
        if L == TEXT_LENGTHS[0] or shape[0] not in ("img_enh", "self")]
    k3_launches = {}  # shape label -> CUDA launches of one wrapper call
    for L, (label, calls, C, heads, Nq, Nk, cross, masked, enh, mode) in k3_shapes:
        by_len = {n: calls for n in TEXT_LENGTHS} if Nq != L and Nk != L else {L: calls}
        main = calls if L == TEXT_LENGTHS[0] else 0
        w = []
        for _ in range(4):
            w += [rnd((C, C), C ** -0.5), rnd((C,), 0.1)]
        args = (rnd((B, Nq, C)), *ln_params(C), *w)
        kw = dict(kv=rnd((B, Nk, C)) if cross else None,
                  key_mask=key_mask(Nk) if masked else None,
                  pos=rnd((Nq, C), 0.5) if (enh or label == "self") else None,
                  alpha=alpha if enh else None, num_heads=heads, ln_mode=mode,
                  include_residual=not cross, residual_from_raw=enh)
        shape = f"L{L} {label} ({B},{Nq}<-{Nk},{C}) h{heads} {mode}"
        add_case("fused_attention", shape, (main, main, by_len),
                 lambda a=args, k=kw: K3.fused_attention(*a, **k),
                 lambda a=args, k=kw: K3.attention_plain(*a, **k),
                 attn_flops(B * Nq, Nk, C, B * Nk), inputs=(args, kw))
        if label == "bert":  # the int8 mixes' BERT: W8A8 projections, int8 weight caches
            w8 = [quantize_weight(t) for t in w[0::2]]
            args8 = (args[0], *args[1:3], *(t for (q, _), b in zip(w8, w[1::2]) for t in (q, b)))
            kw8 = dict(kw, quant=True, wscales=tuple(s_ for _, s_ in w8))
            argsf = (args[0], *args[1:3],
                     *(t for (q, s_), b in zip(w8, w[1::2]) for t in (dequant(q, s_), b)))
            for form, n in ((mode, calls), ("none", 0))[:2 if L == TEXT_LENGTHS[0] else 1]:
                k8 = dict(kw8, ln_mode=form, include_residual=form == mode)
                kf = dict(kw, ln_mode=form, include_residual=form == mode)
                add_case("fused_attention_int8", f"L{L} {label} ({B},{Nq}<-{Nk},{C}) "
                         f"h{heads} {form}", (n * (L == TEXT_LENGTHS[0]), 0, {L: n}),
                         lambda a=args8, k=k8: K3.fused_attention(*a, **k),
                         lambda a=args8, k=k8: K3.attention_plain(*a, **k),
                         4 * B * Nq * Nk * C, 8 * B * Nq * C * C, inputs=(args8, k8),
                         faults={"bf16 activations":
                                 lambda a=argsf, k=kf: K3.attention_plain(*a, **k)})

    def swin_block(C, heads, res, shift):
        """12 block tensors (nn.Linear layout) and bias_full at one stage."""
        blk = (*ln_params(C), rnd((3 * C, C), C ** -0.5), rnd((3 * C,), 0.1),
               rnd((C, C), C ** -0.5), rnd((C,), 0.1), *ln_params(C),
               rnd((4 * C, C), C ** -0.5), rnd((4 * C,), 0.1),
               rnd((C, 4 * C), (4 * C) ** -0.5), rnd((C,), 0.1))
        table = rnd(((2 * ws - 1) ** 2, heads), 0.5, f32)
        return blk, K1.build_bias_full(table, ws, res, res, shift)

    def block_work(M, C, heads, nW, blocks=1, int8=False):
        """flops, ops8 and launches (add_case) of a whole-block call over
        `blocks` blocks of M rows in nW windows of 49 tokens a image: bf16 24
        M C^2 + 4 M N C FLOPs a block, or in W8A8 the 24 M C^2 as int8 ops."""
        gemm, att = 24 * M * C * C * blocks, 4 * M * ws * ws * C * blocks
        return dict(flops=att if int8 else gemm + att, ops8=gemm if int8 else 0,
                    launches={"attention": attn_launch_work(M, C, heads, nW, blocks, int8),
                              "mlp": mlp_launch_work(M, C, blocks, int8)})

    def int8_block(blk):
        """The block with its GEMM weights as int8 caches, and their scales."""
        blk, scales = list(blk), []
        for i in SB.GEMM_WEIGHTS:
            blk[i], sc = quantize_weight(blk[i])
            scales.append(sc)
        return tuple(blk), tuple(scales)

    def float_block(blk8, scales):
        """An int8 block with its GEMM weights dequantized to bf16."""
        blk = list(blk8)
        for i, sc in zip(SB.GEMM_WEIGHTS, scales):
            blk[i] = dequant(blk[i], sc)
        return tuple(blk)

    # calibrated-like static activation scales (qkv, proj, FC1, FC2 inputs)
    acts = (5.0 / 127, 3.0 / 127, 5.0 / 127, 4.0 / 127)

    # stage 2: one pair per predict
    C, heads, res = 256, 8, 28
    nW = (res // ws) ** 2
    blk0, bias0 = swin_block(C, heads, res, 0)
    blk1, bias1 = swin_block(C, heads, res, 3)
    x = rnd((B, res, res, C))
    pair_args = (x, blk0, bias0, blk1, bias1, heads, ws, 3)
    add_case("fused_swin_block_pair", f"map({B},{res},{res},{C}) h{heads}", (1, 0),
             lambda a=pair_args: SP.fused_swin_block_pair(*a),
             lambda a=pair_args: SP.pair_plain(*a), inputs=pair_args,
             **block_work(B * res * res, C, heads, nW, 2))
    (q0, s0), (q1, s1) = int8_block(blk0), int8_block(blk1)
    pair8 = (x, q0, bias0, q1, bias1, heads, ws, 3)
    pairf = (x, float_block(q0, s0), bias0, float_block(q1, s1), bias1, heads, ws, 3)
    # calibrated-like scales: 1 per predict at int8_static; per-row scales (no
    # calibration file): 1 per predict at int8_static_per_row
    for name, a8 in (("fused_swin_block_pair_static", acts),
                     ("fused_swin_block_pair_per_row", None)):
        kw8 = dict(quant="static", wscales0=s0, wscales1=s1, act_scales0=a8, act_scales1=a8)
        other = dict(kw8, act_scales0=None if a8 else acts, act_scales1=None if a8 else acts)
        add_case(name, f"map({B},{res},{res},{C}) h{heads}",
                 (1, 0), lambda a=pair8, k=kw8: SP.fused_swin_block_pair(*a, **k),
                 lambda a=pair8, k=kw8: SP.pair_plain(*a, **k), inputs=(pair8, kw8),
                 faults={"bf16 activations": lambda a=pairf: SP.pair_plain(*a),
                         "other activation scales":
                         lambda a=pair8, k=other: SP.pair_plain(*a, **k)},
                 **block_work(B * res * res, C, heads, nW, 2, int8=True))
    # where the static pair's difference arises: its first launch is the
    # chain kernel's with roll -3, so run the blocks one by one, and the second
    # block's plain version on the kernel's own first output
    st = dict(quant="static", act_scales=acts)
    y0k = SP.fused_swin_block_chain(x, q0, bias0, heads, ws, -3, wscales=s0, **st)
    y0p = SP.chain_plain(x, q0, bias0, heads, ws, -3, wscales=s0, **st)
    y1k = SP.fused_swin_block_chain(y0k, q1, bias1, heads, ws, 3, wscales=s1, **st)
    y1k_p = SP.chain_plain(y0k, q1, bias1, heads, ws, 3, wscales=s1, **st)
    y1p = SP.chain_plain(y0p, q1, bias1, heads, ws, 3, wscales=s1, **st)

    def max_rel(got, want):
        return ((got.float() - want.float()).abs() / want.float().abs().clamp(min=1.0)).max()

    log(f"static pair, max_rel_err by block: first block {max_rel(y0k, y0p):.3e}; second "
        f"block on the kernel's first output {max_rel(y1k, y1k_p):.3e}; the second block's "
        f"plain version on the kernel's against on the plain first output "
        f"{max_rel(y1k_p, y1p):.3e}; the two launches against the plain pair "
        f"{max_rel(y1k, y1p):.3e}")
    del y0k, y0p, y1k, y1k_p, y1p
    # stages 2-4 on the dynamic windows flavor (SwinConfig(quant="int8"))
    for C, heads, res, n in ((256, 8, 28, 2), (512, 16, 14, 18), (1024, 32, 7, 2)):
        nW = (res // ws) ** 2
        blk, bias = swin_block(C, heads, res, 0)
        q8, sc = int8_block(blk)
        args = (rnd((B, nW, ws * ws, C)), *q8, bias, heads)
        kw8 = dict(quant=True, wscales=sc)
        argsf = (args[0], *float_block(q8, sc), bias, heads)
        add_case("fused_swin_block_windows_dynamic", f"xw({B},{nW},49,{C}) h{heads}", (n, 0),
                 lambda a=args, k=kw8: SB.fused_swin_block_windows(*a, **k),
                 lambda a=args, k=kw8: SB.swin_block_plain(*a, **k), inputs=(args, kw8),
                 faults={"bf16 activations": lambda a=argsf: SB.swin_block_plain(*a)},
                 **block_work(B * nW * ws * ws, C, heads, nW, int8=True))
    # stage 3: 18 chain steps, rolling into the shifted frame and back
    C, heads, res = 512, 16, 14
    nW = (res // ws) ** 2
    for roll, shift in ((-3, 0), (3, 3)):
        blk, bias = swin_block(C, heads, res, shift)
        args = (rnd((B, res, res, C)), blk, bias, heads, ws, roll)
        add_case("fused_swin_block_chain", f"map({B},{res},{res},{C}) h{heads} roll {roll:+d}",
                 (9, 0), lambda a=args: SP.fused_swin_block_chain(*a),
                 lambda a=args: SP.chain_plain(*a), inputs=args,
                 **block_work(B * res * res, C, heads, nW))
        q8, sc = int8_block(blk)
        argsf = (args[0], float_block(q8, sc), *args[2:])
        args = (args[0], q8, bias, heads, ws, roll)
        # calibrated-like scales (int8_static) and per-row scales (int8_static_per_row)
        for name, a8 in (("fused_swin_block_chain_static", acts),
                         ("fused_swin_block_chain_per_row", None)):
            kw8 = dict(quant="static", wscales=sc, act_scales=a8)
            add_case(name, f"map({B},{res},{res},{C}) h{heads} roll {roll:+d}", (9, 0),
                     lambda a=args, k=kw8: SP.fused_swin_block_chain(*a, **k),
                     lambda a=args, k=kw8: SP.chain_plain(*a, **k), inputs=(args, kw8),
                     faults={"bf16 activations": lambda a=argsf: SP.chain_plain(*a),
                             "other activation scales":
                             lambda a=args, k=dict(kw8, act_scales=None if a8 else acts):
                             SP.chain_plain(*a, **k)},
                     **block_work(B * res * res, C, heads, nW, int8=True))
    # stage 3 geometry on the raw flavor, which no route of the model calls
    x3 = rnd((B, res, res, C))
    args = (x3, *blk, bias, heads, ws)
    add_case("fused_swin_block_raw", f"map({B},{res},{res},{C}) h{heads}", (0, 0),
             lambda a=args: SB.fused_swin_block_raw(*a),
             lambda a=args: SB.raw_plain(*a[:-2], num_heads=a[-2], ws=a[-1]), inputs=args,
             **block_work(B * res * res, C, heads, nW))
    args = (x3, *q8, bias, heads, ws)
    argsf = (x3, *float_block(q8, sc), bias)
    kw8 = dict(quant=True, wscales=sc)
    add_case("fused_swin_block_raw_dynamic", f"map({B},{res},{res},{C}) h{heads}", (0, 0),
             lambda a=args, k=kw8: SB.fused_swin_block_raw(*a, **k),
             lambda a=args, k=kw8: SB.raw_plain(*a[:-2], num_heads=a[-2], ws=a[-1], **k),
             inputs=(args, kw8),
             faults={"bf16 activations": lambda a=argsf, h=heads: SB.raw_plain(*a, num_heads=h,
                                                                                ws=ws)},
             **block_work(B * res * res, C, heads, nW, int8=True))
    # stage 4: the window is the whole 7 x 7 map, so no shift and no roll
    C, heads = 1024, 32
    blk, bias = swin_block(C, heads, 7, 0)
    args = (rnd((B, 1, 49, C)), *blk, bias, heads)
    add_case("fused_swin_block_windows", f"xw({B},1,49,{C}) h{heads}", (2, 0),
             lambda a=args: SB.fused_swin_block_windows(*a),
             lambda a=args: SB.swin_block_plain(*a), inputs=args,
             **block_work(B * 49, C, heads, 1))
    q8, sc = int8_block(blk)
    argsf = (args[0], *float_block(q8, sc), bias, heads)
    args = (args[0], *q8, bias, heads)
    # calibrated scales: 2 per predict at int8_static; per-row scales (no
    # calibration file): 2 per predict at int8_static_per_row
    for name, a8 in (("fused_swin_block_windows_static", acts),
                     ("fused_swin_block_windows_per_row", None)):
        kw8 = dict(quant="static", wscales=sc, act_scales=a8)
        other = dict(kw8, act_scales=None if a8 else acts)
        add_case(name, f"xw({B},1,49,{C}) h{heads}",
                 (2, 0), lambda a=args, k=kw8: SB.fused_swin_block_windows(*a, **k),
                 lambda a=args, k=kw8: SB.swin_block_plain(*a, **k), inputs=(args, kw8),
                 faults={"bf16 activations": lambda a=argsf: SB.swin_block_plain(*a),
                         "other activation scales":
                         lambda a=args, k=other: SB.swin_block_plain(*a, **k)},
                 **block_work(B * 49, C, heads, 1, int8=True))

    per_kernel, problems = {}, []
    with torch.inference_mode():
        for case in cases:
            name, label, kern, plain = case["name"], case["label"], case["kern"], case["plain"]
            calls, calls_k1k2, *by_len = case["calls"]
            flops, ops8 = case["flops"], case["ops8"]
            by_len = by_len[0] if by_len else {}
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name} {label}: non-finite output or wrong shape")
            ref = want.float().abs().clamp(min=1.0)
            sharp, share_max = INT8_SHARE.get(name, INT8_SHARE_BLOCK)
            if isinstance(share_max, dict):  # per text length: K3's int8 cases have one
                (length,) = by_len
                share_max = share_max[length]

            def errors(out):
                """max |out - plain|, its max relative to max(1, |plain|), and
                the share of elements more than ``sharp`` relative apart."""
                d = (out.float() - want.float()).abs()
                return (d.max().item(), (d / ref).max().item(),
                        (d > sharp * ref).float().mean().item())

            err, rel, share = errors(got)
            tol = (INT8_PAIR_TOL if name in PAIRS_INT8 else INT8_TOL) if ops8 else KERNEL_TOL
            ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
            # each input read once and the output written once: the tensors
            # the wrapper is given (the case's inputs, int8 weights at one
            # byte each) and the result; operations: bf16 FLOPs at the bf16
            # rate plus int8 ops at the int8 rate
            nbytes = tensor_bytes(torch, case["inputs"]) + tensor_bytes(torch, got)
            flop_ms = (flops / PEAK_FLOPS + ops8 / PEAK_INT8) * 1e3
            byte_ms = nbytes / PEAK_BYTES * 1e3
            per_call = ""
            if name.startswith("fused_attention"):
                n_cuda = cuda_launches(torch, kern)
                k3_launches[f"{name} {label}"] = n_cuda
                per_call = f"  CUDA launches per call {n_cuda}"
            # device time of one call by CUDA kernel (the profiler's): the CUDA-event
            # time above also holds the host's launch time where the card waits
            split = device_ms_by_kernel(torch, kern)
            extra = dict(device_ms=sum(split.values()))
            per_call += f"  device {extra['device_ms']:.4f} ms"
            # the launches of a K1 or whole-block call apart, each beside its own bound
            for kind, (l_flops, l_ops8, l_bytes) in case["launches"].items():
                short = LAUNCH_KINDS[kind][0]
                extra[f"{short}_ms"] = sum(v for k, v in split.items()
                                           if LAUNCH_KINDS[kind][1] in k)
                extra[f"{short}_bound_ms"] = max(l_flops / PEAK_FLOPS + l_ops8 / PEAK_INT8,
                                                 l_bytes / PEAK_BYTES) * 1e3
                per_call += (f", {kind} launch {extra[f'{short}_ms']:.4f} ms (its bound "
                             f"{extra[f'{short}_bound_ms']:.4f} ms)")
            log(f"kernel {name:24s} {label:36s} max_abs_err {err:.3e} max_rel_err "
                f"{rel:.3e} (tol {tol:.3e})" + (f" share > {sharp:g} {share:.3e} (max "
                                               f"{share_max:g})" if ops8 else "") +
                f"  kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  bound {max(flop_ms, byte_ms):.4f} ms "
                f"({flops / 1e9:.2f} GFLOP bf16, {ops8 / 1e9:.2f} GOP int8, "
                f"{nbytes / 1e6:.2f} MB)  calls {calls} (K1+K2 route {calls_k1k2}"
                + "".join(f", L{n} {c}" for n, c in by_len.items()) + ")" + per_call)
            if rel > tol or (ops8 and share > share_max):
                problems.append(f"{name} {label}: max_rel_err {rel}, share {share}")
            for fault, fn in case["faults"].items():
                _, f_rel, f_share = errors(fn())
                log(f"  planted fault ({fault}) vs plain: max_rel_err {f_rel:.3e} share > "
                    f"{sharp:g} {f_share:.3e}")
                if f_rel <= tol and f_share <= share_max:
                    problems.append(f"{name} {label}: the limits pass the fault ({fault})")
            agg = per_kernel.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                                   bound_ms=0.0, flop_ms=0.0, byte_ms=0.0))
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            # per run of the kernel's path (PATH_OF); a kernel no route calls
            # (raw) is recorded per call
            n = calls if PATH_OF[name] else 1
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("flop_ms", flop_ms),
                             ("byte_ms", byte_ms), ("bound_ms", max(flop_ms, byte_ms)),
                             *extra.items()):
                agg[key] = agg.get(key, 0.0) + n * val
                for length, c in by_len.items():  # K3: per predict at each text length
                    at = agg.setdefault("by_text_length", {}).setdefault(length, {})
                    at[key] = at.get(key, 0.0) + c * val
    del cases, pair_args, pair8, pairf, args, argsf, x, x3, blk, bias, blk0, bias0, blk1, bias1
    del q8, q0, q1
    if problems:
        fail("; ".join(problems))
    phase_done("kernels")

    # -- 4. the slice ----------------------------------------------------------
    cfg = MultiModalConfig.flagship()
    model = MultiModalRetrievalModel(cfg, dtype=bf16, device=dev).eval()
    init_params(model, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    if any(bool((p == 0).all()) for p in model.parameters()):
        fail("a parameter is all zero after the seeded init")
    log(f"model: {n_params / 1e6:.1f} M parameters, bf16 on {dev}, Swin stage routes "
        f"{stage_routes(cfg.swin)}")
    cfg_k1k2 = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, whole_block=False))
    model_k1k2 = MultiModalRetrievalModel(cfg_k1k2, dtype=bf16, device=dev).eval()
    model_k1k2.load_state_dict(model.state_dict())
    routes = {"whole": model, "k1k2": model_k1k2}
    log(f"K1 + K2 route: Swin stage routes {stage_routes(cfg_k1k2.swin)}")

    def no_plain_route(route, m):
        """The flagship's plan on this route: every kernel call site on a
        kernel (or a JAX W8A8 XLA) route, none on a plain one."""
        counts = {}
        for r in m.routes.values():
            counts[r] = counts.get(r, 0) + 1
        log(f"{route} route: call sites by route {counts}")
        plain = [site for site, r in m.routes.items() if r == "plain"]
        if plain:
            fail(f"{route} route: call sites on a plain route: {plain}")

    for route, m in routes.items():
        no_plain_route(route, m)

    import numpy as np

    rng = np.random.default_rng(SEED)
    images = rng.random((B, 224, 224, 3), dtype=np.float32)
    ids = rng.integers(0, cfg.text.vocab_size, (B, 64)).astype(np.int64)
    lengths = np.concatenate([[64], rng.integers(4, 64, B - 1)])
    mask = (np.arange(64)[None, :] < lengths[:, None]).astype(np.int64)

    labels = [f"label{i}" for i in range(cfg.num_classes)]
    first = MMRPredictor(model, labels).embed(images, ids, mask)
    emb = first["joint_emb"]
    gallery = torch.randn((100_000, cfg.joint_dim), generator=gen, device=dev).cpu().numpy()
    gallery_ids = [f"g{i}" for i in range(len(gallery))] + [f"req{b}" for b in range(B)]
    engine = RetrievalEngine(np.concatenate([gallery, emb]), gallery_ids, device=dev)

    counters = {  # kernel -> (its wrapper, the wrapper's count of that kernel's launches)
        "fused_window_attention": (K1.fused_window_attention_windows, "launches"),
        "fused_ln_mlp": (K2.fused_ln_mlp_residual, "launches"),
        "fused_attention": (K3.fused_attention, "launches"),
        "fused_attention_int8": (K3.fused_attention, "launches_int8"),
        "fused_swin_block_windows": (SB.fused_swin_block_windows, "launches"),
        "fused_swin_block_windows_static": (SB.fused_swin_block_windows, "launches_static"),
        "fused_swin_block_windows_per_row": (SB.fused_swin_block_windows, "launches_per_row"),
        "fused_swin_block_windows_dynamic": (SB.fused_swin_block_windows, "launches_dynamic"),
        "fused_swin_block_raw": (SB.fused_swin_block_raw, "launches"),
        "fused_swin_block_raw_dynamic": (SB.fused_swin_block_raw, "launches_dynamic"),
        "fused_swin_block_chain": (SP.fused_swin_block_chain, "launches"),
        "fused_swin_block_chain_static": (SP.fused_swin_block_chain, "launches_static"),
        "fused_swin_block_chain_per_row": (SP.fused_swin_block_chain, "launches_per_row"),
        "fused_swin_block_pair": (SP.fused_swin_block_pair, "launches"),
        "fused_swin_block_pair_static": (SP.fused_swin_block_pair, "launches_static"),
        "fused_swin_block_pair_per_row": (SP.fused_swin_block_pair, "launches_per_row"),
    }

    plain_counters = (K1.fused_window_attention_windows, K2.fused_ln_mlp_residual,
                      K3.fused_attention, SB.fused_swin_block_windows, SB.fused_swin_block_raw,
                      SP.fused_swin_block_chain, SP.fused_swin_block_pair)

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        for fn in plain_counters:
            fn.plain_calls = 0

    def read_counts():
        plain = {fn.__name__: fn.plain_calls for fn in plain_counters if fn.plain_calls}
        if plain:
            fail(f"calls on a plain route: {plain}")
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    preds, launches = {}, {}

    def text_batch(L):
        """Seeded token ids and a ragged mask at text length L (request 0 full)."""
        if L == TEXT_LENGTHS[0]:
            return ids, mask
        r = np.random.default_rng(SEED + L)
        ids_l = r.integers(0, cfg.text.vocab_size, (B, L)).astype(np.int64)
        lengths_l = np.concatenate([[L], r.integers(4, L, B - 1)])
        return ids_l, (np.arange(L)[None, :] < lengths_l[:, None]).astype(np.int64)

    def drive(route, predictor, ids=ids, mask=mask):
        """One predict on a serving path, its counts set to 0 just before and
        read just after: launches as worked out, outputs finite, each
        request's own id at rank 1."""
        reset_counts()
        pred = predictor.predict(images, ids, mask, K=10)
        torch.cuda.synchronize()
        launches[route] = read_counts()
        log(f"launches in one predict (batch {B}), {route} route: "
            f"{ {k: v for k, v in launches[route].items() if v} }")
        if launches[route] != EXPECTED[route]:
            fail(f"{route} route: launch counts {launches[route]}, expected {EXPECTED[route]}")
        probs, joint = pred["probs"], pred["joint_emb"]
        if probs.shape != (B, cfg.num_classes) or joint.shape != (B, cfg.joint_dim):
            fail(f"{route} route: output shapes {probs.shape} {joint.shape}")
        if not (np.isfinite(probs).all() and np.isfinite(joint).all()):
            fail(f"{route} route: non-finite outputs")
        top1 = [hits[0][0] for hits in pred["retrieval"]]
        log(f"{route} route: top-1 ids {top1}")
        if top1 != [f"req{b}" for b in range(B)]:
            fail(f"{route} route: a request's own id is not at rank 1")
        return pred

    for route, m in routes.items():
        preds[route] = drive(route, MMRPredictor(m, labels, retriever=engine, threshold=0.5))

    def cosine(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    # plain path: the same weights in f32 on the CPU, where every wrapper
    # runs its plain-PyTorch version (on the default route's plan)
    ref = MultiModalRetrievalModel(cfg, dtype=f32, device="cpu").eval()
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    want = serving_forward(ref)(torch.from_numpy(images), torch.from_numpy(ids),
                                torch.from_numpy(mask))
    log(f"plain path (f32, CPU): {time.perf_counter() - t0:.1f} s")
    wj, wp = want["joint_emb"].numpy(), want["probs"].numpy()
    for route, pred in preds.items():
        cos = cosine(pred["joint_emb"], wj)
        dprobs = float(np.abs(pred["probs"] - wp).max())
        log(f"{route} route vs plain path: joint_emb cosine min {cos.min():.6f} "
            f"(>= {EMB_COS_MIN}), max |dprobs| {dprobs:.3e} (<= {PROBS_MAX_DIFF}), "
            f"probs in [{pred['probs'].min():.3f}, {pred['probs'].max():.3f}]")
        if cos.min() < EMB_COS_MIN or dprobs > PROBS_MAX_DIFF:
            fail(f"{route} route: kernel path and plain path disagree")
    dimg = float(np.abs(first["img_emb"] - want["img_emb"].numpy()).max())
    dtxt = float(np.abs(first["txt_emb"] - want["txt_emb"].numpy()).max())
    between = cosine(preds["whole"]["joint_emb"], preds["k1k2"]["joint_emb"])
    log(f"whole route: max |d img_emb| {dimg:.3e}, max |d txt_emb| {dtxt:.3e}; joint_emb "
        f"cosine between the routes min {between.min():.6f}")
    # the default route at the longer text lengths: K3 over 128 and 512
    # tokens in the BERT layers, the text enhancer and both cross attentions
    wants = {TEXT_LENGTHS[0]: (wj, wp)}
    for L in TEXT_LENGTHS[1:]:
        ids_l, mask_l = text_batch(L)
        emb_l = MMRPredictor(model, labels).embed(images, ids_l, mask_l)["joint_emb"]
        engine_l = RetrievalEngine(np.concatenate([gallery, emb_l]), gallery_ids, device=dev)
        route = f"whole_L{L}"
        preds[route] = drive(route, MMRPredictor(model, labels, retriever=engine_l,
                                                 threshold=0.5), ids_l, mask_l)
        del engine_l
        t0 = time.perf_counter()
        want_l = serving_forward(ref)(torch.from_numpy(images), torch.from_numpy(ids_l),
                                      torch.from_numpy(mask_l))
        wants[L] = want_l["joint_emb"].numpy(), want_l["probs"].numpy()
        cos = cosine(preds[route]["joint_emb"], wants[L][0])
        dprobs = float(np.abs(preds[route]["probs"] - wants[L][1]).max())
        log(f"{route} vs plain path (f32, CPU, {time.perf_counter() - t0:.1f} s): joint_emb "
            f"cosine min {cos.min():.6f} (>= {EMB_COS_MIN}), max |dprobs| {dprobs:.3e} "
            f"(<= {PROBS_MAX_DIFF})")
        if cos.min() < EMB_COS_MIN or dprobs > PROBS_MAX_DIFF:
            fail(f"{route}: kernel path and plain path disagree")
    del ref
    phase_done("slice")

    # -- 4b. int8 serving: calibration, the int8 mixes, dynamic Swin ----------
    t0 = time.perf_counter()
    amax = calibrate_swin_act_amax(model.backbones.swin, images, batch_size=B)
    amax_path = _build.BUILD_DIR / "swin_act_amax.json"
    save_act_amax(str(amax_path), amax)
    flat = np.asarray(amax)
    log(f"calibration (plain f32 Swin forward on {dev}, {B} images): "
        f"{time.perf_counter() - t0:.1f} s, {len(amax)} blocks, act amax in "
        f"[{flat.min():.3f}, {flat.max():.3f}] -> {amax_path.relative_to(REPO)}")
    state = model.state_dict()
    for route, serve_quant in (("int8_static", dict(serve_quant="int8_static",
                                                    swin_act_amax_path=str(amax_path))),
                               ("int8_static_per_row", dict(serve_quant="int8_static")),
                               ("int8", dict(serve_quant="int8"))):
        qcfg = MultiModalConfig.from_config(Config(**serve_quant), flagship=True)
        if qcfg.swin.act_amax != (amax if route == "int8_static" else None):
            fail(f"{route}: act_amax did not round-trip through {amax_path}")
        m8 = MultiModalRetrievalModel(qcfg, dtype=bf16, device=dev).eval()
        m8.load_state_dict(state)
        no_plain_route(route, m8)
        routes[route] = m8
        emb8 = MMRPredictor(m8, labels).embed(images, ids, mask)["joint_emb"]
        engine8 = RetrievalEngine(np.concatenate([gallery, emb8]), gallery_ids, device=dev)
        preds[route] = drive(route, MMRPredictor(m8, labels, retriever=engine8,
                                                 threshold=0.5))
        cos = cosine(preds[route]["joint_emb"], wj)
        dprobs = float(np.abs(preds[route]["probs"] - wp).max())
        log(f"{route} route vs the f32 unquantized plain path: joint_emb cosine min "
            f"{cos.min():.6f} (> {INT8_COS_MIN}), max |dprobs| {dprobs:.3e}")
        if not cos.min() > INT8_COS_MIN:
            fail(f"{route} route: int8 joint_emb strays from the f32 plain path")
        del engine8
        if route == "int8_static":  # and at the JAX serving default's 512 tokens
            L = TEXT_LENGTHS[-1]
            ids_l, mask_l = text_batch(L)
            emb8 = MMRPredictor(m8, labels).embed(images, ids_l, mask_l)["joint_emb"]
            engine8 = RetrievalEngine(np.concatenate([gallery, emb8]), gallery_ids, device=dev)
            r512 = f"{route}_L{L}"
            preds[r512] = drive(r512, MMRPredictor(m8, labels, retriever=engine8,
                                                   threshold=0.5), ids_l, mask_l)
            cos = cosine(preds[r512]["joint_emb"], wants[L][0])
            dprobs = float(np.abs(preds[r512]["probs"] - wants[L][1]).max())
            log(f"{r512} vs the f32 unquantized plain path: joint_emb cosine min "
                f"{cos.min():.6f} (> {INT8_COS_MIN}), max |dprobs| {dprobs:.3e}")
            if not cos.min() > INT8_COS_MIN:
                fail(f"{r512}: int8 joint_emb strays from the f32 plain path")
            del engine8
    # one Swin-B forward at quant="int8": every whole-block stage on the
    # dynamic W8A8 windows flavor
    enc = SwinEncoder(SwinConfig.base(quant="int8"), dtype=bf16, device=dev).eval()
    enc.load_state_dict(model.backbones.swin.state_dict())
    img_t = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        ref_global = model.backbones.swin(img_t)["global"].float()
        reset_counts()
        out = enc(img_t)
        torch.cuda.synchronize()
        launches["swin_int8"] = read_counts()
    log(f"launches in one Swin-B forward (batch {B}) at quant='int8': "
        f"{ {k: v for k, v in launches['swin_int8'].items() if v} }")
    if launches["swin_int8"] != EXPECTED["swin_int8"]:
        fail(f"swin_int8: launch counts {launches['swin_int8']}, "
             f"expected {EXPECTED['swin_int8']}")
    g8 = out["global"].float()
    if g8.shape != ref_global.shape or not torch.isfinite(out["patches"]).all():
        fail("swin_int8: non-finite output or wrong shape")
    cos = torch.nn.functional.cosine_similarity(g8, ref_global, dim=1).min().item()
    log(f"swin_int8: global cosine against the bf16 encoder min {cos:.6f} (> {INT8_COS_MIN})")
    if not cos > INT8_COS_MIN:
        fail("swin_int8: the dynamic int8 encoder strays from the bf16 one")
    # Swin-T (C 96 / 192 / 384 / 768, K1 + K2 at stages 1-2: widths that are
    # not multiples of 128) on its kernels, against its plain route
    tiny = SwinConfig.tiny()
    enc_t = SwinEncoder(tiny, dtype=bf16, device=dev).eval()
    init_params(enc_t, seed=SEED)
    enc_p = SwinEncoder(dataclasses.replace(tiny, use_pallas=False), dtype=bf16,
                        device=dev).eval()
    enc_p.load_state_dict(enc_t.state_dict())
    with torch.inference_mode():
        reset_counts()
        out = enc_t(img_t)["global"].float()
        torch.cuda.synchronize()
        launches["swin_tiny"] = {k: v for k, v in read_counts().items() if v}
        want = enc_p(img_t)["global"].float()
    log(f"launches in one Swin-T forward (batch {B}): {launches['swin_tiny']}")
    if launches["swin_tiny"] != EXPECTED["swin_tiny"]:
        fail(f"swin_tiny: launch counts {launches['swin_tiny']}, "
             f"expected {EXPECTED['swin_tiny']}")
    cos = torch.nn.functional.cosine_similarity(out, want, dim=1).min().item()
    log(f"swin_tiny: global cosine against its plain route min {cos:.6f} (> {EMB_COS_MIN})")
    if not torch.isfinite(out).all() or not cos > EMB_COS_MIN:
        fail("swin_tiny: the kernel route strays from the plain one")
    del enc, out, img_t, ref_global, state, m8, enc_t, enc_p, want

    # throughput of every route (the default and int8_static also at the
    # longer text lengths) and retrieval latency, for information
    for batch in (8, 64):
        img_d = torch.rand((batch, 224, 224, 3), generator=gen, device=dev)
        for L in TEXT_LENGTHS:
            ids_d = torch.randint(0, cfg.text.vocab_size, (batch, L), generator=gen, device=dev)
            mask_d = torch.ones((batch, L), dtype=torch.int64, device=dev)
            for route, m in routes.items():
                if L != TEXT_LENGTHS[0] and route not in ("whole", "int8_static"):
                    continue
                fwd = serving_forward(m)
                ms = cuda_ms(torch, lambda: fwd(img_d, ids_d, mask_d), reps=10, warmup=2)
                log(f"embed batch {batch}, L{L}, {route} route: {ms:.2f} ms per forward, "
                    f"{batch / ms * 1e3:.1f} pairs/s")
    q = preds["whole"]["joint_emb"][0]
    times = []
    for i in range(53):
        t0 = time.perf_counter()
        engine.retrieve(q, K=10)
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    log(f"top-10 over {len(gallery_ids)} x {cfg.joint_dim}: p50 "
        f"{statistics.median(times):.3f} ms (host clock, query upload to ids)")
    del model, model_k1k2, routes, m, engine, fwd, img_d, ids_d, mask_d
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("int8 serving and throughput")

    # -- 5. the training kernels against their plain versions ------------------
    def check(name, label, err, rel, tol):
        log(f"kernel {name:24s} {label:44s} max_abs_err {err:.3e} max_rel_err {rel:.3e} "
            f"(tol {tol:.3e})")
        if not rel <= tol:
            fail(f"{name} {label}: max_rel_err {rel} > {tol}")

    def rel_err(got, want):
        diff = (got.float() - want.float()).abs()
        return diff.max().item(), (diff / want.float().abs().clamp(min=1.0)).max().item()

    def record(name, label, err, ms, plain_ms, flops, nbytes, n, library_ms=None):
        flop_ms, byte_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        log(f"kernel {name:24s} {label:44s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {max(flop_ms, byte_ms):.4f} ms ({flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)" + ("" if library_ms is None else
                                         f"  library {library_ms:.4f} ms") + f"  calls {n}")
        agg = per_kernel.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                               bound_ms=0.0, flop_ms=0.0, byte_ms=0.0))
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("flop_ms", flop_ms),
                         ("byte_ms", byte_ms), ("bound_ms", max(flop_ms, byte_ms))):
            agg[key] += n * val
        if library_ms is not None:
            agg["library_ms"] = agg.get("library_ms", 0.0) + n * library_ms

    # C-B's clusters: how many of 1 to 8 blocks the card holds at once (the
    # launcher asks for them), and the ranks and images a rank of each shape
    fit = [_build.library().mmrp_core_fit(ws, r) for r in range(1, 9)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {f"{res}x{res} h{heads} B{Bc}": WC.core_plan(Bc, (res // ws) ** 2, heads, ws, sms,
                                                          fit)[1:3]
             for Bc, res, C, heads, _ in CORE_STAGES}
    log(f"wattn_core_bwd: clusters of 1..8 blocks held at once {fit}; (ranks, images a rank) "
        f"{plans}")
    for Bc, res, C, heads, calls in CORE_STAGES:
        for shift in (0, 3):
            label = f"qkv({Bc},{res},{res},{3 * C}) h{heads} shift {shift}"
            qkv = rnd((Bc, res, res, 3 * C))
            table = rnd(((2 * ws - 1) ** 2, heads), 0.5, f32)
            bias = K1.build_bias_full(table, ws, res, res, shift)
            dout = rnd((Bc, res, res, C))
            kw = dict(ws=ws, shift=shift, num_heads=heads, scale=(C // heads) ** -0.5)
            with torch.no_grad():
                out = WC.core_forward(qkv, bias, **kw)
                dqkv, dbias = WC.core_backward(qkv, bias, dout, **kw)
                dqkv2, dbias2 = WC.core_backward(qkv, bias, dout, **kw)
                want = WC.window_attention_core_plain(qkv, bias, **kw)
            want_dqkv, want_dbias = WC.core_backward_plain(qkv, bias, dout, **kw)
            torch.cuda.synchronize()
            for t in (out, dqkv, dbias):
                if not torch.isfinite(t).all():
                    fail(f"core {label}: non-finite output")
            if not (torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)):
                fail(f"wattn_core_bwd {label}: two launches differ")
            f_err, f_rel = rel_err(out, want)
            check("wattn_core_fwd", label, f_err, f_rel, KERNEL_TOL)
            b_err, b_rel = rel_err(dqkv, want_dqkv)
            check("wattn_core_bwd", label + " dqkv", b_err, b_rel, KERNEL_TOL)
            db_err = (dbias - want_dbias).abs().max().item()
            check("wattn_core_bwd", label + " dbias", db_err,
                  db_err / want_dbias.abs().max().item(), DBIAS_TOL)
            log(f"kernel wattn_core_bwd {label}: dbias bit-identical over two launches")
            # per (image, window, head) and product 2 * 49 * 49 * d FLOPs:
            # two products forward; S, dV, dP, dQ and dK backward
            prod = 2 * Bc * res * res * ws * ws * C
            # the CUDA-event time holds the wrapper's host time where the card
            # waits; profile_forward --train splits the step's device time by stage
            ms = cuda_ms(torch, lambda: WC.core_forward(qkv, bias, **kw))
            plain_ms = cuda_ms(torch, lambda: WC.window_attention_core_plain(qkv, bias, **kw))
            record("wattn_core_fwd", label, f_err, ms, plain_ms, 2 * prod,
                   tensor_bytes(torch, qkv, bias, out), calls)
            ms = cuda_ms(torch, lambda: WC.core_backward(qkv, bias, dout, **kw))
            plain_ms = cuda_ms(torch, lambda: WC.core_backward_plain(qkv, bias, dout, **kw))
            record("wattn_core_bwd", label, max(b_err, db_err), ms, plain_ms, 5 * prod,
                   tensor_bytes(torch, qkv, bias, dout, dqkv, dbias), calls)
    del qkv, bias, dout, out, dqkv, dbias, dqkv2, dbias2, want, want_dqkv, want_dbias

    # W at the Swin-B stage-1 geometry (64 windows x 4 heads, d 32), tokens
    # padded to 64, batch 8: no route calls it
    heads, d, res, shift = 4, 32, 56, 3
    bias2 = WA.build_combined_bias(rnd(((2 * ws - 1) ** 2, heads), 0.5, f32), ws, res, res,
                                   shift, 64)
    G = bias2.shape[0]
    q, k, v = (rnd((B, G, 64, d)) for _ in range(3))
    label = f"q/k/v({B},{G},64,{d}) shift {shift}"
    # the library call takes its additive mask in the query's dtype on the card
    bias2_lib = bias2.to(q.dtype)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias2_lib,
                                                                scale=d ** -0.5)

    with torch.no_grad():
        got = WA.window_attention_heads(q, k, v, bias2, d ** -0.5)
        want = WA.window_attention_xla(q, k, v, bias2, d ** -0.5)
        lib = library()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"window_attention_heads {label}: non-finite output")
    w_err, w_rel = rel_err(got, want)
    check("window_attention_heads", label, w_err, w_rel, KERNEL_TOL)
    log(f"library scaled_dot_product_attention vs plain: max_abs_err "
        f"{rel_err(lib, want)[0]:.3e}")
    with torch.no_grad():
        record("window_attention_heads", label, w_err,
               cuda_ms(torch, lambda: WA.window_attention_heads(q, k, v, bias2, d ** -0.5)),
               cuda_ms(torch, lambda: WA.window_attention_xla(q, k, v, bias2, d ** -0.5)),
               4 * B * G * 64 * 64 * d, tensor_bytes(torch, q, k, v, bias2, got), 1,
               library_ms=cuda_ms(torch, library))
    del q, k, v, bias2, bias2_lib, got, want, lib
    phase_done("training kernels")

    # -- 6. one train step: the card (bf16) against the plain path (f32, CPU) ---
    counters.update({"wattn_core_fwd": (WC.core_forward, "launches"),
                     "wattn_core_bwd": (WC.core_backward, "launches"),
                     "window_attention_heads": (WA.window_attention_heads, "launches")})
    plain_counters += (WC.window_attention_core,)

    def train_batch(n):
        return {
            "image": rng.random((n, 224, 224, 3), dtype=np.float32),
            "input_ids": rng.integers(0, cfg.text.vocab_size, (n, 64)).astype(np.int64),
            "attention_mask": (np.arange(64)[None, :] < np.concatenate(
                [[64], rng.integers(4, 64, n - 1)])[:, None]).astype(np.int64),
            "labels": (rng.random((n, cfg.num_classes)) < 0.3).astype(np.float32),
            "kg_target": rng.standard_normal((n, KG_DIM)).astype(np.float32),
            "kg_target_valid": np.ones(n, np.float32),
        }

    def tower(name):
        if name.startswith("backbones.swin."):
            return "swin"
        if name.startswith("backbones.text."):
            return "text"
        if name.startswith(("cls_hidden.", "cls_out.")):
            return "head"
        return "fusion"

    nodrop = dataclasses.replace(cfg, dropout=0.0, drop_path=0.0,
                                 swin=dataclasses.replace(cfg.swin, drop_path_rate=0.0),
                                 text=dataclasses.replace(cfg.text, dropout=0.0))
    tcfg = Config(lr=TRAIN_LR, seed=SEED)
    agree_batch = train_batch(AGREE_B)
    kg_proj = (torch.randn((cfg.joint_dim, KG_DIM), generator=gen, device=dev)
               / cfg.joint_dim ** 0.5).cpu()

    def loss_and_grads(model, device):
        batch = {key: torch.from_numpy(val).to(device) for key, val in agree_batch.items()}
        kg = kg_proj.to(device, copy=True).requires_grad_(True)
        total, metrics = compute_losses(model, kg, batch, torch.Generator(device=device),
                                        tcfg, torch.ones(cfg.num_classes, device=device))
        total.backward()
        grads = {"swin": [], "text": [], "fusion": [], "head": [kg.grad]}
        for name, p in model.named_parameters():
            grads[tower(name)].append(p.grad if p.grad is not None else torch.zeros_like(p))
        flat = {key: torch.cat([g.detach().float().flatten().cpu() for g in gs])
                for key, gs in grads.items()}
        return float(total.detach()), {key: float(val.detach()) for key, val in
                                       metrics.items()}, flat

    card = MultiModalRetrievalModel(nodrop, dtype=bf16, device=dev)
    init_params(card, seed=SEED)
    plain = MultiModalRetrievalModel(nodrop, dtype=f32, device="cpu")
    plain.load_state_dict({key: val.float().cpu() for key, val in card.state_dict().items()})
    loss_card, terms_card, grads_card = loss_and_grads(card, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_plain, terms_plain, grads_plain = loss_and_grads(plain, torch.device("cpu"))
    log(f"train agreement: plain path (f32, CPU, batch {AGREE_B}) forward + backward "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"train agreement: card {terms_card}")
    log(f"train agreement: plain {terms_plain}")
    loss_rel = abs(loss_card - loss_plain) / abs(loss_plain)
    cos = {key: float(torch.nn.functional.cosine_similarity(
        grads_card[key].double(), grads_plain[key].double(), dim=0)) for key in grads_plain}
    log(f"train agreement: loss {loss_card:.6f} vs {loss_plain:.6f} (rel {loss_rel:.3e}, "
        f"<= {LOSS_RTOL}); gradient cosine per tower {cos} (>= {GRAD_COS_MIN})")
    if not loss_rel <= LOSS_RTOL or min(cos.values()) < GRAD_COS_MIN:
        fail("train step: the card and the plain path disagree")
    del card, plain, grads_card, grads_plain
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("train agreement")

    # -- 7. the train slice: flagship, batch 64, default dropout ----------------
    train_routes = model_routes(cfg, train=True)
    log(f"train route: call sites {train_routes}")
    plain = [site for site, r in train_routes.items() if r == "plain"]
    if plain or len(train_routes) != 3:
        fail(f"train route: call sites on a plain route: {plain} (of {train_routes})")
    model = MultiModalRetrievalModel(cfg, dtype=bf16, device=dev)
    init_params(model, seed=SEED)
    steps = TRAIN_WARMUP + TRAIN_TIMED
    state = init_train_state(model, tcfg, seed=SEED, total_steps=steps, kg_dim=KG_DIM)
    step = make_train_step(model, tcfg, pos_weight=np.ones(cfg.num_classes, np.float32))
    batch = {key: torch.from_numpy(val).to(dev) for key, val in train_batch(TRAIN_B).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    reset_counts()
    for i in range(steps):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        per_step = {name: n - before[name] for name, n in read_counts().items()}
        loss, gnorm = metrics["loss/total"], metrics["grad_norm"]
        log(f"train step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.4f}, "
            f"{start.elapsed_time(end):.2f} ms, cls {metrics['loss/cls']:.4f}, contrastive "
            f"{metrics['loss/contrastive']:.4f}, kg {metrics['loss/kg_align']:.4f}")
        if per_step != EXPECTED_TRAIN:
            fail(f"train step {i + 1}: launches {per_step}, expected {EXPECTED_TRAIN}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"train step {i + 1}: non-finite loss or grad_norm")
        losses.append(loss)
        if i >= TRAIN_WARMUP:
            step_ms.append(start.elapsed_time(end))
    train_launches = read_counts()
    step_launches = per_step  # the last step's; every step's was asserted equal above
    log(f"launches in {steps} train steps (batch {TRAIN_B}): {train_launches}")
    if losses[-1] >= losses[0]:
        fail(f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    ms = statistics.median(step_ms)
    log(f"train step (batch {TRAIN_B}, L64): median {ms:.2f} ms over {TRAIN_TIMED} steps "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}), {TRAIN_B / ms * 1e3:.1f} "
        f"train pairs/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    phase_done("train slice")

    # -- 8. records ------------------------------------------------------------
    # launches, and ms / plain_ms / bound_ms: counted or summed over the calls
    # of one run of the kernel's path at the shapes above (PATH_OF; "per":
    # "predict" on the default route or an int8 mix, "encoder forward" at
    # Swin quant="int8", "train step" for the core, whose launches_train is
    # the total over all train_steps), or one call for a kernel no route
    # calls. launches_by_path holds every path's count. No single PyTorch
    # call computes the serving kernels' functions (LN + projections +
    # attention [+ MLP] in one, in bf16 or W8A8) or the core's (roll,
    # partition, attention and reverse in one), so their library_ms is null;
    # W's is scaled_dot_product_attention's.
    per_label = {"whole": "predict", "int8_static": "predict", "int8_static_per_row": "predict",
                 "swin_int8": "encoder forward",
                 "train": "train step", None: "call"}
    launches["train"] = step_launches
    records = []
    for name, (src, rep) in SOURCES.items():
        agg = per_kernel[name]
        path = PATH_OF[name]
        extra = {}
        if "by_text_length" in agg:  # K3: per predict at each text length, its own path's launches
            extra["by_text_length"] = {
                L: dict(at, launches=launches.get(path if L == TEXT_LENGTHS[0] else
                                                  f"{path}_L{L}", {}).get(name))
                for L, at in sorted(agg["by_text_length"].items())}
            extra["cuda_launches_per_call"] = {label: n for label, n in k3_launches.items()
                                               if label.startswith(name + " ")}
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[path][name] if path else 0,
            "max_abs_err": agg["max_abs_err"],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": "operations" if agg["flop_ms"] >= agg["byte_ms"] else "bytes",
            "library_ms": agg.get("library_ms"), "per": per_label[path],
            "path": path or "none",
            "launches_by_path": {k: v.get(name, 0) for k, v in launches.items()},
            "launches_train": train_launches[name], "train_steps": steps,
            **{k: agg[k] for k in ("device_ms", "attn_ms", "attn_bound_ms", "proj_ms",
                                   "proj_bound_ms", "mlp_ms", "mlp_bound_ms") if k in agg},
            **extra})
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
