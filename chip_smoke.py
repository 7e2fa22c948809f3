#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmrp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which fails the run (nonzero exit, no result line):
1. environment: the card's name and power limit, CUDA and nvcc versions;
2. build: the kernels from mmrp_tpu_torch/csrc with nvcc, timed;
3. kernels: each hand-written kernel against its plain-PyTorch version on
   the same bf16 inputs, at every shape the flagship serving path gives it
   (batch 8) on either Swin route, then the median CUDA-event time of each
   and its bound (bytes over 3.35 TB/s or FLOPs over 989 TFLOP/s);
4. slice: the flagship model (Swin-B 224 px, ClinicalBERT dims, 5 fusion
   layers at 1024, 43 labels) in bf16 from a seeded init, ``MMRPredictor
   .predict`` on 8 requests against a 100,000 x 1024 gallery that also holds
   the requests' own embeddings, on the default route (Swin stages 2-4
   through the whole-block kernels: pair, chain, windows) and on the K1 + K2
   route (``whole_block=False``) with the same weights: launch counts per
   predict on each, each request's own id at rank 1, and agreement with the
   plain path (the same weights in f32 on the CPU, where every wrapper runs
   its plain version). Then embed pairs/s of both routes at batch 8 and 64
   and the top-10 latency over the gallery, for information.
The last two lines are the kernels' JSON record and the result line
{"ok": true, "device": {...}}.
"""

import dataclasses
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
# launches per predict of B requests, worked out from the Swin routing
# (models/swin.py::swin_plan): on the default route stage 1 is K1 + K2
# (2 blocks), stage 2 one pair, stage 3 18 chain steps, stage 4 2 windows
# blocks; K2 also carries the 5 fusion FFNs and K3 the 12 BERT layers and
# 5 x 5 fusion attentions. The K1 + K2 route runs all 24 Swin blocks on K1
# and their MLPs on K2 at C <= 256.
EXPECTED = {
    "whole": {"fused_window_attention": 2, "fused_ln_mlp": 7, "fused_attention": 37,
              "fused_swin_block_windows": 2, "fused_swin_block_raw": 0,
              "fused_swin_block_chain": 18, "fused_swin_block_pair": 1},
    "k1k2": {"fused_window_attention": 24, "fused_ln_mlp": 9, "fused_attention": 37,
             "fused_swin_block_windows": 0, "fused_swin_block_raw": 0,
             "fused_swin_block_chain": 0, "fused_swin_block_pair": 0},
}
SOURCES = {  # kernel -> (CUDA source, TPU kernel it replaces)
    "fused_window_attention": ("mmrp_tpu_torch/csrc/window_attention.cu",
                               "mmrp_tpu/ops/fused_window_attention.py:251"),
    "fused_ln_mlp": ("mmrp_tpu_torch/csrc/ln_mlp.cu", "mmrp_tpu/ops/fused_mlp.py:122"),
    "fused_attention": ("mmrp_tpu_torch/csrc/seq_attention.cu",
                        "mmrp_tpu/ops/fused_attention.py:355"),
    "fused_swin_block_windows": ("mmrp_tpu_torch/csrc/swin_block.cu",
                                 "mmrp_tpu/ops/fused_swin_block.py:670"),
    "fused_swin_block_raw": ("mmrp_tpu_torch/csrc/swin_block.cu",
                             "mmrp_tpu/ops/fused_swin_block.py:545"),
    "fused_swin_block_chain": ("mmrp_tpu_torch/csrc/swin_block.cu",
                               "mmrp_tpu/ops/fused_swin_pair.py:432"),
    "fused_swin_block_pair": ("mmrp_tpu_torch/csrc/swin_block.cu",
                              "mmrp_tpu/ops/fused_swin_pair.py:252"),
}


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
        from mmrp_tpu_torch.models.multimodal import (
            MultiModalConfig,
            MultiModalRetrievalModel,
        )
        from mmrp_tpu_torch.models.swin import stage_routes
        from mmrp_tpu_torch.ops import _build
        from mmrp_tpu_torch.ops import fused_attention as K3
        from mmrp_tpu_torch.ops import fused_mlp as K2
        from mmrp_tpu_torch.ops import fused_swin_block as SB
        from mmrp_tpu_torch.ops import fused_swin_pair as SP
        from mmrp_tpu_torch.ops import fused_window_attention as K1
        from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
        from mmrp_tpu_torch.utils.convert import init_params
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_log = _build.build(force=True)
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH.relative_to(REPO)}")
    (_build.BUILD_DIR / "nvcc.log").write_text(nvcc_log)
    _build.library()

    # -- 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def ln_params(C):
        return 1 + rnd((C,), 0.1, f32), rnd((C,), 0.1, f32)

    # (kernel, shape label, calls per predict on the default route / on the
    #  K1 + K2 route, kernel fn, plain fn, GEMM FLOPs of one call)
    cases = []

    ws = 7
    for C, heads, res, calls, shift in ((128, 4, 56, (2, 2), 3), (256, 8, 28, (0, 2), 3),
                                        (512, 16, 14, (0, 18), 3), (1024, 32, 7, (0, 2), 0)):
        nW = (res // ws) ** 2
        table = rnd(((2 * ws - 1) ** 2, heads), 0.5, f32)
        args = (rnd((B, nW, ws * ws, C)), *ln_params(C), rnd((3 * C, C), C ** -0.5),
                rnd((3 * C,), 0.1), rnd((C, C), C ** -0.5), rnd((C,), 0.1),
                K1.build_bias_full(table, ws, res, res, shift), heads)
        M = B * nW * ws * ws
        cases.append(("fused_window_attention", f"xw({B},{nW},49,{C}) h{heads}", calls,
                      lambda a=args: K1.fused_window_attention_windows(*a),
                      lambda a=args: K1.window_attention_plain(*a),
                      attn_flops(M, ws * ws, C, M)))

    for M, C, Hd, calls in ((B * 3136, 128, 512, (2, 2)), (B * 784, 256, 1024, (0, 2)),
                            (B * 51, 1024, 4096, (5, 5))):
        args = (rnd((M, C)), *ln_params(C), rnd((Hd, C), C ** -0.5), rnd((Hd,), 0.1),
                rnd((C, Hd), Hd ** -0.5), rnd((C,), 0.1))
        cases.append(("fused_ln_mlp", f"x({M},{C}) hidden {Hd}", calls,
                      lambda a=args: K2.fused_ln_mlp_residual(*a),
                      lambda a=args: K2.ln_mlp_plain(*a), 4 * M * C * Hd))

    def key_mask(n):
        valid = torch.rand((B, n), generator=gen, device=dev) < 0.8
        valid[:, 0] = True
        return torch.where(valid, 0.0, -1e9).to(f32)

    alpha = torch.tensor(0.5, device=dev)
    # (label, calls per predict, C, heads, Nq, Nk, cross, mask, pos+alpha, ln_mode)
    for label, calls, C, heads, Nq, Nk, cross, masked, enh, mode in (
            ("bert", 12, 768, 12, 64, 64, False, True, False, "post"),
            ("txt_enh", 5, 1024, 8, 64, 64, False, True, True, "pre"),
            ("img_enh", 5, 1024, 8, 49, 49, False, False, True, "pre"),
            ("txt2img", 5, 1024, 8, 64, 49, True, False, False, "post"),
            ("img2txt", 5, 1024, 8, 49, 64, True, True, False, "post"),
            ("self", 5, 1024, 8, 51, 51, False, False, False, "pre")):
        w = []
        for _ in range(4):
            w += [rnd((C, C), C ** -0.5), rnd((C,), 0.1)]
        args = (rnd((B, Nq, C)), *ln_params(C), *w)
        kw = dict(kv=rnd((B, Nk, C)) if cross else None,
                  key_mask=key_mask(Nk) if masked else None,
                  pos=rnd((Nq, C), 0.5) if (enh or label == "self") else None,
                  alpha=alpha if enh else None, num_heads=heads, ln_mode=mode,
                  include_residual=not cross, residual_from_raw=enh)
        cases.append(("fused_attention", f"{label} ({B},{Nq}<-{Nk},{C}) h{heads} {mode}",
                      (calls, calls), lambda a=args, k=kw: K3.fused_attention(*a, **k),
                      lambda a=args, k=kw: K3.attention_plain(*a, **k),
                      attn_flops(B * Nq, Nk, C, B * Nk)))

    def swin_block(C, heads, res, shift):
        """12 block tensors (nn.Linear layout) and bias_full at one stage."""
        blk = (*ln_params(C), rnd((3 * C, C), C ** -0.5), rnd((3 * C,), 0.1),
               rnd((C, C), C ** -0.5), rnd((C,), 0.1), *ln_params(C),
               rnd((4 * C, C), C ** -0.5), rnd((4 * C,), 0.1),
               rnd((C, 4 * C), (4 * C) ** -0.5), rnd((C,), 0.1))
        table = rnd(((2 * ws - 1) ** 2, heads), 0.5, f32)
        return blk, K1.build_bias_full(table, ws, res, res, shift)

    def block_flops(M, C):
        return attn_flops(M, ws * ws, C, M) + 16 * M * C * C

    # stage 2: one pair per predict
    C, heads, res = 256, 8, 28
    blk0, bias0 = swin_block(C, heads, res, 0)
    blk1, bias1 = swin_block(C, heads, res, 3)
    x = rnd((B, res, res, C))
    pair_args = (x, blk0, bias0, blk1, bias1, heads, ws, 3)
    cases.append(("fused_swin_block_pair", f"map({B},{res},{res},{C}) h{heads}", (1, 0),
                  lambda a=pair_args: SP.fused_swin_block_pair(*a),
                  lambda a=pair_args: SP.pair_plain(*a), 2 * block_flops(B * res * res, C)))
    # stage 3: 18 chain steps, rolling into the shifted frame and back
    C, heads, res = 512, 16, 14
    for roll, shift in ((-3, 0), (3, 3)):
        blk, bias = swin_block(C, heads, res, shift)
        args = (rnd((B, res, res, C)), blk, bias, heads, ws, roll)
        cases.append(("fused_swin_block_chain", f"map({B},{res},{res},{C}) h{heads} "
                      f"roll {roll:+d}", (9, 0),
                      lambda a=args: SP.fused_swin_block_chain(*a),
                      lambda a=args: SP.chain_plain(*a), block_flops(B * res * res, C)))
    # stage 3 geometry on the raw flavor, which no route of the model calls
    args = (rnd((B, res, res, C)), *blk, bias, heads, ws)
    cases.append(("fused_swin_block_raw", f"map({B},{res},{res},{C}) h{heads}", (0, 0),
                  lambda a=args: SB.fused_swin_block_raw(*a),
                  lambda a=args: SB.raw_plain(*a[:-2], num_heads=a[-2], ws=a[-1]),
                  block_flops(B * res * res, C)))
    # stage 4: the window is the whole 7 x 7 map, so no shift and no roll
    C, heads = 1024, 32
    blk, bias = swin_block(C, heads, 7, 0)
    args = (rnd((B, 1, 49, C)), *blk, bias, heads)
    cases.append(("fused_swin_block_windows", f"xw({B},1,49,{C}) h{heads}", (2, 0),
                  lambda a=args: SB.fused_swin_block_windows(*a),
                  lambda a=args: SB.swin_block_plain(*a), block_flops(B * 49, C)))

    per_kernel = {}
    with torch.inference_mode():
        for name, label, (calls, calls_k1k2), kern, plain, flops in cases:
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name} {label}: non-finite output or wrong shape")
            diff = (got.float() - want.float()).abs()
            ref = want.float().abs()
            err = diff.max().item()
            rel = (diff / ref.clamp(min=1.0)).max().item()
            ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
            # each input read once and the output written once: the tensors
            # the wrapper is given (kern's default args) and the result
            nbytes = tensor_bytes(torch, kern.__defaults__) + tensor_bytes(torch, got)
            flop_ms, byte_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            log(f"kernel {name:24s} {label:36s} max_abs_err {err:.3e} max_rel_err "
                f"{rel:.3e} (tol {KERNEL_TOL:.3e})  kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  bound {max(flop_ms, byte_ms):.4f} ms "
                f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)  calls {calls} "
                f"(K1+K2 route {calls_k1k2})")
            if rel > KERNEL_TOL:
                fail(f"{name} {label}: max_rel_err {rel} > {KERNEL_TOL}")
            agg = per_kernel.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                                   bound_ms=0.0, flop_ms=0.0, byte_ms=0.0))
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            # per predict on the default route; a kernel that route does not
            # call (raw) is recorded per call
            n = calls if EXPECTED["whole"][name] else 1
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("flop_ms", flop_ms),
                             ("byte_ms", byte_ms), ("bound_ms", max(flop_ms, byte_ms))):
                agg[key] += n * val
    del cases, pair_args, args, x, blk, bias, blk0, bias0, blk1, bias1

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

    counters = {"fused_window_attention": K1.fused_window_attention_windows,
                "fused_ln_mlp": K2.fused_ln_mlp_residual,
                "fused_attention": K3.fused_attention,
                "fused_swin_block_windows": SB.fused_swin_block_windows,
                "fused_swin_block_raw": SB.fused_swin_block_raw,
                "fused_swin_block_chain": SP.fused_swin_block_chain,
                "fused_swin_block_pair": SP.fused_swin_block_pair}
    preds, launches = {}, {}
    for route, m in routes.items():
        predictor = MMRPredictor(m, labels, retriever=engine, threshold=0.5)
        for fn in counters.values():
            fn.launches = 0
        preds[route] = predictor.predict(images, ids, mask, K=10)
        torch.cuda.synchronize()
        launches[route] = {name: fn.launches for name, fn in counters.items()}
        log(f"launches in one predict (batch {B}), {route} route: {launches[route]}")
        if launches[route] != EXPECTED[route]:
            fail(f"{route} route: launch counts {launches[route]}, expected {EXPECTED[route]}")

        pred = preds[route]
        probs, joint = pred["probs"], pred["joint_emb"]
        if probs.shape != (B, cfg.num_classes) or joint.shape != (B, cfg.joint_dim):
            fail(f"{route} route: output shapes {probs.shape} {joint.shape}")
        if not (np.isfinite(probs).all() and np.isfinite(joint).all()):
            fail(f"{route} route: non-finite outputs")
        top1 = [hits[0][0] for hits in pred["retrieval"]]
        log(f"{route} route: top-1 ids {top1}")
        if top1 != [f"req{b}" for b in range(B)]:
            fail(f"{route} route: a request's own id is not at rank 1")

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
    del ref

    # throughput of both routes and retrieval latency, for information
    for batch in (8, 64):
        img_d = torch.rand((batch, 224, 224, 3), generator=gen, device=dev)
        ids_d = torch.randint(0, cfg.text.vocab_size, (batch, 64), generator=gen, device=dev)
        mask_d = torch.ones((batch, 64), dtype=torch.int64, device=dev)
        for route, m in routes.items():
            fwd = serving_forward(m)
            ms = cuda_ms(torch, lambda: fwd(img_d, ids_d, mask_d), reps=10, warmup=2)
            log(f"embed batch {batch}, {route} route: {ms:.2f} ms per forward, "
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

    # -- 5. records ------------------------------------------------------------
    # ms / plain_ms / bound_ms: summed over the calls of one predict on the
    # default route at the shapes above ("per": "predict"), or one call for a
    # kernel that route does not call. No single PyTorch call computes any of
    # these functions (LN + projections + attention [+ MLP] in one), so
    # library_ms is null.
    records = []
    for name, (src, rep) in SOURCES.items():
        agg = per_kernel[name]
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["whole"][name], "max_abs_err": agg["max_abs_err"],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": "operations" if agg["flop_ms"] >= agg["byte_ms"] else "bytes",
            "library_ms": None,
            "per": "predict" if EXPECTED["whole"][name] else "call",
            "launches_k1k2_route": launches["k1k2"][name]})
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
