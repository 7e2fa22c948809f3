#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmrp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which fails the run (nonzero exit, no result line):
1. environment: the card's name and power limit, CUDA and nvcc versions;
2. build: the kernels from mmrp_tpu_torch/csrc with nvcc and, beside them,
   the native DICOM decoder (mmrp_tpu_torch/csrc/host/mmrp_io.cpp) with g++
   (``python -m mmrp_tpu_torch.data.native``), timed; every later DICOM
   decode (phases 4c, 8 and 9) takes the native path, as JAX's does where
   its library is built;
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
3b. K3's packed form (``fused_attention_packed``) at the stream's lengths:
   a batch of 64 reports drawn as the benchmark's stream draws them (the
   longest of 1,024, 234 tokens, among them), padded to 512, in each of the
   four forms the packed text route runs (BERT's post-LN self-attention at C
   768, the text enhancer's pre-LN with pos and alpha at C 1024, packed
   queries against 49 patches, 49 queries against packed keys), each against
   its plain version (``attention_plain_packed``) on the same card tensors
   within the kernels' bound and against the padded form's valid rows, with
   its launches counted (``launches_packed``, reset just before), its time
   beside a bound worked out from the T packed rows and the padded form's
   time at 512; then the flagship's ``StreamingPipeline`` over 3 such batches:
   27 packed K3 launches of 37 a batch, ``text.packed`` on every batch, no
   host read, and each batch's results within bf16 rounding of the padded
   route's. ``python3 chip_smoke.py --packed-only`` runs phases 1, 2 and 3b
   alone and prints no result line;
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
4c. serve from a run directory: a run directory written from the flagship's
   weights (``state_dict_to_flax_flat`` -> ``save_param_tree``), with a
   100,008-row gallery that holds the requests' embeddings, labels, KG node
   embeddings, thresholds and 8 16-bit DICOM files of 2048 x 2048;
   ``MMRPredictor.from_run_dir`` on it, then ``predict`` on the DICOM files
   (the run's preprocessor and tokenizer, 512 tokens) with the reranker:
   launch counts, no plain call, probs and joint_emb bit-identical to the
   in-process predictor, the reranked lists equal to the port's ``Reranker``
   applied by hand. ``preprocess_batch`` on the card against the CPU at
   (8, 2048, 2048) -> 224 (max |d| <= 1e-4, timed). ``StreamingPipeline`` at
   batch 64 and 512 tokens, 4 batches, the last with 10 padded rows, in the
   uint16 + window, uint8 and f32 forms: the valid rows, joint_emb cosine
   >= 0.9999 between each compact form and the f32 form of its pixels, every
   request's own id at rank 1; stream pairs/s at depth 1 and 2 (16 batches,
   3 rounds) for information. The run directory also holds a seeded
   ``label_attention.npz``: the reranker pools label-node vectors with it on
   the card, held to the npz's function in numpy.
4d. explain and the demo: (1) each bf16 serving kernel (K1, K2, K3 and the
   four whole-block flavors) on its gradient route at the flagship shapes of
   one predict at L512, batch 1: the kernel forward within its bound, every
   input gradient bit-equal to the all-plain route's, one launch per call, no
   plain call; (2) ``predict(explain=True)`` from the run directory at batch
   1, L512, with its 5 auto targets and 50 IG steps, its launches counted
   (``launches_by_path["explain"]``), then the engine (attention maps, patch
   IG and Grad-CAM per target, ``explain_batch`` over 5 requests,
   ``token_attribution``, ``integrated_gradients_pixels``) against the same
   weights in f32 on the CPU by ``compare_maps`` (EXPLAIN_* bounds); (3)
   their times on the card; (4) the HTTP demo (``serve/app.py``) on
   127.0.0.1 over ``build_demo_context`` of the run: ``GET /health`` and
   ``POST /api/predict`` with one 16-bit DICOM and ``detail``.
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
8. train a run directory: a seeded OpenI-format tree (records_cache.json,
   splits, 320 records with reports of 40-700 words, 16-bit DICOM files of
   512^2), ``train/runner.py::run_training_pipeline(flagship=True)`` at batch
   64 and 512 tokens, one epoch per stage (Swin finetune, KG embeddings,
   LabelAttention, joint with validation, checkpoints, gallery dumps, GT and
   the dual-gallery eval), then ``cfg.resume`` on the same directory to 2
   joint epochs (it must restore epoch 0's state bit for bit and continue at
   epoch 1), then ``MMRPredictor.from_run_dir`` on the card: 8 train records
   each at rank 1 of its own gallery row, probs bit-identical to the
   in-process model's ``serving_forward``; then a ``KGTrainer`` run at the
   size of a hybrid OpenI + DOID + RadLex graph (50,000 entities, 12
   relations, 200,000 seeded triples; TransE dim 300, neg 32, batch 1024, bf16
   scoring; one epoch and a filtered evaluation of its val split), whose loss
   must fall. Every finetune and joint step must launch 22 C-F and 22 C-B and
   no serving kernel, every joint validation batch, Swin finetune validation
   batch and gallery dump batch its route's serving launches, the launches
   over both runs the sum over those calls, no call a plain route; every
   loss finite; every artifact of
   JAX's runner present; ``pipeline_summary.json`` holding ``joint.composite``
   and ``retrieval.{generalization,historical}.{P@10,mAP,MRR,nDCG@10}`` in
   [0, 1]. Each stage's seconds, step times, train pairs/s, the KG times and
   peak device memory are printed for information, beside the card's name
   and power limit. ``python3 chip_smoke.py --pipeline-only`` runs phases 1,
   2 and 8 alone and prints no result line.
9. the Quick start through the cli: the native decoder against the Python
   path (``DICOMImagePreprocessor.load`` of 8 16-bit DICOM files of 2048^2:
   max |native - Python| <= 0.02, ``decode_raw`` exact, images/s of both and
   of the batch pool); an OpenI-layout tree (320 XML reports built from the
   taxonomy's phrases, some negated, with MeSH terms, and 16-bit DICOM files
   of 512^2); then ``mmrp_tpu_torch.cli.main`` for ``data`` (records, splits,
   EDA JSONs, the label prevalence), ``train --config`` (the shipped
   configs/config.yaml cut to one epoch per stage with
   ``train_use_pallas_attention``: Swin-B 224 px, the small text tower, 5
   fusion layers at 1024, batch 64, L512, CompGCN; no plain call site, every
   finetune / joint step 22 C-F + 22 C-B, every validation and dump batch its
   route's launches, the launches the sum over those calls), ``calibrate -n
   64`` (one block per Swin block, no launch), ``parity --explain-n 2`` (every
   section; every embed on the default route's launches), ``stream`` (its
   batches' launches), ``eval-cls``, ``eval-ret --variants --run-dir``,
   ``kg-probe`` and ``mapper`` (exit 0, their artifacts), ``export-serving
   --batches 1,8`` (``python -m mmrp_tpu_torch.cli`` in a process of its own:
   exit 0, JAX's JSON keys) and ``bench`` (exit 2); each subcommand's seconds. Then DLS
   (``make_retrieval_engine("dls")``) over phase 4c's 100,008 x 1024 gallery
   at the engine's default link threshold and as a 10-NN graph: the build
   seconds, the links of the first 1,024 rows and of the 8 request rows
   against a CPU f32 recomputation (equal wherever adjacent similarities
   differ by more than 1e-5; each row's number of links where its
   similarities cross the threshold, within 1e-5; for each graph, some
   links and some row ends compared), and recall@10 of 8 walks against
   exact top-10. ``python3 chip_smoke.py
   --cli-only`` runs phases 1, 2 and 9 alone (on a seeded gallery of that
   size) and prints no result line.
10. the pretrained bootstrap and the other towers, on phase 8's tree: (a)
   checkpoints in the published layouts at the published dims, from a seeded
   generator (no ``transformers`` on the card): a ``BertForPreTraining``
   ``pytorch_model.bin`` (``bert.`` keys and a ``cls.`` head) at
   Bio_ClinicalBERT's dims (vocab 28,996, 12 x 768, 12 heads, FFN 3,072, 512
   positions, 2 token types), a ``SwinModel`` ``model.safetensors`` at
   swin-base-patch4-window7-224's layout (embed 128, depths 2/2/18/2, heads
   4/8/16/32; written by this script's own safetensors writer, int64
   ``relative_position_index`` buffers included), MedCLIP's vision dict
   (Swin-T ``vision_model.model.*`` + a 512 x 768 projection) and a
   ``vocab.txt`` of 28,996 lines; (b) ``models/port.py``'s reader returns the
   tensors written, ``text_config_from_state`` / ``swin_layout_from_state``
   those dims, and each converted tower loaded into the port's module on the
   card equals the converter's tensors bit for bit at the module's dtypes; (c)
   ``run_training_pipeline(flagship=True)`` with ``pretrained_vocab``,
   ``pretrained_bert`` and ``pretrained_swin`` (batch 64, L512, one epoch per
   stage): the finetune's first step starts from the converted Swin, the
   joint's from the converted BERT and the finetuned Swin (f32 masters, bit
   for bit), ``model_config.json`` holds the checkpoint's text dims, the
   launches as phase 8's (``RunnerCalls``; no plain call), and
   ``from_run_dir`` serves each of 8 train records at rank 1 of its own row;
   (d, e) one serving forward at batch 8, L512 of the flagship's widths
   (ClinicalBERT-dim text, 5 fusion layers at 1024, 43 labels) with each of
   the medclip, vit, resnet50 and efficientnet towers from ``init_params``,
   and of the Swin-B flagship with ``use_shared_ffn`` and with
   ``use_cls_only``: launches and plain calls as worked out
   (``EXPECTED_TOWER``; the shared FFN's 5 self-attentions and FFNs on their
   plain versions, as JAX's XLA branch), pairs/s, and agreement with the f32
   plain path on the CPU (joint_emb cosine >= 0.9999, max |dprobs| <= 5e-3; a
   conv or ViT tower that misses it is held to twice the distance of its
   all-plain bf16 forward). ``python3 chip_smoke.py --pretrained-only`` runs
   phases 1, 2 and 10 alone (on a tree of its own) and prints no result line.
11. the serving artifact and explain over the int8 mixes (run after 4d, on
   4c's run directory and phase 4's requests at L512): (a) the run exported
   for cuda (``serve/exported.py``) at buckets 1, 8 and 32, seconds per
   bucket and bytes; the artifact loaded in a fresh process (load seconds,
   ``memory_allocated``, no ``mmrp_tpu_torch.models`` module imported) and
   called at n = 1, 3, 8, 9, 32 and 40 (4c's 8 requests cycled): per row the
   bf16 gate against the f32 plain path, the largest difference from the live
   ``serving_forward`` on the same rows padded to the same buckets, the
   launches per call those of a live predict with no plain call, and the
   CUDA-event time per call at batch 8 and 32 beside the live forward's; (b)
   the same at bucket 8 for ``int8_static`` (4b's calibration: its launches,
   cosine > 0.995 against the f32 unquantized plain path); (d)
   ``predict(explain=True)`` at batch 1, L512, 5 targets, 50 IG steps over
   ``serve_quant="int8"`` and ``"int8_static"`` (launches, host clock), the
   maps of 2 targets, token IG and pixel IG against the same mix in f32 on
   the CPU (``compare_maps``: Pearson >= 0.99 and IoU@20% >= 0.8, or no more
   than twice as far as the farthest map of its kind of the plain versions
   in bf16 on the card; the attention maps for information), pixel IG over
   ``int8_static`` raising;
   then the W8A8 gradient routes of K3 (BERT at L512), the dynamic windows
   (Swin-B stages 2-4) and raw (stage 3) blocks at batch 8: the int8
   forward within 2^-4 of its plain version, every input gradient bit-equal
   to the unquantized plain route's, one launch each; and the host time of
   one K3 call through ``torch.ops.mmrp`` and directly. (c) is phase 9's
   ``export-serving``. (e) one artifact exported from the card's model with
   ``platforms=("cuda", "cpu")`` at bucket 1, loaded once per platform: each
   program against the live forward on its device (the cpu one on the card's
   bf16 weights copied to the CPU) and the f32 plain path under the bf16
   gates, the cuda program with a live predict's launches.
   ``python3 chip_smoke.py --export-only`` runs phases 1, 2 and 11 alone (its
   inputs made as phases 4-4c make them) and prints no result line.
12. the mesh on one card (``parallel/``, after phase 10): (a)
   ``initialize_distributed`` at world 1 over NCCL on a free port and
   ``build_mesh(("dp",))``; (b) ``make_train_step_dp`` on the flagship at
   batch 64, L64, from phase 7's construction, in turns with
   ``make_train_step`` on a second model from the same seed, under
   deterministic algorithms: every step's loss and every master after the
   last bit-equal (both collectives are identities at world 1), C-F 22 and
   C-B 22 launches a step, no plain core call, the step times beside
   phase 7's median; (c) ``RetrievalEngine(mesh=)`` over a seeded 100,008 x
   1024 gallery: ids and scores equal to the single engine's for 8 requests,
   top-10 p50 of each; (d) ``evaluate_sharded`` on phase 8's 50,000-entity
   graph equal to ``KGTrainer.evaluate``; (e) ``StreamingPipeline(mesh=)``
   with the sharded engine at batch 64, L512 over 4 batches (uint8 ingest,
   10 padded rows): every row equal to the stream without a mesh, a
   predict's launches a batch; (f) a world-1 data-parallel artifact at
   bucket 8 (key ``cuda::8::1``) loaded with the mesh: outputs equal to the
   single-device artifact's; (g) ``dryrun_multichip(4)`` over gloo on the
   machine's CPU. ``python3 chip_smoke.py --mesh-only`` runs phases 1, 2 and
   12 alone and prints no result line.
Each phase prints its seconds. The last two lines are the kernels' JSON record
and the result line {"ok": true, "device": {...}}.
"""

import base64
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
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
# serving from a run directory: the default route at 512 tokens
EXPECTED["run_dir"] = EXPECTED["whole"]
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
# kernel -> (wrapper module of mmrp_tpu_torch.ops, the wrapper, the wrapper's
# count of that kernel's launches)
COUNTERS = {
    "fused_window_attention": ("fused_window_attention", "fused_window_attention_windows",
                               "launches"),
    "fused_ln_mlp": ("fused_mlp", "fused_ln_mlp_residual", "launches"),
    "fused_attention": ("fused_attention", "fused_attention", "launches"),
    "fused_attention_int8": ("fused_attention", "fused_attention", "launches_int8"),
    **{f"fused_swin_block_{flavor}{suffix}": (
        "fused_swin_block" if flavor in ("windows", "raw") else "fused_swin_pair",
        f"fused_swin_block_{flavor}", "launches" + suffix)
       for flavor, suffixes in (("windows", ("", "_static", "_per_row", "_dynamic")),
                                ("raw", ("", "_dynamic")), ("chain", ("", "_static", "_per_row")),
                                ("pair", ("", "_static", "_per_row")))
       for suffix in suffixes},
}
assert set(COUNTERS) == set(SERVING)


def serving_counters() -> dict:
    """kernel -> (its wrapper, the name of the wrapper's count of its launches)."""
    import importlib

    return {name: (getattr(importlib.import_module(f"mmrp_tpu_torch.ops.{mod}"), fn), attr)
            for name, (mod, fn, attr) in COUNTERS.items()}


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
# serving from a run directory: 8 requests as 16-bit DICOM files of 2048^2
# and reports of up to 512 tokens (the JAX serving default); the stream at
# batch 64, 4 batches, the last with 10 padded rows (timed over those 4
# batches 4 times in a row, at depth 1 and 2 in turn). Preprocessing on the
# card against the CPU: both f32, with the same antialiased resize in other
# summation orders (tests/test_torch_data.py holds the CPU's within 1e-4 of
# JAX's)
DICOM_HW = 2048
RUN_TEXT_LEN = 512
# explain on the default route at L512 (phase 4d): the main path's request
# runs predict(explain=True) with the default 50 IG steps; the card is held
# to the f32 CPU path at 10 steps (fewer for token IG and pixel IG) by
# compare_maps: attention maps Pearson >= 0.999 (or ATTN_BF16_FACTOR); IG,
# Grad-CAM, token IG and pixel IG Pearson >= 0.99 and IoU of the top 20% >= 0.8
EXPLAIN_STEPS, EXPLAIN_CMP_STEPS = 50, 10
ATTN_PEARSON_MIN = 0.999
# the attention maps' spatial spread is of the order of bf16's rounding of
# the scores (measured on an H100: Pearson 0.90-0.997 against f32 for 6
# requests): where the plain versions in bf16 on the CPU are further than
# ATTN_PEARSON_MIN from f32, the card may be at most twice as far
ATTN_BF16_FACTOR = 2.0
MAP_PEARSON_MIN, MAP_IOU_MIN = 0.99, 0.8
# the run's LabelAttention pooler (hidden width of the JAX trainer's default)
# on the card in f32 against its function in numpy f64
LA_HIDDEN = 256
POOL_TOL = 1e-5
STREAM_B, STREAM_BATCHES, STREAM_PAD = 64, 4, 10
STREAM_TIMED_REPEATS, STREAM_TIMED_ROUNDS = 4, 3
PREPROCESS_TOL = 1e-4


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


# substrings of the names of the port's CUDA kernels (csrc/)
PORT_KERNELS = ("window_attn_wgmma", "k1_proj_wgmma", "block_mlp_kernel", "ln_mlp_kernel",
                "qkv_kernel", "attn_kernel", "out_kernel", "core_fwd_ring", "core_bwd_ring",
                "heads_kernel")
# a K1 or whole-block call's launches, timed apart by the profiler: kind ->
# (short name of the record's keys, a substring of the CUDA kernel's name)
LAUNCH_KINDS = {"attention": ("attn", "window_attn_wgmma"),
                "projection": ("proj", "k1_proj_wgmma"), "mlp": ("mlp", "block_mlp")}


def attn_flops(M: int, Nk: int, C: int, kv_rows: int) -> int:
    """q and out projections over M query rows, k and v over kv_rows key
    rows, and q k^T plus p v (4 M Nk C over all heads)."""
    return 4 * M * C * C + 4 * kv_rows * C * C + 4 * M * Nk * C


def explain_expected(steps: int, chunk: int, targets: int, layers: int = 5) -> dict:
    """Launches of one predict(explain=True) at batch 1 on the default route:
    the predict's forward; the attention maps' forward (the backbones, and per
    fusion layer its two enhancers on K3, the rest on the JAX XLA branch that
    returns the weights); per target a probe forward and steps / chunk IG
    chunks (integrated_gradients), and a probe forward and one head pass
    (Grad-CAM). A head pass: per fusion layer 5 K3 and 1 K2."""
    fwd = EXPECTED["whole"]
    attn = dict(fwd, fused_ln_mlp=fwd["fused_ln_mlp"] - layers,
                fused_attention=fwd["fused_attention"] - 3 * layers)
    head = dict(ZERO, fused_attention=5 * layers, fused_ln_mlp=layers)
    return {k: fwd[k] + attn[k] + targets * (2 * fwd[k] + (steps // chunk + 1) * head[k])
            for k in ZERO}


# phase 8, train a run directory: a seeded OpenI-format tree of 320 records
# (train 256, val 32, test 32), reports of 40-700 words, 16-bit DICOM files of
# PIPE_DICOM_HW^2 (a cut: the OpenI originals are about 2048^2; 512^2 keeps
# the host decode of ~1,500 images inside the run), then
# run_training_pipeline(flagship=True) at batch 64, text length 512, one
# epoch per stage, and the resume to 2 joint epochs. The train-time model takes
# train_use_pallas_attention=True, so its validation and dump forwards run the
# serving kernels with no plain call site
PIPE_RECORDS = {"train": 256, "val": 32, "test": 32}
PIPE_DICOM_HW = 512
PIPE_B, PIPE_TEXT = 64, 512
PIPE_SERVE = 8  # train records served back through from_run_dir
# the KG run at the size of a hybrid OpenI + DOID + RadLex graph
KG_ENTITIES, KG_RELATIONS, KG_TRIPLES = 50_000, 12, 200_000
KG_DIM, KG_NEG, KG_BATCH = 300, 32, 1024
# per training step of the flagship or the cli's model (finetune or joint):
# the core at Swin stages 1-3, no serving kernel
EXPECTED_PIPE_STEP = {"wattn_core_fwd": 22, "wattn_core_bwd": 22}


def pipe_expected(text_layers: int):
    """Launches of one joint validation batch (make_eval_step with the
    attention weights: the fusion layers take JAX's unfused branch, so K3
    runs in the text tower's layers and the 5 fusion layers' self and cross
    attention, and K2 in Swin alone), one Swin finetune validation batch (the
    vision tower alone) and one gallery dump batch (the default serving
    route) of a Swin-B model whose text tower has ``text_layers`` layers."""
    swin = {"fused_window_attention": 2, "fused_swin_block_windows": 2,
            "fused_swin_block_chain": 18, "fused_swin_block_pair": 1}
    return ({**swin, "fused_ln_mlp": 2, "fused_attention": text_layers + 10},
            {**swin, "fused_ln_mlp": 2},
            {**swin, "fused_ln_mlp": 7, "fused_attention": text_layers + 25})


# the files JAX's runner writes (its orbax checkpoints' insides aside;
# tests/test_torch_pipeline.py holds the port's list to a JAX run's), and the
# npz the port serves from
PIPE_ARTIFACTS = (
    "config.yaml", "vocab.txt", "model_config.json", "metrics.jsonl", "run_config.json",
    "swin/swin_backbone.npz", "swin/thresholds.npy", "swin/best_swin_finetune_metrics.json",
    "kg/triples.csv", "kg/node2id.json", "kg/relation2id.json", "kg/entity_meta.json",
    "kg/node_embeddings.npy", "kg/rel_embeddings.npy", "kg/embeddings_meta.json",
    "label_attention.npz", "best_label_attention_metrics.json",
    "joint/val_embeddings.npy", "joint/val_attention.npy", "joint/val_ids.json",
    "joint/thresholds.npy", "joint/val_per_class.json", "joint/best_multimodal_metrics.json",
    "joint/ckpt/best_metrics.json", "joint/params.npz",
    "test_embeddings.npy", "test_ids.json", "train_embeddings.npy", "train_ids.json",
    "retrieval_eval/retrieval_results.json", "retrieval_eval/retrieval_results.txt",
    "pipeline_summary.json")
PIPE_WORDS = ("the heart size is normal mild cardiomegaly no focal consolidation pleural "
              "effusion pneumothorax lungs are clear atelectasis left base right lower lobe "
              "opacity degenerative change thoracic spine stable emphysema hyperinflation "
              "granuloma calcified nodule mediastinal contours within normal limits").split()


class RunnerCalls:
    """The training runner instrumented for phases 8 and 9 (a context manager:
    the runner's step and eval makers, its stages and checkpoint writes are
    wrapped on entry and restored on exit; the runner has no hooks). Records
    the launches of every finetune / joint step, Swin finetune validation
    batch, joint validation batch and gallery dump batch (``per_call``: kind
    -> [(launches, CUDA-event ms or None)]; the second call of each kind runs
    under the profiler, whose device ms by kernel go to ``device``), the
    losses, each stage's seconds, and every joint model (``kept``); a
    function put in ``first_step["check"]`` is called with the model and the
    state of a joint stage's first step, one in ``first_step["finetune"]``
    with the model and the f32 masters of a Swin finetune's first step, and
    ``resumed["epoch"]`` is the epoch of the full train state a checkpoint
    restore returned."""

    KINDS = ("finetune_step", "finetune_val_batch", "joint_step", "eval_batch", "dump_batch")

    def __init__(self, torch, where: str):
        from mmrp_tpu_torch.eval import retrieval_eval
        from mmrp_tpu_torch.kg import trainer as kg_trainer
        from mmrp_tpu_torch.ops import fused_attention as K3
        from mmrp_tpu_torch.ops import fused_mlp as K2
        from mmrp_tpu_torch.ops import fused_swin_block as SB
        from mmrp_tpu_torch.ops import fused_swin_pair as SP
        from mmrp_tpu_torch.ops import fused_window_attention as K1
        from mmrp_tpu_torch.ops import wattn_core as WC
        from mmrp_tpu_torch.train import pipeline as tpipe
        from mmrp_tpu_torch.train import runner as trunner
        from mmrp_tpu_torch.train import swin_finetune as tft
        from mmrp_tpu_torch.utils.checkpoint import CheckpointManager

        self.torch, self.where = torch, where
        self.counters = {
            "fused_window_attention": (K1.fused_window_attention_windows, "launches"),
            "fused_ln_mlp": (K2.fused_ln_mlp_residual, "launches"),
            "fused_attention": (K3.fused_attention, "launches"),
            "fused_swin_block_windows": (SB.fused_swin_block_windows, "launches"),
            "fused_swin_block_chain": (SP.fused_swin_block_chain, "launches"),
            "fused_swin_block_pair": (SP.fused_swin_block_pair, "launches"),
            "wattn_core_fwd": (WC.core_forward, "launches"),
            "wattn_core_bwd": (WC.core_backward, "launches"),
        }
        self.plain = (K1.fused_window_attention_windows, K2.fused_ln_mlp_residual,
                      K3.fused_attention, SB.fused_swin_block_windows, SB.fused_swin_block_raw,
                      SP.fused_swin_block_chain, SP.fused_swin_block_pair,
                      WC.window_attention_core)
        self.per_call = {kind: [] for kind in self.KINDS}
        self.losses = {"finetune": [], "joint": []}
        self.stage_s, self.device, self.first_step, self.resumed = {}, {}, {}, {}
        self.kept = []
        self.mods = (tft, tpipe, trunner, kg_trainer, retrieval_eval, CheckpointManager)
        self.real = {"ft": tft.make_finetune_step, "ft_loop": tft.finetune,
                     "train": tpipe.make_train_step, "restore": CheckpointManager.restore,
                     "eval": tpipe.make_eval_step, "joint": tpipe.run_joint_training,
                     "dump": tpipe.dump_embeddings, "swin": trunner._run_swin_finetune_stage,
                     "la": trunner._run_label_attention_stage, "kg": kg_trainer.KGTrainer.train,
                     "ret": retrieval_eval.dual_gallery_eval, "save": CheckpointManager.save,
                     "best": CheckpointManager.update_best}

    def reset(self):
        for fn, attr in self.counters.values():
            setattr(fn, attr, 0)
        for fn in self.plain:
            fn.plain_calls = 0

    def read(self):
        bad = {fn.__name__: fn.plain_calls for fn in self.plain if fn.plain_calls}
        if bad:
            fail(f"{self.where}: calls on a plain route: {bad}")
        return {name: getattr(fn, attr) for name, (fn, attr) in self.counters.items()}

    @staticmethod
    def diff(after, before):
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def timed_call(self, kind, fn, *args):
        torch = self.torch
        before = self.read()
        if len(self.per_call[kind]) == 1:  # the second call runs under the profiler, untimed
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args)
                torch.cuda.synchronize()
            by = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    us = getattr(e, "device_time_total", None) or getattr(
                        e, "cuda_time_total", 0.0)
                    name = next((k for k in PORT_KERNELS if k in e.key), "other")
                    by[name] = by.get(name, 0.0) + us / 1e3
            self.device[kind] = {k: round(v, 3) for k, v in sorted(by.items())}
            self.per_call[kind].append((self.diff(self.read(), before), None))
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        self.per_call[kind].append((self.diff(self.read(), before), start.elapsed_time(end)))
        return out

    def __enter__(self):
        tft, tpipe, trunner, kg_trainer, retrieval_eval, CheckpointManager = self.mods
        real, per_call, losses = self.real, self.per_call, self.losses

        def ft_step(model, c, tx):
            step = real["ft"](model, c, tx)
            check = self.first_step.pop("finetune", None)

            def run(*a):
                nonlocal check
                if check is not None:  # a[0]: the f32 masters before the update
                    check(model, a[0])
                    check = None
                params, opt, loss = self.timed_call("finetune_step", step, *a)
                losses["finetune"].append(loss)
                return params, opt, loss
            return run

        def ft_loop(model, c, train_batches, val_batches, *a, **kw):
            # the finetune's validation forwards: each batch's launches are those
            # made between its yield and the loop's next request
            def counted():
                for batch in val_batches():
                    before = self.read()
                    yield batch
                    per_call["finetune_val_batch"].append((self.diff(self.read(), before), None))
            return real["ft_loop"](model, c, train_batches, counted, *a, **kw)

        def joint_step(model, c, pw=None):
            step = real["train"](model, c, pw)
            check = self.first_step.pop("check", None)
            self.kept.append(model)

            def run(state, batch):
                nonlocal check
                if check is not None:
                    check(model, state)
                    check = None
                state, m = self.timed_call("joint_step", step, state, batch)
                losses["joint"].append(m["loss/total"])
                return state, m
            return run

        def restore(mgr, *a, **kw):
            r = real["restore"](mgr, *a, **kw)
            if "epoch" in r:  # a full train state
                self.resumed["epoch"] = int(r["epoch"])
            return r

        def eval_step(model, return_attention=False):
            step = real["eval"](model, return_attention)
            kind = "eval_batch" if return_attention else "dump_batch"
            return lambda batch: self.timed_call(kind, step, batch)

        def stage(name, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                self.torch.cuda.synchronize()
                self.stage_s[name] = self.stage_s.get(name, 0.0) + time.perf_counter() - t
                return out
            return run

        tft.make_finetune_step, tft.finetune = ft_step, ft_loop
        CheckpointManager.restore = restore
        tpipe.make_train_step, tpipe.make_eval_step = joint_step, eval_step
        trunner._run_swin_finetune_stage = stage("swin finetune", real["swin"])
        trunner._run_label_attention_stage = stage("label attention", real["la"])
        kg_trainer.KGTrainer.train = stage("kg embeddings", real["kg"])
        tpipe.run_joint_training = stage("joint", real["joint"])
        tpipe.dump_embeddings = stage("dumps", real["dump"])
        retrieval_eval.dual_gallery_eval = stage("retrieval eval", real["ret"])
        # inside the joint stage: the checkpoints' writes
        CheckpointManager.save = stage("joint checkpoints", real["save"])
        CheckpointManager.update_best = stage("joint checkpoints", real["best"])
        return self

    def __exit__(self, *exc):
        tft, tpipe, trunner, kg_trainer, retrieval_eval, CheckpointManager = self.mods
        real = self.real
        tft.make_finetune_step, tft.finetune = real["ft"], real["ft_loop"]
        CheckpointManager.restore = real["restore"]
        tpipe.make_train_step, tpipe.make_eval_step = real["train"], real["eval"]
        tpipe.run_joint_training, tpipe.dump_embeddings = real["joint"], real["dump"]
        trunner._run_swin_finetune_stage = real["swin"]
        trunner._run_label_attention_stage = real["la"]
        kg_trainer.KGTrainer.train = real["kg"]
        retrieval_eval.dual_gallery_eval = real["ret"]
        CheckpointManager.save, CheckpointManager.update_best = real["save"], real["best"]
        return False

    def check(self, total, text_layers: int) -> None:
        """Every step launched 22 C-F + 22 C-B and no serving kernel, every
        validation and dump batch its route's serving launches
        (:func:`pipe_expected`), and ``total`` (the counts read once after
        the runs, set to 0 before them) is the sum over these calls."""
        per_call = self.per_call
        for kind in ("finetune_step", "joint_step"):
            if not per_call[kind]:
                fail(f"{self.where}: no {kind}")
            for i, (counts, _) in enumerate(per_call[kind]):
                if counts != EXPECTED_PIPE_STEP:
                    fail(f"{self.where}: {kind} {i}: launches {counts}, expected "
                         f"{EXPECTED_PIPE_STEP}")
        ev, ft_ev, dump = pipe_expected(text_layers)
        for kind, want in (("finetune_val_batch", ft_ev), ("eval_batch", ev),
                           ("dump_batch", dump)):
            if not per_call[kind]:
                fail(f"{self.where}: no {kind}")
            for i, (counts, _) in enumerate(per_call[kind]):
                if counts != want:
                    fail(f"{self.where}: {kind} {i}: launches {counts}, expected {want}")
        summed = {k: sum(c.get(k, 0) for calls in per_call.values() for c, _ in calls)
                  for k in total}
        if summed != total:
            fail(f"{self.where}: launches over the runs {total} != the sum over the calls "
                 f"{summed}")
        all_losses = self.losses["finetune"] + self.losses["joint"]
        if not all_losses or not all(math.isfinite(v) for v in all_losses):
            fail(f"{self.where}: non-finite or no losses {all_losses}")

    def median_ms(self, kind):
        return statistics.median(ms for _, ms in self.per_call[kind] if ms is not None)


def write_pipe_tree(root: Path) -> list:
    """Phase 8's seeded OpenI-format tree under ``root`` (records_cache.json,
    splits, PIPE_RECORDS records with 16-bit DICOM files): its records."""
    import numpy as np

    from mmrp_tpu_torch.data.dicom import write_dicom
    from mmrp_tpu_torch.labels import LABEL_COLS

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 8)
    (root / "dcm").mkdir(parents=True)
    (root / "splits").mkdir()
    records, split_ids = [], {}
    for split, n in PIPE_RECORDS.items():
        split_ids[split] = []
        for i in range(n):
            rid = f"{split}{i}"
            hw = PIPE_DICOM_HW
            pixels = (rng.random((hw, hw)) * 3000 + 500).astype(np.uint16)
            path = root / "dcm" / f"{rid}.dcm"
            write_dicom(path, pixels, window_center=2000, window_width=3000)
            words = rng.choice(PIPE_WORDS, int(rng.integers(40, 701)))
            labels = (rng.random(len(LABEL_COLS)) < 0.12).astype(int).tolist()
            records.append({"id": rid, "report_text": " ".join(words) + ".", "labels": labels,
                            "dicom_path": str(path)})
            split_ids[split].append(rid)
    (root / "records_cache.json").write_text(json.dumps({"records": records}))
    for split, ids_ in split_ids.items():
        (root / "splits" / f"{split}_ids.json").write_text(json.dumps(ids_))
    log(f"train a run directory: {len(records)} records "
        f"({', '.join(f'{k} {v}' for k, v in PIPE_RECORDS.items())}), reports of 40-700 "
        f"words, 16-bit DICOM {PIPE_DICOM_HW}^2 (cut from ~2048^2 for host decode), written "
        f"in {time.perf_counter() - t0:.1f} s")
    return records


def serve_train_records(torch, dev, out: Path, records, read):
    """``MMRPredictor.from_run_dir`` on the run ``out``: a predict of its
    first PIPE_SERVE train records (from their DICOM files, at PIPE_TEXT
    tokens) -> (the predictor, the inputs, the outputs, the launches ``read``
    gives after it (set to 0 before it by the caller), whether each record's
    own gallery row is at rank 1)."""
    import numpy as np

    from mmrp_tpu_torch.api import MMRPredictor
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.data.dataset import ChestXRDataset
    from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer

    pred = MMRPredictor.from_run_dir(str(out), device=dev)
    tok = WordPieceTokenizer.from_vocab_file(str(out / "vocab.txt"))
    train_ids = json.loads((out / "train_ids.json").read_text())[:PIPE_SERVE]
    by_id = {r["id"]: r for r in records}
    run_cfg = Config.load(str(out / "config.yaml"))
    ds = ChestXRDataset([by_id[i] for i in train_ids], tok, max_length=PIPE_TEXT,
                        image_size=run_cfg.image_size)
    items = [ds[i] for i in range(len(train_ids))]
    inputs = (np.stack([it["image"] for it in items]),
              np.stack([it["input_ids"] for it in items]).astype(np.int64),
              np.stack([it["attention_mask"] for it in items]).astype(np.int64))
    got = pred.predict(*inputs, K=5, retrieve=False)
    served = read()
    ranks = [pred.retrieve(got["joint_emb"][b], K=1, rerank=False)[0][0] == rid
             for b, rid in enumerate(train_ids)]
    return pred, inputs, got, served, ranks


def pipeline_phase(torch, dev, smi: str, tmp: str) -> dict:
    """Phase 8 (module docstring): returns {"pipeline": total launches of the
    two runs, "finetune_step" / "finetune_val_batch" / "joint_step" /
    "eval_batch" / "dump_batch": launches of one such call}."""
    import numpy as np

    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.kg import trainer as kg_trainer
    from mmrp_tpu_torch.labels import LABEL_COLS
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, model_routes
    from mmrp_tpu_torch.train import runner as trunner
    from mmrp_tpu_torch.utils.checkpoint import CheckpointManager

    calls = RunnerCalls(torch, "train a run directory")
    reset, read = calls.reset, calls.read
    per_call, first_step, kept, resumed = (calls.per_call, calls.first_step, calls.kept,
                                           calls.resumed)

    # -- the data tree ------------------------------------------------------
    root = Path(tmp) / "openi"
    records = write_pipe_tree(root)

    cfg = Config(batch_size=PIPE_B, text_dim=PIPE_TEXT, epochs=1, patience=10,
                 swin_finetune_epochs=1, kg_epochs=1, la_epochs=1, seed=SEED, data_workers=6,
                 train_use_pallas_attention=True, use_pallas_attention=True, augment=False)
    mm_cfg = MultiModalConfig.from_config(
        cfg.replace(use_pallas_attention=cfg.train_use_pallas_attention),
        num_classes=len(LABEL_COLS), flagship=True)
    routes = model_routes(mm_cfg)
    train_routes = model_routes(mm_cfg, train=True)
    bad = [k for k, v in {**routes, **train_routes}.items() if v == "plain"]
    if bad:
        fail(f"train a run directory: plain call sites on the train-time model: {bad}")

    out = root / "train"  # the data CLI's layout: records_cache.json one level up
    with calls:
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        summary = trunner.run_training_pipeline(cfg, str(root), str(out), flagship=True,
                                                device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        saved = calls.real["restore"](CheckpointManager(str(out / "joint" / "ckpt")))
        held = {k: v.detach().cpu().clone() for k, v in kept.pop().named_parameters()}
        gc.collect()
        torch.cuda.empty_cache()
        peak_first = torch.cuda.max_memory_allocated() / 2 ** 30

        # -- resume to two joint epochs ----------------------------------------
        def check(model, state):
            # the state and the model the resumed run's first step is given
            resumed["equal"] = all(
                torch.equal(state.params[k].cpu(), v) for k, v in saved["params"].items()) \
                and all(torch.equal(state.mu[k].cpu(), v)
                        for k, v in saved["opt_state"]["mu"].items()) \
                and all(torch.equal(state.nu[k].cpu(), v)
                        for k, v in saved["opt_state"]["nu"].items()) \
                and state.count == int(saved["opt_state"]["count"]) \
                and state.seed == int(saved["base_rng"])
            resumed["model_equal"] = all(
                torch.equal(p.detach().cpu(), held[k]) for k, p in model.named_parameters())

        first_step["check"] = check
        resumed.clear()
        n_joint = len(per_call["joint_step"])
        t0 = time.perf_counter()
        summary2 = trunner.run_training_pipeline(
            cfg.replace(epochs=2, resume=True), str(root), str(out), flagship=True, device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        total = read()  # both runs: the counts were set to 0 before the first
        model = kept.pop()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del kept[:]

    # -- checks ---------------------------------------------------------------
    if resumed.get("epoch") != 0 or not resumed.get("equal") or not resumed.get("model_equal"):
        fail(f"resume: restored {resumed}; expected epoch 0, the saved state bit for bit and "
             "the model the first run ended with")
    if len(per_call["joint_step"]) - n_joint != len(per_call["joint_step"][:n_joint]):
        fail("resume: the second joint epoch did not take as many steps as the first")
    calls.check(total, text_layers=12)
    for name in PIPE_ARTIFACTS:
        if not (out / name).exists():
            fail(f"train a run directory: artifact {name} missing")
    if not any((out / "joint" / "ckpt" / "steps").iterdir()) or \
            not (out / "joint" / "ckpt" / "best").exists():
        fail("train a run directory: joint checkpoints missing")
    for s_ in (summary, summary2):
        comp = s_.get("joint", {}).get("composite")
        if comp is None or not np.isfinite(comp):
            fail(f"pipeline_summary: joint.composite {comp}")
        for proto in ("generalization", "historical"):
            for m in ("P@10", "mAP", "MRR", "nDCG@10"):
                v = s_.get("retrieval", {}).get(proto, {}).get(m)
                if v is None or not 0.0 <= v <= 1.0:
                    fail(f"pipeline_summary: retrieval.{proto}.{m} = {v}")
    steps = sorted(p.name for p in (out / "joint" / "ckpt" / "steps").iterdir())
    log(f"resume: restored epoch 0 bit for bit, continued at epoch 1; checkpoints {steps}; "
        f"best {summary2['joint']}")

    # -- served back through from_run_dir -------------------------------------
    reset()
    pred, (image, ids_, mask_), got, served, ranks = serve_train_records(
        torch, dev, out, records, read)
    # the mask on the host, as the predictor gives it: the same text route
    want = serving_forward(model)(torch.from_numpy(image).to(dev), torch.from_numpy(ids_).to(dev),
                                  mask_)
    same = np.array_equal(got["probs"], want["probs"].float().cpu().numpy())
    log(f"from_run_dir: {sum(ranks)} of {len(ranks)} train records at rank 1 of their own "
        f"gallery row; probs bit-identical to the in-process model: {same}; launches {served}")
    if not all(ranks) or not same:
        fail("from_run_dir: a train record missed its own row or probs differ")
    del pred, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- the KG run at a hybrid graph's size ------------------------------------
    r = np.random.default_rng(SEED + 9)
    trip = np.stack([r.integers(0, KG_ENTITIES, KG_TRIPLES),
                     r.integers(0, KG_RELATIONS, KG_TRIPLES),
                     r.integers(0, KG_ENTITIES, KG_TRIPLES)], 1)
    kgt = kg_trainer.KGTrainer(KG_ENTITIES, KG_RELATIONS, kg_trainer.KGTrainerConfig(
        model="TransE", emb_dim=KG_DIM, neg_size=KG_NEG, batch_size=KG_BATCH, epochs=1,
        use_bf16=True, seed=SEED), device=dev)
    t0 = time.perf_counter()
    kgt.load_triples(trip.tolist())
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    best = kgt.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = kgt.evaluate(kgt.val_arr)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    sl = kgt.step_losses
    head, tail = float(np.mean(sl[:10])), float(np.mean(sl[-10:]))
    log(f"KG run ({KG_ENTITIES} entities, {KG_RELATIONS} relations, {KG_TRIPLES} triples, TransE "
        f"dim {KG_DIM}, neg {KG_NEG}, batch {KG_BATCH}, bf16 scoring): load {load_s:.2f} s, "
        f"one epoch of {len(sl)} steps + filtered eval {train_s:.2f} s, filtered eval of "
        f"{len(kgt.val_arr)} val triples alone {eval_s:.2f} s; loss first 10 steps {head:.4f} "
        f"-> last 10 {tail:.4f}; val {val} [{smi}]")
    if not (np.isfinite(sl).all() and tail < head):
        fail(f"KG run: the loss did not fall ({head} -> {tail})")
    if abs(best["mrr"] - val["mrr"]) > 1e-6:
        fail(f"KG run: evaluate after train {val} != the epoch's {best}")

    # -- for information -------------------------------------------------------
    med = calls.median_ms
    ft_ms, joint_ms = med("finetune_step"), med("joint_step")
    log(f"pipeline seconds: first run {first_s:.1f}, resume run {resume_s:.1f}; by stage "
        f"{ {k: round(v, 1) for k, v in calls.stage_s.items()} } [{smi}]")
    log(f"pipeline steps (batch {PIPE_B}, L{PIPE_TEXT}): finetune step median {ft_ms:.1f} ms "
        f"over {len(per_call['finetune_step'])}, joint step median {joint_ms:.1f} ms over "
        f"{len(per_call['joint_step'])} ({PIPE_B / joint_ms * 1e3:.1f} train pairs/s), "
        f"val batch {med('eval_batch'):.1f} ms, dump batch {med('dump_batch'):.1f} ms; peak "
        f"device memory {peak_first:.2f} GiB (first run), {peak:.2f} GiB (both) [{smi}]")
    counts = {kind: per_call[kind][0][0] for kind in per_call}
    log(f"pipeline launches per call: {counts}; over both runs {total}")
    log(f"pipeline device ms of one call by kernel (profiler; 'other': every other "
        f"kernel): {calls.device} [{smi}]")
    return {"pipeline": total, **counts}


# phase 9, the Quick start through the cli: an OpenI-layout tree of CLI_RECORDS
# XML reports (eCitation / AbstractText / MeSH / parentImage, built from the
# taxonomy's phrases, some negated) and 16-bit DICOM files of CLI_DICOM_HW^2
# (phase 8's cut), then `python -m mmrp_tpu_torch.cli` data, train (the
# shipped configs/config.yaml, depth cut: one epoch per stage), calibrate,
# parity, stream, eval-cls, eval-ret, kg-probe and mapper, each through
# cli.main; the native decoder against the Python path at 2048^2 first, and
# the DLS engine over phase 4c's gallery last
CLI_RECORDS = 320
CLI_DICOM_HW = 512
CLI_EXPLAIN_N = 2  # parity's explain-alignment queries (--explain-n)
CLI_CALIB_N = 64  # calibrate -n
NATIVE_FILES, NATIVE_HW = 8, 2048
NATIVE_TOL = 0.02  # tests/test_native_io.py: within one uint8 quantum, resize edges aside
# words of no taxonomy phrase: each report's filler sentence
CLI_FILLER = ("frontal and lateral views of the chest were obtained compared with the prior "
              "study dated there is interval change in appearance patient history positioning "
              "technique adequate images reviewed findings impression").split()
DLS_CHECK_ROWS = 1024  # link-graph rows recomputed on the CPU
DLS_TIE = 1e-5  # neighbour lists compared where adjacent similarities differ by more
PARITY_SECTIONS = ("classification", "retrieval", "variants", "embedding_rank",
                   "explain_alignment", "diversity", "kg_health")
DATA_ARTIFACTS = ("records_cache.json", "eda_before_split.json",
                  "eda_after_split.json", "phrase_check.json", "eda/mesh_label_stats.json",
                  "eda/dicom_debug_stats.json", "splits/train_ids.json", "splits/val_ids.json",
                  "splits/test_ids.json", "splits/split_label_counts.json")


def links_agree(nb, s, nb_full, s_full, threshold: float):
    """(link positions compared, row ends compared, disagreements) of a link
    graph's rows against the reference's full rows (each row's first
    max_links neighbours, no threshold). A row's links must be a prefix of
    its row. Its end, the number of links, must lie where the reference's
    similarities cross the threshold, give or take DLS_TIE; the end counts as
    compared where no similarity of the row lies within DLS_TIE of the
    threshold. A link position is compared where the reference's similarity
    there is more than DLS_TIE from its neighbours in the list and from the
    threshold (ties and the threshold's edge may fall either way in another
    summation order); there the ids must be equal and the similarities
    within DLS_TIE."""
    compared = ends = differ = 0
    for r in range(len(nb_full)):
        sims = s_full[r]
        n_links = int((nb[r] >= 0).sum())
        lo = int((sims >= threshold + DLS_TIE).sum())
        hi = int((sims >= threshold - DLS_TIE).sum())
        ends += lo == hi
        differ += bool((nb[r, :n_links] < 0).any()) + (not lo <= n_links <= hi)
        for j in range(min(lo, n_links)):
            near = [abs(sims[j] - threshold)]
            if j > 0:
                near.append(abs(sims[j - 1] - sims[j]))
            if j + 1 < len(sims):
                near.append(abs(sims[j + 1] - sims[j]))
            if min(near) <= DLS_TIE:
                continue
            compared += 1
            if nb[r, j] != nb_full[r, j] or abs(float(s[r, j]) - float(sims[j])) > DLS_TIE:
                differ += 1
    return compared, ends, differ


def cli_phase(torch, dev, smi: str, tmp: str, gallery, gallery_ids, query_rows) -> dict:
    """Phase 9 (module docstring): returns {"cli": the launches of the cli's
    subcommands, counted from 0 before `data` to after `mapper`}."""
    import numpy as np
    from xml.sax.saxutils import escape

    from mmrp_tpu_torch import cli
    from mmrp_tpu_torch.api import MMRPredictor
    from mmrp_tpu_torch.config import Config, dump_flat_yaml
    from mmrp_tpu_torch.data import native
    from mmrp_tpu_torch.data.dicom import DICOMImagePreprocessor, read_dicom, write_dicom
    from mmrp_tpu_torch.data.labeler import PhraseLabeler
    from mmrp_tpu_torch.eval.gt import build_label_overlap_gt
    from mmrp_tpu_torch.labels import LABEL_COLS, get_taxonomy
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, model_routes
    from mmrp_tpu_torch.retrieval import RetrievalEngine, make_retrieval_engine
    from mmrp_tpu_torch.retrieval.dls import link_block
    from mmrp_tpu_torch.retrieval.gallery import l2_normalize

    root = Path(tmp) / "cli"
    rng = np.random.default_rng(SEED + 10)

    # -- the native decoder against the Python path ---------------------------
    if not native.available():
        fail("native decoder: not built (phase 2 builds it)")
    blobs = []
    for i in range(NATIVE_FILES):
        pixels = (rng.random((NATIVE_HW, NATIVE_HW)) * 3000 + 500).astype(np.uint16)
        blobs.append(write_dicom(None, pixels, window_center=float(rng.uniform(1500, 2500)),
                                 window_width=float(rng.uniform(1500, 3000)),
                                 photometric="MONOCHROME1" if i % 4 == 3 else "MONOCHROME2",
                                 rescale_slope=1.0 if i % 2 else 0.5,
                                 rescale_intercept=0.0 if i % 2 else -100.0))
    rates = {}
    for name, pp in (("native", DICOMImagePreprocessor()),
                     ("python", DICOMImagePreprocessor(use_native=False))):
        t0 = time.perf_counter()
        out = [pp.load(b) for b in blobs]
        rates[name] = (len(blobs) / (time.perf_counter() - t0), np.stack(out))
    err = float(np.abs(rates["native"][1] - rates["python"][1]).max())
    dcms = [read_dicom(b) for b in blobs]
    exact = all(np.array_equal(native.decode_raw(b), d.pixel_array.astype(np.float32)
                               * d.rescale_slope + d.rescale_intercept)
                for b, d in zip(blobs, dcms))
    t0 = time.perf_counter()
    _, status = native.preprocess_batch(blobs)
    pool_rate = len(blobs) / (time.perf_counter() - t0)
    log(f"native decoder: DICOMImagePreprocessor.load of {NATIVE_FILES} 16-bit DICOM files of "
        f"{NATIVE_HW}^2 -> 224^2: max |native - Python| {err:.6f} (<= {NATIVE_TOL}); decode_raw "
        f"exact: {exact}; images/s (host clock) native {rates['native'][0]:.1f}, Python "
        f"{rates['python'][0]:.1f}, native batch pool {pool_rate:.1f} [{smi}]")
    if err > NATIVE_TOL or not exact or (status != 0).any():
        fail("native decoder: disagrees with the Python path, decode_raw is not exact, or the "
             f"batch pool failed (status {status.tolist()})")

    # -- the OpenI-layout tree --------------------------------------------------
    t0 = time.perf_counter()
    xml_dir, dcm_dir, data = root / "xml", root / "dcm", root / "data"
    xml_dir.mkdir(parents=True)
    dcm_dir.mkdir()
    groups = get_taxonomy().combined_groups()
    names = list(groups)
    labeler = PhraseLabeler()
    for i in range(CLI_RECORDS):
        while True:  # phrases of 1-3 groups and negated phrases of 0-2: at least one label
            pos = rng.choice(len(names), int(rng.integers(1, 4)), replace=False)
            neg = rng.choice(len(names), int(rng.integers(0, 3)), replace=False)
            sentences = [str(rng.choice(groups[names[g]])).capitalize() for g in pos]
            sentences += [f"No {rng.choice(groups[names[g]])}" for g in neg]
            sentences.append(" ".join(rng.choice(CLI_FILLER, int(rng.integers(20, 120)))))
            rng.shuffle(sentences)
            text = ". ".join(sentences) + f". Study number {i + 1}."
            if any(labeler.label_vector(text)):
                break
        rid = f"{i + 1}_IM-{i:04d}-1001"
        mesh = "".join(f"<major>{escape(names[g])}</major>" for g in pos)
        (xml_dir / f"{i + 1}.xml").write_text(
            f"<eCitation><ArticleTitle>report {i + 1}</ArticleTitle><Abstract><AbstractText>"
            f"{escape(text)}</AbstractText></Abstract><MeSH>{mesh}</MeSH>"
            f'<parentImage id="CXR{rid}"/></eCitation>')
        pixels = (rng.random((CLI_DICOM_HW, CLI_DICOM_HW)) * 3000 + 500).astype(np.uint16)
        write_dicom(dcm_dir / f"{rid}.dcm", pixels, window_center=2000, window_width=3000)
    log(f"cli: OpenI-layout tree of {CLI_RECORDS} XML reports and 16-bit DICOM files of "
        f"{CLI_DICOM_HW}^2 written in {time.perf_counter() - t0:.1f} s")

    seconds = {}

    def run(name, argv, rc=0):
        t0 = time.perf_counter()
        got = cli.main(argv)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 2)
        if got != rc:
            fail(f"cli {name}: exit status {got}, expected {rc}")
        gc.collect()
        torch.cuda.empty_cache()

    def need(*paths):
        for path in paths:
            if not Path(path).exists():
                fail(f"cli: {path} missing")

    calls = RunnerCalls(torch, "cli train")
    calls.reset()  # the cli path's count starts here

    # -- data -------------------------------------------------------------------
    run("data", ["data", "--xml-dir", str(xml_dir), "--dicom-dir", str(dcm_dir),
                 "--out", str(data), "--seed", str(SEED)])
    need(*(data / f for f in DATA_ARTIFACTS))
    records = json.loads((data / "records_cache.json").read_text())["records"]
    split = {s: json.loads((data / "splits" / f"{s}_ids.json").read_text())
             for s in ("train", "val", "test")}
    labelled = {r["id"] for r in records if any(r["labels"])}
    if len(records) != CLI_RECORDS or set().union(*split.values()) != labelled or \
            sum(map(len, split.values())) != len(labelled):
        fail(f"cli data: {len(records)} records, {len(labelled)} labelled, splits "
             f"{ {k: len(v) for k, v in split.items()} }")
    prev = json.loads((data / "eda_before_split.json").read_text())["prevalence"]
    top = sorted(prev.items(), key=lambda kv: -kv[1])[:6]
    log(f"cli data: {len(records)} records, {len(labelled)} with a label, splits "
        f"{ {k: len(v) for k, v in split.items()} }; {sum(v > 0 for v in prev.values())} of "
        f"{len(prev)} labels present, the most prevalent "
        f"{ {k: round(v, 3) for k, v in top} }")

    # -- train: configs/config.yaml cut to one epoch per stage -----------------
    cfg = Config.load(str(REPO / "configs" / "config.yaml")).replace(
        epochs=1, swin_finetune_epochs=1, kg_epochs=1, la_epochs=1,
        train_use_pallas_attention=True, data_workers=6)
    cfg_path = root / "config.yaml"
    dump_flat_yaml(cfg.to_dict(), str(cfg_path))
    mm_cfg = MultiModalConfig.from_config(
        cfg.replace(use_pallas_attention=cfg.train_use_pallas_attention),
        num_classes=len(LABEL_COLS))
    routes = {**model_routes(mm_cfg), **model_routes(mm_cfg, train=True)}
    bad = [k for k, v in routes.items() if v == "plain"]
    if bad:
        fail(f"cli train: plain call sites on the model cli train builds: {bad}")
    layers = mm_cfg.text.num_layers
    log(f"cli train: Swin-B {mm_cfg.swin.img_size} px, text tower {mm_cfg.text} "
        f"({layers} layers), {mm_cfg.num_fusion_layers} fusion layers at {mm_cfg.joint_dim}, "
        f"batch {cfg.batch_size}, L{cfg.text_dim}, KG {cfg.kg_model} ({cfg.kg_mode}); no plain "
        "call site")
    run_dir = data / "train"
    with calls:
        run("train", ["train", "--config", str(cfg_path), "--data", str(data),
                      "--out", str(run_dir)])
    train_total = calls.read()
    calls.check(train_total, text_layers=layers)
    need(*(run_dir / f for f in PIPE_ARTIFACTS))
    summary = json.loads((run_dir / "pipeline_summary.json").read_text())
    if not np.isfinite(summary["joint"]["composite"]):
        fail(f"cli train: joint.composite {summary['joint']}")
    log(f"cli train: steps finetune {len(calls.per_call['finetune_step'])} (median "
        f"{calls.median_ms('finetune_step'):.1f} ms), joint {len(calls.per_call['joint_step'])} "
        f"(median {calls.median_ms('joint_step'):.1f} ms); stages "
        f"{ {k: round(v, 1) for k, v in calls.stage_s.items()} }; launches per call "
        f"{ {k: v[0][0] for k, v in calls.per_call.items()} }, in all {train_total}")
    _, _, per_embed = pipe_expected(layers)

    # -- calibrate: plain f32, no kernel -----------------------------------------
    before = calls.read()
    run("calibrate", ["calibrate", "--run-dir", str(run_dir), "--data", str(data),
                      "-n", str(CLI_CALIB_N)])
    blocks = json.loads((run_dir / "swin_act_amax.json").read_text())["blocks"]
    if len(blocks) != sum(mm_cfg.swin.depths) or calls.diff(calls.read(), before):
        fail(f"cli calibrate: {len(blocks)} blocks, launches {calls.diff(calls.read(), before)}")
    log(f"cli calibrate: {len(blocks)} blocks over {CLI_CALIB_N} images")

    # -- parity: every embed on the default route --------------------------------
    embeds = []
    real_embed = MMRPredictor.embed

    def embed(self, *a):
        before = calls.read()
        out = real_embed(self, *a)
        embeds.append((calls.diff(calls.read(), before), len(a[0])))
        return out

    MMRPredictor.embed = embed
    before = calls.read()
    try:
        run("parity", ["parity", "--data", str(data), "--run-dir", str(run_dir), "-k", "10",
                       "--explain-n", str(CLI_EXPLAIN_N)])
    finally:
        MMRPredictor.embed = real_embed
    explain_launches = calls.diff(calls.read(), before)
    for counts, n in embeds:
        if counts != per_embed:
            fail(f"cli parity: an embed of {n} launched {counts}, expected {per_embed}")
    rep = json.loads((run_dir / "parity" / "parity_results.json").read_text())
    md = (run_dir / "parity" / "PARITY_RESULTS.md").read_text()
    missing = [s for s in PARITY_SECTIONS if s not in rep]
    if missing or rep["n_test"] != len(split["test"]) or "Explain alignment" not in md:
        fail(f"cli parity: sections missing {missing}, n_test {rep['n_test']}")
    log(f"cli parity: n_test {rep['n_test']}, {len(embeds)} embeds of {[n for _, n in embeds]} "
        f"each {per_embed}; launches of the whole run {explain_launches}; classification "
        f"macro AUROC {rep['classification'].get('macro_auroc')}, explain alignment "
        f"{rep['explain_alignment']}")

    # -- stream: the default route per batch ---------------------------------------
    before = calls.read()
    run("stream", ["stream", "--run-dir", str(run_dir), "--data", str(data), "-k", "10"])
    stats = json.loads((run_dir / "stream_test" / "stream_stats.json").read_text())
    rows = (run_dir / "stream_test" / "predictions.jsonl").read_text().splitlines()
    n_batches = -(-len(split["test"]) // cfg.batch_size)
    got = calls.diff(calls.read(), before)
    if len(rows) != len(split["test"]) or got != {k: n_batches * v for k, v in per_embed.items()}:
        fail(f"cli stream: {len(rows)} rows, launches {got} over {n_batches} batches")
    log(f"cli stream: {stats}")

    # -- eval-cls, eval-ret, kg-probe, mapper, and the two not ported -------------
    by_id = {r["id"]: r for r in records}
    preds = [json.loads(r) for r in rows]
    np.save(root / "probs.npy", np.array([p["probs"] for p in preds], np.float32))
    np.save(root / "labels.npy", np.array([by_id[p["id"]]["labels"] for p in preds], np.float32))
    run("eval-cls", ["eval-cls", "--probs", str(root / "probs.npy"), "--labels",
                     str(root / "labels.npy"), "--thresholds",
                     str(run_dir / "joint" / "thresholds.npy"), "--out", str(root / "cls")])
    test_ids = json.loads((run_dir / "test_ids.json").read_text())
    train_ids = json.loads((run_dir / "train_ids.json").read_text())
    lab = lambda ids: np.array([by_id[i]["labels"] for i in ids])  # noqa: E731
    build_label_overlap_gt(test_ids, lab(test_ids), test_ids, lab(test_ids),
                           out_path=str(root / "gt_test.json"))
    build_label_overlap_gt(test_ids, lab(test_ids), train_ids, lab(train_ids),
                           out_path=str(root / "gt_train.json"))
    run("eval-ret", ["eval-ret", "--test-emb", str(run_dir / "test_embeddings.npy"),
                     "--test-ids", str(run_dir / "test_ids.json"),
                     "--train-emb", str(run_dir / "train_embeddings.npy"),
                     "--train-ids", str(run_dir / "train_ids.json"),
                     "--gt-test", str(root / "gt_test.json"),
                     "--gt-train", str(root / "gt_train.json"), "--variants",
                     "--run-dir", str(run_dir), "--data", str(data), "--out", str(root / "ret")])
    run("kg-probe", ["kg-probe", "--kg-dir", str(run_dir / "kg"),
                     "--out-file", str(root / "kg_probe.json")])
    run("mapper", ["mapper", "--out", str(root / "onto")])
    need(root / "cls" / "test_per_class.csv", root / "cls" / "test_summary.json",
         root / "ret" / "variants.json", root / "kg_probe.json",
         *(root / "onto" / f"{c}_label2ontology.json"
           for c in ("disease", "finding", "symptom", "normal")))
    total = calls.read()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mmrp_tpu_torch.cli", "export-serving",
                           "--run-dir", str(run_dir), "--data", str(data), "--out-path",
                           str(root / "artifact.npz"), "--batches", "1,8"], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    seconds["export-serving"] = round(time.perf_counter() - t0, 2)
    if proc.returncode != 0:
        fail(f"cli export-serving: exit status {proc.returncode}:\n{proc.stderr[-3000:]}")
    printed = json.loads(proc.stdout)
    want_keys = {"artifact", "label_names", "threshold", "image_size", "text_len",
                 "batch_sizes", "platforms", "outputs"}
    log(f"cli export-serving --batches 1,8: {seconds['export-serving']} s, printed "
        f"{sorted(printed)}, batch_sizes {printed.get('batch_sizes')}, platforms "
        f"{printed.get('platforms')}, artifact {(root / 'artifact.npz').stat().st_size} bytes")
    if set(printed) != want_keys or printed["batch_sizes"] != [1, 8] \
            or printed["platforms"] != ["cuda"]:
        fail(f"cli export-serving: printed {sorted(printed)}, expected JAX's {sorted(want_keys)}")
    run("bench", ["bench"], rc=2)
    log(f"cli: seconds per subcommand {seconds} [{smi}]")
    log(f"cli: launches of the cli path {total}")

    # -- DLS over phase 4c's gallery -----------------------------------------------
    engines = {}
    for label, kw in (("default", {}), ("link_threshold -1 (a 10-NN graph)",
                                        {"link_threshold": -1.0})):
        t0 = time.perf_counter()
        eng = make_retrieval_engine("dls", gallery, gallery_ids, device=dev, **kw)
        torch.cuda.synchronize()
        if not kw:
            label = f"link_threshold {eng.link_threshold} (the default)"
        engines[label] = (eng, time.perf_counter() - t0)
    g_cpu = torch.from_numpy(l2_normalize(np.asarray(gallery, np.float32)))
    exact = RetrievalEngine(gallery, gallery_ids, device=dev)
    # the first DLS_CHECK_ROWS rows, and the query rows (on a random gallery the
    # only rows with links at the default threshold); each row's full list once
    t0 = time.perf_counter()
    starts = ((0, DLS_CHECK_ROWS), (min(query_rows), len(query_rows)))
    max_links = next(iter(engines.values()))[0].max_links
    full = [(start, rows, *(a.numpy() for a in link_block(g_cpu, start, rows, max_links, -1.0)))
            for start, rows in starts]
    cpu_s = time.perf_counter() - t0
    for label, (eng, build_s) in engines.items():
        compared = ends = differ = 0
        for start, rows, nb_full, s_full in full:
            c, e, d = links_agree(eng.neighbors[start:start + rows],
                                  eng.link_sims[start:start + rows], nb_full, s_full,
                                  eng.link_threshold)
            compared, ends, differ = compared + c, ends + e, differ + d
        links = int((eng.neighbors >= 0).sum())
        recall, walk_ms = [], []
        for r in query_rows:
            t1 = time.perf_counter()
            got = [i for i, _ in eng.retrieve(gallery[r], K=10, query_id=gallery_ids[r])]
            walk_ms.append((time.perf_counter() - t1) * 1e3)
            want = [i for i, _ in exact.retrieve(gallery[r], K=10, query_id=gallery_ids[r])]
            recall.append(len(set(got) & set(want)) / len(want))
        log(f"DLS {label}: {len(gallery)} x {gallery.shape[1]} gallery, link graph built in "
            f"{build_s:.2f} s on the card ({links} links); the first {DLS_CHECK_ROWS} rows and "
            f"the {len(query_rows)} query rows against the CPU f32 recomputation "
            f"({cpu_s:.1f} s, shared): {compared} link positions and {ends} row ends compared, "
            f"{differ} differ; recall@10 of {len(recall)} walks against exact top-10 "
            f"{np.mean(recall):.3f} ({[round(x, 2) for x in recall]}), walk median "
            f"{statistics.median(walk_ms):.2f} ms [{smi}]")
        if differ:
            fail(f"DLS {label}: the link graph disagrees with its CPU recomputation")
        if not (compared and ends):
            fail(f"DLS {label}: no link position or no row end was compared with the CPU "
                 "recomputation")
    return {"cli": total}


# phase 10, the pretrained bootstrap and the other towers: checkpoints in the
# published layouts and dims (random weights from a seed; no transformers on
# the card), the runner bootstrapped from them on phase 8's tree, and the
# reference's backbone ablations and fusion variants at the flagship's widths.
# Bio_ClinicalBERT's config (vocab, width, layers, heads, FFN, positions,
# token types) and microsoft/swin-base-patch4-window7-224's / MedCLIP's
# Swin-Tiny (embed, depths, heads; window 7)
HF_BERT = dict(vocab=28_996, hidden=768, layers=12, heads=12, ffn=3072, positions=512, types=2)
HF_SWIN_B = (128, (2, 2, 18, 2), (4, 8, 16, 32))
HF_SWIN_T = (96, (2, 2, 6, 2), (3, 6, 12, 24))
MEDCLIP_PROJ = 512
# launches of one serving forward (batch 8, L512) of each flagship-width
# model: the ClinicalBERT-dim text tower's 12 K3 and the fusion stack's 25
# K3 and 5 K2 in each; MedCLIP's Swin-T as phase 4b's (K1 + K2 at stages 1-2,
# 6 chain steps, 2 windows blocks); ViT, ResNet-50 and EfficientNet-B0 no
# kernel (JAX computes them outside any Pallas kernel). With the shared FFN
# the 5 fusion self-attentions and FFNs take their plain versions (JAX's XLA
# branch), counted in plain_calls.
_FUSION_ONLY = {**ZERO, "fused_ln_mlp": 5, "fused_attention": 37}
EXPECTED_TOWER = {
    "medclip": {**ZERO, "fused_window_attention": 4, "fused_ln_mlp": 9, "fused_attention": 37,
                "fused_swin_block_chain": 6, "fused_swin_block_windows": 2},
    "vit": _FUSION_ONLY, "resnet50": _FUSION_ONLY, "efficientnet": _FUSION_ONLY,
    "shared_ffn": {**EXPECTED["whole"], "fused_ln_mlp": 2, "fused_attention": 32},
    "cls_only": EXPECTED["whole"],
}
EXPECTED_TOWER_PLAIN = {"shared_ffn": {"fused_attention": 5, "fused_ln_mlp_residual": 5}}
PRE_FIELDS = {"medclip": dict(image_backbone="medclip"), "vit": dict(image_backbone="vit"),
              "resnet50": dict(image_backbone="resnet50"),
              "efficientnet": dict(image_backbone="efficientnet"),
              "shared_ffn": dict(use_shared_ffn=True), "cls_only": dict(use_cls_only=True)}


def hf_bert_state(torch, gen) -> dict:
    """A ``BertForPreTraining`` state dict at HF_BERT's dims: ``bert.`` keys
    and the pretraining head's ``cls.`` keys, seeded: weights N(0, 0.02^2),
    LayerNorm weights 1 + N(0, 0.02^2), biases N(0, 0.02^2)."""
    d = HF_BERT
    H, F_ = d["hidden"], d["ffn"]
    sd = {}

    def rnd(*shape, mean=0.0):
        return torch.randn(shape, generator=gen) * 0.02 + mean

    def lin(name, i, o):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rnd(o, i), rnd(o)

    def ln(name, n):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rnd(n, mean=1.0), rnd(n)

    sd["bert.embeddings.word_embeddings.weight"] = rnd(d["vocab"], H)
    sd["bert.embeddings.position_embeddings.weight"] = rnd(d["positions"], H)
    sd["bert.embeddings.token_type_embeddings.weight"] = rnd(d["types"], H)
    ln("bert.embeddings.LayerNorm", H)
    for i in range(d["layers"]):
        p = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", H, H)
        lin(f"{p}.attention.output.dense", H, H)
        ln(f"{p}.attention.output.LayerNorm", H)
        lin(f"{p}.intermediate.dense", H, F_)
        lin(f"{p}.output.dense", F_, H)
        ln(f"{p}.output.LayerNorm", H)
    lin("bert.pooler.dense", H, H)
    lin("cls.predictions.transform.dense", H, H)
    ln("cls.predictions.transform.LayerNorm", H)
    sd["cls.predictions.bias"] = rnd(d["vocab"])
    # tied to the word embeddings and the head's bias, as HF saves them
    sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    lin("cls.seq_relationship", H, 2)
    return sd


def hf_swin_state(torch, gen, layout, window: int = 7) -> dict:
    """A ``SwinModel`` state dict of ``layout`` (embed, depths, heads),
    seeded as :func:`hf_bert_state`, with HF's int64
    ``relative_position_index`` buffers."""
    embed, depths, heads = layout
    sd = {}

    def rnd(*shape, mean=0.0):
        return torch.randn(shape, generator=gen) * 0.02 + mean

    def lin(name, i, o, bias=True):
        sd[f"{name}.weight"] = rnd(o, i)
        if bias:
            sd[f"{name}.bias"] = rnd(o)

    def ln(name, n):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = rnd(n, mean=1.0), rnd(n)

    sd["embeddings.patch_embeddings.projection.weight"] = rnd(embed, 3, 4, 4)
    sd["embeddings.patch_embeddings.projection.bias"] = rnd(embed)
    ln("embeddings.norm", embed)
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + window - 1
    index = rel[..., 0] * (2 * window - 1) + rel[..., 1]
    for s, (depth, h) in enumerate(zip(depths, heads)):
        C = embed * 2 ** s
        for b in range(depth):
            p = f"encoder.layers.{s}.blocks.{b}"
            ln(f"{p}.layernorm_before", C)
            sd[f"{p}.attention.self.relative_position_bias_table"] = rnd((2 * window - 1) ** 2, h)
            sd[f"{p}.attention.self.relative_position_index"] = index.clone()
            for n in ("query", "key", "value"):
                lin(f"{p}.attention.self.{n}", C, C)
            lin(f"{p}.attention.output.dense", C, C)
            ln(f"{p}.layernorm_after", C)
            lin(f"{p}.intermediate.dense", C, 4 * C)
            lin(f"{p}.output.dense", 4 * C, C)
        if s < len(depths) - 1:
            lin(f"encoder.layers.{s}.downsample.reduction", 4 * C, 2 * C, bias=False)
            ln(f"encoder.layers.{s}.downsample.norm", 4 * C)
    ln("layernorm", embed * 2 ** (len(depths) - 1))
    return sd


def write_safetensors(path: Path, tensors: dict) -> None:
    """``tensors`` (CPU, f32 or int64) as a ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header, the raw buffers."""
    names = {"torch.float32": "F32", "torch.int64": "I64"}
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().numpy().tobytes()
        header[name] = {"dtype": names[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def pretrained_phase(torch, dev, smi: str, root: Path) -> dict:
    """Phase 10 (module docstring) on phase 8's tree under ``root``: returns
    the launches of each path it drives ("bootstrap": both stages and the
    dumps of the run; "bootstrap_serve": the served predict; one serving
    forward of each of PRE_FIELDS)."""
    import numpy as np

    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.labels import LABEL_COLS
    from mmrp_tpu_torch.models import port
    from mmrp_tpu_torch.models.medclip import MedCLIPVisionEncoder
    from mmrp_tpu_torch.models.multimodal import (
        MultiModalConfig,
        MultiModalRetrievalModel,
        plain_routes,
    )
    from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder
    from mmrp_tpu_torch.models.text_encoder import TextConfig, TextEncoder
    from mmrp_tpu_torch.train import runner as trunner
    from mmrp_tpu_torch.utils.convert import flax_to_state_dict, init_params

    bf16, f32 = torch.bfloat16, torch.float32
    launches = {}
    records = json.loads((root / "records_cache.json").read_text())["records"]

    # -- a. the checkpoints and the vocabulary -----------------------------------
    t0 = time.perf_counter()
    ck = root / "pretrained"
    ck.mkdir()
    gen = torch.Generator().manual_seed(SEED + 10)
    bert_sd = hf_bert_state(torch, gen)
    torch.save(bert_sd, ck / "pytorch_model.bin")
    swin_sd = hf_swin_state(torch, gen, HF_SWIN_B)
    write_safetensors(ck / "model.safetensors", swin_sd)
    medclip_sd = {f"vision_model.model.{k}": v
                  for k, v in hf_swin_state(torch, gen, HF_SWIN_T).items()}
    t_width = HF_SWIN_T[0] * 2 ** (len(HF_SWIN_T[1]) - 1)  # Swin-T's 768
    medclip_sd["vision_model.projection_head.weight"] = \
        torch.randn(MEDCLIP_PROJ, t_width, generator=gen) * 0.02
    words = sorted(set(PIPE_WORDS) | {"."})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    vocab += [f"tok{i}" for i in range(HF_BERT["vocab"] - len(vocab))]
    (ck / "vocab.txt").write_text("\n".join(vocab) + "\n")
    mib = {p.name: round(p.stat().st_size / 2 ** 20, 1) for p in sorted(ck.iterdir())}
    log(f"pretrained checkpoints: BertForPreTraining at Bio_ClinicalBERT's dims {HF_BERT} "
        f"(torch.save), SwinModel at swin-base-patch4-window7-224's layout {HF_SWIN_B} "
        f"(safetensors), MedCLIP's vision dict (Swin-T {HF_SWIN_T} + projection "
        f"{MEDCLIP_PROJ} x {t_width}), a vocab.txt of {len(vocab)} lines; MiB {mib}; "
        f"{time.perf_counter() - t0:.1f} s")

    # -- b. what the converters read -----------------------------------------------
    t0 = time.perf_counter()
    bert_np = port.load_pretrained_state(ck / "pytorch_model.bin")
    swin_np = port.load_pretrained_state(ck)  # the directory: its model.safetensors
    if swin_np.keys() != swin_sd.keys() or not all(
            np.array_equal(swin_np[k], v.numpy()) and swin_np[k].dtype == v.numpy().dtype
            for k, v in swin_sd.items()):
        fail("pretrained: the safetensors reader does not return the tensors written")
    text_cfg = port.text_config_from_state(bert_np)
    want_text = TextConfig(vocab_size=HF_BERT["vocab"], hidden_dim=HF_BERT["hidden"],
                           num_layers=HF_BERT["layers"], num_heads=HF_BERT["heads"],
                           intermediate_dim=HF_BERT["ffn"], max_positions=HF_BERT["positions"],
                           type_vocab_size=HF_BERT["types"])
    layout = port.swin_layout_from_state(swin_np)
    log(f"text_config_from_state: {text_cfg}; swin_layout_from_state: {layout}")
    if text_cfg != want_text or layout != HF_SWIN_B[1:]:
        fail("pretrained: the checkpoints' dims are not read back")
    trees = {"text": port.convert_hf_bert(bert_np, text_cfg.num_layers),
             "swin": port.convert_hf_swin(swin_np, layout[0]),
             "medclip": port.convert_medclip_vit(medclip_sd, HF_SWIN_T[1])}
    towers = {"text": TextEncoder(text_cfg, bf16, dev),
              "swin": SwinEncoder(SwinConfig.base(), bf16, dev),
              "medclip": MedCLIPVisionEncoder(SwinConfig.tiny(), MEDCLIP_PROJ, bf16, dev)}
    for name, tower in towers.items():
        state = flax_to_state_dict(trees[name])
        tower.load_state_dict(state, strict=True)
        params = dict(tower.named_parameters())
        same = all(torch.equal(params[k], v.to(dev, params[k].dtype)) for k, v in state.items())
        log(f"{name} tower on the card: {len(state)} tensors "
            f"({sum(v.numel() for v in state.values()) / 1e6:.1f} M values) equal to the "
            f"converter's at the model's dtypes, bit for bit: {same}")
        if not same:
            fail(f"pretrained: the converted {name} tower is not the converter's tensors")
    bert_warm = flax_to_state_dict(trees["text"])
    swin_warm = flax_to_state_dict(trees["swin"])
    del towers, trees, bert_np, swin_np, medclip_sd
    log(f"converters and loads: {time.perf_counter() - t0:.1f} s")

    # -- c. the bootstrap ------------------------------------------------------------
    cfg = Config(batch_size=PIPE_B, text_dim=PIPE_TEXT, epochs=1, patience=10,
                 swin_finetune_epochs=1, kg_epochs=1, la_epochs=1, seed=SEED, data_workers=6,
                 train_use_pallas_attention=True, use_pallas_attention=True, augment=False,
                 pretrained_vocab=str(ck / "vocab.txt"),
                 pretrained_bert=str(ck / "pytorch_model.bin"), pretrained_swin=str(ck))
    calls = RunnerCalls(torch, "pretrained bootstrap")
    out = root / "pretrained_run"
    started = {}

    def equal_on(params, prefix, warm):
        return all(torch.equal(params[prefix + k].cpu(), v) for k, v in warm.items())

    def ft_check(model, params):  # the finetune starts from the converted Swin
        started["finetune"] = equal_on(params, "swin.", swin_warm)

    def joint_check(model, state):  # the joint towers: ported BERT, finetuned Swin
        ft = flax_to_state_dict(dict(np.load(out / "swin" / "swin_backbone.npz")))
        started["joint_text"] = equal_on(state.params, "backbones.text.", bert_warm)
        started["joint_swin"] = equal_on(state.params, "backbones.swin.", ft)
        started["joint_swin_moved"] = sum(
            not torch.equal(state.params["backbones.swin." + k].cpu(), v)
            for k, v in swin_warm.items())

    calls.first_step.update(finetune=ft_check, check=joint_check)
    with calls:
        torch.cuda.reset_peak_memory_stats()
        calls.reset()
        t0 = time.perf_counter()
        summary = trunner.run_training_pipeline(cfg, str(root), str(out), flagship=True,
                                                device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        total = calls.read()
        calls.kept.clear()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    calls.check(total, text_layers=HF_BERT["layers"])
    launches["bootstrap"] = total
    log(f"bootstrap: the finetune started from the converted Swin: {started.get('finetune')}; "
        f"the joint text tower from the converted BERT: {started.get('joint_text')}, its Swin "
        f"from the finetuned weights: {started.get('joint_swin')} "
        f"({started.get('joint_swin_moved')} of its {len(swin_warm)} tensors moved from the "
        "raw checkpoint by the finetune)")
    if not all(started.get(k) for k in ("finetune", "joint_text", "joint_swin")):
        fail(f"bootstrap: a tower did not start from its converted weights: {started}")
    mc = json.loads((out / "model_config.json").read_text())
    if {k: mc["text"][k] for k in ("vocab_size", "hidden_dim", "num_layers", "num_heads",
                                   "intermediate_dim", "max_positions", "type_vocab_size")} \
            != {k: getattr(want_text, k) for k in ("vocab_size", "hidden_dim", "num_layers",
                                                   "num_heads", "intermediate_dim",
                                                   "max_positions", "type_vocab_size")}:
        fail(f"bootstrap: model_config.json text {mc['text']} is not the checkpoint's")
    comp = summary.get("joint", {}).get("composite")
    if comp is None or not np.isfinite(comp):
        fail(f"bootstrap: joint.composite {comp}")
    calls.reset()
    pred, _, got, served, ranks = serve_train_records(torch, dev, out, records, calls.read)
    launches["bootstrap_serve"] = served
    if served != {**{k: 0 for k in calls.counters}, **pipe_expected(HF_BERT["layers"])[2]}:
        fail(f"bootstrap: the served predict launched {served}")
    if not all(ranks) or not np.isfinite(got["probs"]).all():
        fail(f"bootstrap: from_run_dir: a train record missed its own row ({ranks})")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    med = calls.median_ms
    log(f"bootstrap run (flagship, batch {PIPE_B}, L{PIPE_TEXT}, one epoch per stage): "
        f"{run_s:.1f} s; by stage { {k: round(v, 1) for k, v in calls.stage_s.items()} }; "
        f"finetune step median {med('finetune_step'):.1f} ms over "
        f"{len(calls.per_call['finetune_step'])}, joint step median {med('joint_step'):.1f} ms "
        f"over {len(calls.per_call['joint_step'])}; peak device memory {peak:.2f} GiB [{smi}]")
    log(f"bootstrap launches: the run {total}, the served predict {served}; plain_calls 0; "
        f"served: {sum(ranks)} of {len(ranks)} train records at rank 1 of their own gallery row")

    # -- d., e. the other towers and the fusion variants at the flagship's widths -----------
    rng = np.random.default_rng(SEED + 10)
    size = Config().image_size
    images = rng.random((B, size, size, 3), dtype=np.float32)
    ids = rng.integers(0, HF_BERT["vocab"], (B, PIPE_TEXT)).astype(np.int64)
    lengths = np.concatenate([[PIPE_TEXT], rng.integers(4, PIPE_TEXT, B - 1)])
    mask = (np.arange(PIPE_TEXT)[None, :] < lengths[:, None]).astype(np.int64)
    cpu_in = tuple(torch.from_numpy(a) for a in (images, ids, mask))
    card_in = tuple(t.to(dev) for t in cpu_in)

    def cosine(a, b):
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    def distance(got, want):
        return (1.0 - float(cosine(got["joint_emb"].float().cpu().numpy(),
                                   want["joint_emb"].numpy()).min()),
                float((got["probs"].float().cpu() - want["probs"].float()).abs().max()))

    rows = {}
    for name, fields in PRE_FIELDS.items():
        t0 = time.perf_counter()
        mcfg = MultiModalConfig.from_config(Config(**fields), num_classes=len(LABEL_COLS),
                                            flagship=True)
        model = MultiModalRetrievalModel(mcfg, dtype=bf16, device=dev).eval()
        init_params(model, seed=SEED)
        fwd = serving_forward(model)
        calls.reset()
        got = fwd(*card_in)
        torch.cuda.synchronize()
        counts = {k: getattr(fn, attr) for k, (fn, attr) in calls.counters.items()}
        plain = {fn.__name__: fn.plain_calls for fn in calls.plain if fn.plain_calls}
        launches[name] = counts
        want_counts = {k: EXPECTED_TOWER[name].get(k, 0) for k in counts}
        want_plain = EXPECTED_TOWER_PLAIN.get(name, {})
        sites = plain_routes(mcfg)
        if counts != want_counts or plain != want_plain:
            fail(f"{name}: launches {counts} plain calls {plain}, expected {want_counts} "
                 f"{want_plain}")
        if sorted(sites) != (["fusion.ffn", "fusion.self_attention"] if want_plain else []):
            fail(f"{name}: plain call sites {sites}")
        ms = cuda_ms(torch, lambda: fwd(*card_in), reps=5, warmup=1)
        ref = MultiModalRetrievalModel(mcfg, dtype=f32, device="cpu").eval()
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        want = serving_forward(ref)(*cpu_in)
        dcos, dprobs = distance(got, want)
        gate = (1.0 - EMB_COS_MIN, PROBS_MAX_DIFF)
        rule = "the flagship's gate"
        if (dcos > gate[0] or dprobs > gate[1]) and name in ("vit", "resnet50", "efficientnet"):
            # the conv and ViT towers in bf16: no further from f32 than twice
            # the all-plain bf16 forward is (the attention maps' rule)
            ref16 = MultiModalRetrievalModel(mcfg, dtype=bf16, device="cpu").eval()
            ref16.load_state_dict(model.state_dict())
            d16 = distance(serving_forward(ref16)(*cpu_in), want)
            gate = (max(gate[0], 2 * d16[0]), max(gate[1], 2 * d16[1]))
            rule = (f"twice the all-plain bf16 forward's distance (1 - cos {d16[0]:.3e}, "
                    f"|dprobs| {d16[1]:.3e})")
            del ref16
        rows[name] = dict(one_minus_cos=dcos, dprobs=dprobs, ms=ms, pairs_s=B / ms * 1e3,
                          launches={k: v for k, v in counts.items() if v},
                          plain_calls=plain, plain_routes=sites)
        log(f"{name} (flagship widths, {mcfg.vision_backbone}, shared FFN "
            f"{mcfg.use_shared_ffn}, cls only {mcfg.use_cls_only}; batch {B}, L{PIPE_TEXT}): "
            f"vs the f32 plain path (CPU): joint_emb cosine min {1 - dcos:.6f}, max |dprobs| "
            f"{dprobs:.3e} (gate: {rule}, 1 - cos <= {gate[0]:.3e}, |dprobs| <= "
            f"{gate[1]:.3e}); forward {ms:.2f} ms, {B / ms * 1e3:.1f} pairs/s; launches "
            f"{rows[name]['launches']}; plain_calls {plain}; plain_routes {sites}; "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
        if dcos > gate[0] or dprobs > gate[1]:
            fail(f"{name}: the kernel route strays from the f32 plain path")
        del model, ref, fwd, got, want
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 10 towers and variants: {json.dumps(rows)}")
    return launches


# phase 11, the serving artifact and explain over the int8 mixes: the
# flagship run of phase 4c exported for cuda at EXPORT_BUCKETS, loaded in a
# fresh process and called at EXPORT_NS rows (cycled over the 8 requests of
# phase 4 at L512, so that each output row has its f32 plain-path row); the
# int8_static mix (phase 4b's calibration) at bucket 8; then
# predict(explain=True) over the int8 mixes and the W8A8 gradient routes
EXPORT_BUCKETS = (1, 8, 32)
EXPORT_NS = (1, 3, 8, 9, 32, 40)
EXPORT_TIMED = (8, 32)
INT8_EXPORT_BUCKET = 8
DUAL_PLATFORMS = ("cuda", "cpu")  # (e): one artifact, a program per platform
INT8_EXPLAIN_MIXES = ("int8", "int8_static")
# targets compared with the CPU: each costs a 50-step IG of the f32 plain path on the CPU,
# the phase's largest item; 2 keep the script well inside its time limit
EXPLAIN_INT8_TARGETS = 2

EXPORT_LOAD = r"""
import json, sys, time
t0 = time.perf_counter()
import importlib
import numpy as np
import torch
from mmrp_tpu_torch.serve.exported import ExportedPredictor

spec = json.loads(sys.argv[1])
wrappers = {name: (getattr(importlib.import_module("mmrp_tpu_torch.ops." + m), fn), attr)
            for name, (m, fn, attr) in spec["counters"].items()}


def counts():
    got = {name: getattr(fn, attr) for name, (fn, attr) in wrappers.items()}
    got["plain_calls"] = sum(fn.plain_calls for fn, _ in wrappers.values())
    return got


def reset():
    for fn, attr in wrappers.values():
        setattr(fn, attr, 0)
        fn.plain_calls = 0


req = np.load(spec["requests"])
report = {"import_s": time.perf_counter() - t0}
out = {}
for label, art in spec["artifacts"].items():
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    pred = ExportedPredictor.load(art["path"], platform="cuda")
    torch.cuda.synchronize()
    rep = {"load_s": time.perf_counter() - t1,
           "memory_allocated": torch.cuda.memory_allocated() - base,
           "launches": {}, "ms": {}, "call_s": {}}
    for n in art["ns"]:
        rows = req["rows_%d" % n]
        reset()
        t1 = time.perf_counter()
        got = pred.call(req["images"][rows], req["ids"][rows], req["mask"][rows])
        rep["call_s"][n] = time.perf_counter() - t1
        rep["launches"][n] = counts()
        for k, v in got.items():
            out["%s/%d/%s" % (label, n, k)] = v
    for b in art["timed"]:
        rows = req["rows_%d" % b]
        x = [torch.from_numpy(a[rows]).cuda() for a in (req["images"], req["ids"], req["mask"])]
        prog = pred._programs[b]
        with torch.inference_mode():
            for _ in range(3):
                prog(pred._state, *x)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(10):
                prog(pred._state, *x)
            ev[1].record()
            torch.cuda.synchronize()
        rep["ms"][b] = ev[0].elapsed_time(ev[1]) / 10
    report[label] = rep
    del pred
    torch.cuda.empty_cache()
report["models_imported"] = sorted(m for m in sys.modules
                                   if m.startswith("mmrp_tpu_torch.models"))
np.savez(spec["out"], **out)
print(json.dumps(report))
"""


def export_rows(n: int):
    """The request rows of an n-row call: the 8 requests cycled in a stride
    of 3, so that neighbouring rows differ."""
    import numpy as np

    return (np.arange(n) * 3) % B


def bucket_chunks(n: int, buckets):
    """[(first row, rows, bucket)] of an n-row call, as ExportedPredictor.call
    splits it: the smallest bucket that fits, else chunks of the largest."""
    fit = [b for b in buckets if b >= n]
    if fit:
        return [(0, n, fit[0])]
    big = max(buckets)
    return [(i, min(big, n - i), big) for i in range(0, n, big)]


def export_phase(torch, dev, smi: str, run: Path, ex: dict) -> tuple:
    """Phase 11 (module docstring) on the flagship run directory ``run``.
    ``ex``: the 8 requests at L512 ("images", "ids", "mask"), their f32
    plain path ("want_joint", "want_probs"), and the flagship's weights at
    the int8 mixes on the card ("int8": {mix: model}). Returns (launches by
    path, gradient routes by kernel) for the kernels line."""
    import numpy as np

    from mmrp_tpu_torch.api import MMRPredictor, serving_forward
    from mmrp_tpu_torch.labels import LABEL_COLS
    from mmrp_tpu_torch.models.explain import ExplanationEngine, compare_maps
    from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
    from mmrp_tpu_torch.ops import fused_attention as K3
    from mmrp_tpu_torch.ops import fused_swin_block as SB
    from mmrp_tpu_torch.ops import fused_window_attention as K1
    from mmrp_tpu_torch.serve import exported as EX

    bf16, f32 = torch.bfloat16, torch.float32
    counters = serving_counters()
    wrappers = {fn for fn, _ in counters.values()}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        for fn in wrappers:
            fn.plain_calls = 0

    def read_counts(plain_ok=False):
        plain = {fn.__name__: fn.plain_calls for fn in wrappers if fn.plain_calls}
        if plain and not plain_ok:
            fail(f"calls on a plain route: {plain}")
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    def plain_copy(m):
        """``m``'s weights on the card with every kernel call site on its
        plain version: each Swin step, and each module's kernel route."""
        c = MultiModalRetrievalModel(m.config, dtype=bf16, device=dev).eval()
        c.load_state_dict(m.state_dict())
        swin = c.backbones.swin
        swin.plan = [[st._replace(kernel=False) for st in steps] for steps in swin.plan]
        for mod in c.modules():
            for attr in ("route", "attn_route", "ffn_route"):
                if getattr(mod, attr, None) == "kernel":
                    setattr(mod, attr, "plain")
        return c

    def cosine(a, b):
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))

    images, ids, mask = ex["images"], ex["ids"], ex["mask"]
    x1 = (images[:1], ids[:1], mask[:1])
    n_tok = int(mask[0].sum())

    def maps_of(engine, targets, pixels):
        """The maps (d) compares: explain of ``targets`` at the request's IG
        steps, token IG of the first at 4 steps and pixel IG at 2 (as 4d)."""
        out = engine.explain(*x1, targets, ig_steps=EXPLAIN_STEPS)
        out["token"] = engine.token_attribution(*x1, targets[0], n_steps=4)[0, :n_tok]
        if pixels:
            out["pixels"] = engine.integrated_gradients_pixels(*x1, targets[0], n_steps=2)
        return out

    out_dir = run.parent / "artifacts"
    out_dir.mkdir(exist_ok=True)
    launches = {}

    # -- (a) the flagship run exported for cuda at EXPORT_BUCKETS ----------------
    served = MMRPredictor.from_run_dir(str(run), device=dev)
    model = served.model
    meta = EX.run_meta(served, EXPORT_BUCKETS, ("cuda",))
    if meta["text_len"] != ids.shape[1]:
        fail(f"export: the run's text length is {meta['text_len']}, not {ids.shape[1]}")
    programs, export_s = {}, {}
    for b in EXPORT_BUCKETS:
        t0 = time.perf_counter()
        programs.update(EX.export_serving_programs(
            model, image_size=meta["image_size"], text_len=meta["text_len"], batch_sizes=(b,),
            platforms=("cuda",)))
        export_s[b] = round(time.perf_counter() - t0, 2)
    flagship = out_dir / "flagship.npz"
    t0 = time.perf_counter()
    EX.save_artifact(flagship, programs, EX.serving_state(model), meta)
    log(f"export: seconds per bucket {export_s}, program bytes "
        f"{ {k: len(v) for k, v in programs.items()} }, artifact {flagship.stat().st_size} "
        f"bytes written in {time.perf_counter() - t0:.1f} s [{smi}]")
    m8 = ex["int8"]["int8_static"]
    t0 = time.perf_counter()
    p8 = EX.export_serving_programs(m8, image_size=meta["image_size"],
                                    text_len=meta["text_len"],
                                    batch_sizes=(INT8_EXPORT_BUCKET,), platforms=("cuda",))
    int8_art = out_dir / "int8_static.npz"
    EX.save_artifact(int8_art, p8, EX.serving_state(m8),
                     dict(meta, batch_sizes=[INT8_EXPORT_BUCKET]))
    log(f"export int8_static at bucket {INT8_EXPORT_BUCKET}: {time.perf_counter() - t0:.1f} s, "
        f"artifact {int8_art.stat().st_size} bytes")
    del programs, p8

    # -- load and call in a fresh process ----------------------------------------
    req = out_dir / "requests.npz"
    np.savez(req, images=images, ids=ids, mask=mask,
             **{f"rows_{n}": export_rows(n) for n in set(EXPORT_NS) | {INT8_EXPORT_BUCKET}})
    spec = {"requests": str(req), "out": str(out_dir / "outputs.npz"), "counters": COUNTERS,
            "artifacts": {
                "flagship": {"path": str(flagship), "ns": list(EXPORT_NS),
                             "timed": list(EXPORT_TIMED)},
                "int8_static": {"path": str(int8_art), "ns": [INT8_EXPORT_BUCKET],
                                "timed": [INT8_EXPORT_BUCKET]}}}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_LOAD, json.dumps(spec)], cwd=str(REPO),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"export: loading in a fresh process failed:\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"export: fresh process {time.perf_counter() - t0:.1f} s (imports "
        f"{report['import_s']:.1f} s); models imported {report['models_imported']}")
    if report["models_imported"]:
        fail(f"export: loading imported model code {report['models_imported']}")
    outs = np.load(out_dir / "outputs.npz")

    live = serving_forward(model)
    live8 = serving_forward(m8)

    def live_padded(fwd, rows, buckets):
        """The live forward on ``rows`` split and padded as
        ExportedPredictor.call does (padded mask rows are ones)."""
        parts = []
        for first, k, b in bucket_chunks(len(rows), buckets):
            r = rows[first:first + k]
            pad = b - k
            x = [np.concatenate([a[r], np.full((pad,) + a.shape[1:], fill, a.dtype)])
                 for a, fill in ((images, 0), (ids, 0), (mask, 1))]
            got = fwd(*(torch.from_numpy(a).to(dev) for a in x))
            parts.append({key: v.float().cpu().numpy()[:k] for key, v in got.items()})
        return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}

    problems = []
    for label, fwd, ns, buckets in (("flagship", live, EXPORT_NS, EXPORT_BUCKETS),
                                    ("int8_static", live8, (INT8_EXPORT_BUCKET,),
                                     (INT8_EXPORT_BUCKET,))):
        rep = report[label]
        log(f"export {label}: load {rep['load_s']:.2f} s, memory_allocated after load "
            f"{rep['memory_allocated']} bytes")
        for n in ns:
            rows = export_rows(n)
            got = {key: outs[f"{label}/{n}/{key}"] for key in EX.OUTPUTS}
            want_live = live_padded(fwd, rows, buckets)
            dlive = max(float(np.abs(got[k] - want_live[k]).max()) for k in got)
            cos = cosine(got["joint_emb"], ex["want_joint"][rows])
            dprobs = np.abs(got["probs"] - ex["want_probs"][rows]).max(-1)
            calls = len(bucket_chunks(n, buckets))
            want_l = {k: v * calls for k, v in EXPECTED["whole" if label == "flagship"
                                                          else "int8_static"].items()}
            got_l = {k: v for k, v in rep["launches"][str(n)].items() if k != "plain_calls"}
            log(f"export {label} n={n}: {calls} call(s), {rep['call_s'][str(n)]:.3f} s; vs the "
                f"live forward on the same padded rows max |d| {dlive:.3e}; vs the f32 plain "
                f"path joint_emb cosine min {cos.min():.6f}, max |dprobs| {dprobs.max():.3e}; "
                f"launches {({k: v for k, v in got_l.items() if v})}, plain calls "
                f"{rep['launches'][str(n)]['plain_calls']}")
            if got_l != want_l or rep["launches"][str(n)]["plain_calls"]:
                problems.append(f"export {label} n={n}: launches {got_l}, expected {want_l}")
            if any(got[k].shape[0] != n or not np.isfinite(got[k]).all() for k in got):
                problems.append(f"export {label} n={n}: outputs not finite or of wrong rows")
            if label == "flagship" and not (cos.min() >= EMB_COS_MIN
                                            and dprobs.max() <= PROBS_MAX_DIFF):
                problems.append(f"export flagship n={n}: strays from the f32 plain path")
            if label == "int8_static" and not cos.min() > INT8_COS_MIN:
                problems.append(f"export int8_static n={n}: cosine {cos.min()} against the "
                                "f32 unquantized plain path")
        for b in (EXPORT_TIMED if label == "flagship" else (INT8_EXPORT_BUCKET,)):
            x = [torch.from_numpy(a[export_rows(b)]).to(dev) for a in (images, ids, mask)]
            live_ms = cuda_ms(torch, lambda: fwd(*x), reps=10)
            log(f"export {label}: batch {b} per call {rep['ms'][str(b)]:.3f} ms exported, "
                f"{live_ms:.3f} ms live (CUDA events) [{smi}]")
        launches[f"exported_{label}"] = {k: v for k, v in rep["launches"][
            str(INT8_EXPORT_BUCKET)].items() if k != "plain_calls"}
    if problems:
        fail("; ".join(problems))
    del outs

    # -- (e) one artifact for cuda and cpu, loaded once per platform -------------
    # the card's model exported with platforms=("cuda", "cpu") at bucket 1: each
    # platform's program against the live forward on its device (the cpu one
    # on the card's bf16 weights copied to the CPU) and the f32 plain path,
    # under the bf16 gates; the cuda program launches the live predict's kernels
    t0 = time.perf_counter()
    dual = EX.export_serving_programs(model, image_size=meta["image_size"],
                                      text_len=meta["text_len"], batch_sizes=(1,),
                                      platforms=DUAL_PLATFORMS)
    dual_path = out_dir / "dual.npz"
    EX.save_artifact(dual_path, dual, EX.serving_state(model),
                     dict(meta, batch_sizes=[1], platforms=list(DUAL_PLATFORMS)))
    log(f"export {'+'.join(DUAL_PLATFORMS)} at bucket 1: keys {sorted(dual)}, "
        f"{time.perf_counter() - t0:.1f} s, artifact {dual_path.stat().st_size} bytes")
    del dual
    cpu_model = MultiModalRetrievalModel(model.config, dtype=bf16, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    lives = {"cuda": (live, dev), "cpu": (serving_forward(cpu_model), torch.device("cpu"))}
    for plat in DUAL_PLATFORMS:
        fwd, pdev = lives[plat]
        t0 = time.perf_counter()
        pred = EX.ExportedPredictor.load(dual_path, platform=plat)
        load_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        got = pred.call(*x1)
        call_s = time.perf_counter() - t0
        got_l = read_counts(plain_ok=plat == "cpu")
        with torch.inference_mode():
            want_live = {k: v.float().cpu().numpy()
                         for k, v in fwd(*(torch.from_numpy(a).to(pdev) for a in x1)).items()}
        dlive = max(float(np.abs(got[k] - want_live[k]).max()) for k in got)
        cos_live = float(cosine(got["joint_emb"], want_live["joint_emb"]).min())
        dp_live = float(np.abs(got["probs"] - want_live["probs"]).max())
        cos = float(cosine(got["joint_emb"], ex["want_joint"][:1]).min())
        dprobs = float(np.abs(got["probs"] - ex["want_probs"][:1]).max())
        want_l = EXPECTED["whole"] if plat == "cuda" else ZERO
        log(f"export {plat} program of the {'+'.join(DUAL_PLATFORMS)} artifact: load "
            f"{load_s:.2f} s, call {call_s:.3f} s; vs the live forward on {pdev.type} max |d| "
            f"{dlive:.3e} (cosine {cos_live:.6f}, |dprobs| {dp_live:.3e}); vs the f32 plain path "
            f"cosine {cos:.6f}, |dprobs| {dprobs:.3e}; launches "
            f"{({k: v for k, v in got_l.items() if v})}")
        if not (cos_live >= EMB_COS_MIN and dp_live <= PROBS_MAX_DIFF and cos >= EMB_COS_MIN
                and dprobs <= PROBS_MAX_DIFF):
            problems.append(f"export {plat} program of the dual artifact: strays from the live "
                            "forward or the f32 plain path")
        if got_l != want_l:
            problems.append(f"export {plat} program of the dual artifact: launches {got_l}, "
                            f"expected {want_l}")
        del pred
    if problems:
        fail("; ".join(problems))
    del served, model, cpu_model, lives, live
    gc.collect()
    torch.cuda.empty_cache()

    # -- the W8A8 gradient routes at their phase-3 / 4b shapes ---------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def rnd(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def ln(C):
        return 1 + rnd((C,), 0.1, f32), rnd((C,), 0.1, f32)

    def block(C, heads, res, shift):
        blk = (*ln(C), rnd((3 * C, C), C ** -0.5), rnd((3 * C,), 0.1),
               rnd((C, C), C ** -0.5), rnd((C,), 0.1), *ln(C),
               rnd((4 * C, C), C ** -0.5), rnd((4 * C,), 0.1),
               rnd((C, 4 * C), (4 * C) ** -0.5), rnd((C,), 0.1))
        table = rnd(((2 * 7 - 1) ** 2, heads), 0.5, f32)
        return blk, K1.build_bias_full(table, 7, res, res, shift)

    L, D = ids.shape[1], 768
    key_mask = torch.zeros((B, L), device=dev)
    key_mask[1:, 3 * L // 4:] = -1e9
    w = [t for _ in range(4) for t in (rnd((D, D), D ** -0.5), rnd((D,), 0.1))]
    kw = dict(num_heads=12, ln_mode="post")
    cases = [("fused_attention_int8", f"BERT (8,{L},{D}) post",
              lambda *a: K3.fused_attention(*a, **kw, quant=True),
              lambda *a: K3.attention_plain(*a, **kw, quant=True),
              lambda *a: K3.attention_plain(*a, **kw),
              (rnd((B, L, D)), *ln(D), *w, None, key_mask), {12})]
    for C, heads, res in ((256, 8, 28), (512, 16, 14), (1024, 32, 7)):
        blk, bias = block(C, heads, res, 0)
        nW = (res // 7) ** 2
        cases.append(("fused_swin_block_windows_dynamic", f"xw(8,{nW},49,{C}) h{heads}",
                      lambda *a, h=heads: SB.fused_swin_block_windows(*a, h, quant=True),
                      lambda *a, h=heads: SB.swin_block_plain(*a, h, quant=True),
                      lambda *a, h=heads: SB.swin_block_plain(*a, h),
                      (rnd((B, nW, 49, C)), *blk, bias), set()))
    blk, bias = block(512, 16, 14, 3)
    cases.append(("fused_swin_block_raw_dynamic", "map(8,14,14,512) h16",
                  lambda *a: SB.fused_swin_block_raw(*a, 16, 7, quant=True),
                  lambda *a: SB.raw_plain(*a, num_heads=16, ws=7, quant=True),
                  lambda *a: SB.raw_plain(*a, num_heads=16, ws=7),
                  (rnd((B, 14, 14, 512)), *blk, bias), set()))
    routes = {}
    reset_counts()
    for name, label, call, plain8, plain, tensors, masks in cases:
        leaves = [None if t is None else
                  t.detach().clone().requires_grad_(t.is_floating_point() and i not in masks)
                  for i, t in enumerate(tensors)]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        fn, attr = counters[name]
        n0 = getattr(fn, attr)
        out = call(*leaves)
        launched = getattr(fn, attr) - n0
        with torch.no_grad():
            want8 = plain8(*leaves)
        ref_out = plain(*leaves)
        cot = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        got = torch.autograd.grad(out, wrt, cot)
        want = torch.autograd.grad(ref_out, wrt, cot)
        rel = ((out.detach().float() - want8.float()).abs()
               / want8.float().abs().clamp(min=1)).max().item()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        gdiff = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

        def fwd_bwd(fn=call):
            torch.autograd.grad(fn(*leaves), wrt, cot)

        ms = cuda_ms(torch, fwd_bwd, reps=5, warmup=1)
        plain_ms = cuda_ms(torch, lambda: fwd_bwd(plain), reps=5, warmup=1)
        log(f"gradient route {name:32s} {label:24s} int8 forward max_rel_err {rel:.3e} (tol "
            f"{INT8_TOL:.3e}) against its int8 plain version; {len(wrt)} input gradients "
            f"bit-equal to the unquantized plain route: {equal} (max |d| {gdiff:.3e}), launches "
            f"{launched}; forward + backward {ms:.4f} ms against the all-plain route's "
            f"{plain_ms:.4f} ms [{smi}]")
        if rel > INT8_TOL or not equal or launched != 1:
            problems.append(f"gradient route {name} {label}: max_rel_err {rel}, gradients "
                            f"equal {equal}, launches {launched}")
        agg = routes.setdefault(name, dict(cases=0, max_rel_err=0.0, max_grad_diff=0.0,
                                           grads_bit_equal=True, ms=0.0, plain_ms=0.0))
        agg.update(cases=agg["cases"] + 1, max_rel_err=max(agg["max_rel_err"], rel),
                   max_grad_diff=max(agg["max_grad_diff"], gdiff),
                   grads_bit_equal=agg["grads_bit_equal"] and equal,
                   ms=agg["ms"] + ms, plain_ms=agg["plain_ms"] + plain_ms)
        del leaves, wrt, out, ref_out, got, want, want8
    read_counts()
    if problems:
        fail("; ".join(problems))

    # -- the dispatcher's host cost, which the eager path skips ---------------------
    # one K3 call at the BERT layer's shape of a batch-8 L64 predict, host time
    # per call through torch.ops.mmrp.seq_attention and through its launch
    # function directly (the queue never fills: 600 launches)
    x, (ln_s, ln_b) = rnd((B, 64, D)), ln(D)
    args = (x, ln_s, ln_b, *w, None, None, None, None, [])
    k3 = dict(num_heads=12, ln_mode="post", include_residual=True, residual_from_raw=False,
              eps=1e-6, quant=False)

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    with torch.inference_mode():
        turns = [(host_us(lambda: torch.ops.mmrp.seq_attention(*args, **k3)),
                  host_us(lambda: K3._launch(*args, **k3))) for _ in range(3)]
    log(f"host time per K3 call (batch 8, L64): through the dispatcher "
        f"{[round(a, 1) for a, _ in turns]} us, the launch function directly "
        f"{[round(b, 1) for _, b in turns]} us [{smi}]")
    # -- (d) explain over the int8 mixes -------------------------------------------
    # predict(explain=True) on the card; then the engine's maps of the first
    # EXPLAIN_INT8_TARGETS targets (IG at the request's 50 steps), token IG and
    # pixel IG against the same mix in f32 on the CPU; a map that
    # misses the gate is held to twice the distance of the farthest map of
    # its kind of the plain versions in bf16 on the card (every call site of
    # the same weights on its plain version); the attention maps are printed
    # for information
    for mix in INT8_EXPLAIN_MIXES:
        m = ex["int8"][mix]
        pred = MMRPredictor(m, LABEL_COLS)
        reset_counts()
        t0 = time.perf_counter()
        pred_x = pred.predict(*x1, explain=True)
        launches[f"explain_{mix}"] = read_counts()
        targets = list(pred_x["explanation"]["per_target"])
        log(f"explain {mix}: predict(explain=True), batch 1, L{ids.shape[1]}, {len(targets)} "
            f"targets, {EXPLAIN_STEPS} IG steps: {time.perf_counter() - t0:.3f} s (host "
            f"clock) [{smi}]; launches "
            f"{ {k: v for k, v in launches[f'explain_{mix}'].items() if v} }")
        if len(targets) != 5:
            fail(f"explain {mix}: {len(targets)} targets")
        for t, maps in pred_x["explanation"]["per_target"].items():
            for key, mp in maps.items():
                if mp.shape != (1, 224, 224) or not np.isfinite(mp).all():
                    fail(f"explain {mix}: target {t} {key}: shape {mp.shape} or not finite")
        cmp_t = targets[:EXPLAIN_INT8_TARGETS]
        static = mix == "int8_static"
        plain = plain_copy(m)
        reset_counts()
        plain16 = maps_of(ExplanationEngine(plain), cmp_t, not static)
        plain_launches = {k: v for k, v in read_counts(plain_ok=True).items() if v}
        if plain_launches:
            fail(f"explain {mix}: the all-plain copy launched {plain_launches}")
        got = maps_of(pred.explainer, cmp_t, not static)
        t0 = time.perf_counter()
        ref = MultiModalRetrievalModel(m.config, dtype=f32, device="cpu").eval()
        ref.load_state_dict({k: v.float().cpu() for k, v in m.state_dict().items()})
        want = maps_of(ExplanationEngine(ref), cmp_t, not static)
        log(f"explain {mix}: the f32 plain path's maps on the CPU: "
            f"{time.perf_counter() - t0:.1f} s")

        kinds = {}  # map kind -> [(what, card vs f32, plain bf16 vs f32, gate met)]

        def hold(what, kind, pick):
            """A map of the card against the f32 plain path: Pearson >=
            MAP_PEARSON_MIN and IoU@20% >= MAP_IOU_MIN, else judged with its
            kind below; a Grad-CAM map flat on the CPU must be flat on the card.
            kind None: printed for information."""
            got_m, want_m, p16 = (np.asarray(pick(d)) for d in (got, want, plain16))
            if kind == "grad_cam" and np.ptp(want_m) <= 0:
                log(f"explain {mix} {what}: flat on the CPU, on the card flat: "
                    f"{np.ptp(got_m) <= 0}")
                if np.ptp(got_m) > 0:
                    problems.append(f"explain {mix} {what}: flat on the CPU, not on the card")
                return
            cmp, pf, kp = (compare_maps(a, b) for a, b in ((got_m, want_m), (p16, want_m),
                                                           (got_m, p16)))
            met = cmp["pearson"] >= MAP_PEARSON_MIN and cmp["iou@20%"] >= MAP_IOU_MIN
            log(f"explain {mix} {what}: pearson {cmp['pearson']:.5f}, iou@20% "
                f"{cmp['iou@20%']:.3f} against f32 (gate {MAP_PEARSON_MIN} / {MAP_IOU_MIN}: "
                f"{met}); the plain bf16 path on the card {pf['pearson']:.5f} / "
                f"{pf['iou@20%']:.3f}; the card against that path {kp['pearson']:.5f} / "
                f"{kp['iou@20%']:.3f}" + ("" if kind else " (for information)"))
            if kind:
                kinds.setdefault(kind, []).append((what, cmp, pf, met))

        hold("attn_final", None, lambda d: d["attention"]["attn_final"])
        for t in cmp_t:
            for key in ("ig", "grad_cam"):
                hold(f"target {t} {key}", key, lambda d, t=t, key=key: d["per_target"][t][key])
        hold("token_attribution", "token_attribution", lambda d: d["token"])
        if static:
            try:
                pred.explainer.integrated_gradients_pixels(*x1, cmp_t[0], n_steps=1)
            except RuntimeError as e:
                log(f"explain {mix} integrated_gradients_pixels raises, as JAX's jax.grad: {e}")
                if "static W8A8 block has no gradient" not in str(e):
                    problems.append(f"explain {mix}: pixel IG raised another error: {e}")
            else:
                problems.append(f"explain {mix}: pixel IG over the static Swin did not raise")
        else:
            hold("integrated_gradients_pixels", "integrated_gradients_pixels",
                 lambda d: d["pixels"])
        # a map that misses the gate: no more than ATTN_BF16_FACTOR times as far
        # from f32 (1 - Pearson, 1 - IoU@20%) as the farthest map of its kind
        # of the plain versions in bf16 on the card: at the int8 mixes a map's
        # distance from f32 is the noise of int8 steps that bf16 inputs flip,
        # which one map of one path samples once
        for kind, rows in kinds.items():
            far_p = max(1 - pf["pearson"] for _, _, pf, _ in rows)
            far_i = max(1 - pf["iou@20%"] for _, _, pf, _ in rows)
            for what, cmp, _, met in rows:
                near = (1 - cmp["pearson"] <= ATTN_BF16_FACTOR * far_p
                        and 1 - cmp["iou@20%"] <= ATTN_BF16_FACTOR * far_i)
                if not met:
                    log(f"explain {mix} {what}: 1 - pearson {1 - cmp['pearson']:.5f}, 1 - "
                        f"iou@20% {1 - cmp['iou@20%']:.3f} against {ATTN_BF16_FACTOR}x the "
                        f"plain bf16 path's farthest {kind} map ({far_p:.5f}, {far_i:.3f}): "
                        f"{'within' if near else 'beyond'}")
                if not (met or near):
                    problems.append(f"explain {mix} {what}: {cmp}")
        del ref, plain, pred, got, want, plain16
        gc.collect()
        torch.cuda.empty_cache()
    if problems:
        fail("; ".join(problems))
    return launches, routes


def export_alone(torch, dev, root: Path) -> tuple:
    """Phase 11's inputs for ``--export-only``, made as phases 4, 4b and 4c
    make them: the flagship from the seeded init, 8 seeded requests at L512
    and their f32 plain path on the CPU, a run directory of its weights, and
    the int8 mixes (act_amax calibrated on the requests). Returns (run, ex)."""
    import numpy as np

    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.models.quant_calib import calibrate_swin_act_amax, save_act_amax
    from mmrp_tpu_torch.utils.convert import init_params, save_param_tree, state_dict_to_flax_flat

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = MultiModalConfig.flagship()
    model = MultiModalRetrievalModel(cfg, dtype=bf16, device=dev).eval()
    init_params(model, seed=SEED)
    r = np.random.default_rng(SEED)
    L = RUN_TEXT_LEN
    images = r.random((B, cfg.swin.img_size, cfg.swin.img_size, 3), dtype=np.float32)
    ids = r.integers(0, cfg.text.vocab_size, (B, L)).astype(np.int64)
    lengths = np.concatenate([[L], r.integers(4, L, B - 1)])
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int64)
    ref = MultiModalRetrievalModel(cfg, dtype=f32, device="cpu").eval()
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    want = serving_forward(ref)(*(torch.from_numpy(a) for a in (images, ids, mask)))
    del ref
    run = root / "run"
    (run / "joint").mkdir(parents=True)
    (run / "config.yaml").write_text(
        "image_backbone: swin\nimage_size: 224\njoint_dim: 1024\nnum_fusion_layers: 5\n"
        "num_heads: 8\ntext_dim: 512\nserve_quant: none\ndtype_policy: bf16\n")
    text_dims = {k: v for k, v in dataclasses.asdict(cfg.text).items() if k != "quant"}
    (run / "model_config.json").write_text(json.dumps(
        {"flagship": True, "vision_backbone": "swin", "text": text_dims}))
    (run / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"w{i}" for i in range(cfg.text.vocab_size - 5)]) + "\n")
    save_param_tree(run / "joint" / "params.npz",
                    {f"model/{k}": v for k, v in state_dict_to_flax_flat(model).items()})
    amax_path = root / "swin_act_amax.json"
    save_act_amax(str(amax_path), calibrate_swin_act_amax(model.backbones.swin, images,
                                                          batch_size=B))
    int8 = {}
    for mix, kw in (("int8", {}), ("int8_static", dict(swin_act_amax_path=str(amax_path)))):
        int8[mix] = MultiModalRetrievalModel(MultiModalConfig.from_config(
            Config(serve_quant=mix, **kw), flagship=True), dtype=bf16, device=dev).eval()
        int8[mix].load_state_dict(model.state_dict())
    return run, dict(images=images, ids=ids, mask=mask, want_joint=want["joint_emb"].numpy(),
                     want_probs=want["probs"].numpy(), int8=int8)


# phase 12, the mesh on one card: a one-rank NCCL group and its dp mesh
# (parallel/), then each mesh path against its single-device run on the same
# inputs: the flagship data-parallel train step (phase 7's construction, batch
# 64, L64, MESH_STEPS steps, bit-equal), the sharded engine over a gallery of
# phase 4c's size, entity-sharded KG eval on phase 8's graph, the mesh stream
# (batch 64, L512, 4 batches), a world-1 data-parallel artifact at bucket 8;
# then dryrun_multichip(4) over gloo on the machine's CPU
MESH_STEPS = 6  # every step held bit for bit; the medians skip the first
MESH_GALLERY = 100_008
MESH_ART_BUCKET = 8
MESH_TIMED = 5  # rounds of the 8 requests timed on each engine


def mesh_phase(torch, dev, smi: str, train_ms=None) -> dict:
    """Phase 12 (module docstring). ``train_ms``: phase 7's median step, for
    the print. Returns the launches of a dp step and a mesh stream batch."""
    import numpy as np
    import torch.distributed as dist

    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.kg import trainer as kg_trainer
    from mmrp_tpu_torch.kg.sharded_eval import evaluate_sharded
    from mmrp_tpu_torch.labels import LABEL_COLS
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.ops import wattn_core as WC
    from mmrp_tpu_torch.ops import window_attention as WA
    from mmrp_tpu_torch.parallel import mesh as M
    from mmrp_tpu_torch.parallel.collectives import initialize_distributed
    from mmrp_tpu_torch.parallel.dryrun import dryrun_multichip, free_port
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
    from mmrp_tpu_torch.serve import exported as EX
    from mmrp_tpu_torch.serve.stream import StreamingPipeline
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step, make_train_step_dp
    from mmrp_tpu_torch.train.pipeline import device_batch
    from mmrp_tpu_torch.utils.convert import init_params

    bf16 = torch.bfloat16
    counters = {**serving_counters(), "wattn_core_fwd": (WC.core_forward, "launches"),
                "wattn_core_bwd": (WC.core_backward, "launches"),
                "window_attention_heads": (WA.window_attention_heads, "launches")}
    wrappers = {fn for fn, _ in counters.values()} | {WC.window_attention_core}
    zero = {name: 0 for name in counters}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        for fn in wrappers:
            fn.plain_calls = 0

    def read_counts():
        plain = {fn.__name__: fn.plain_calls for fn in wrappers if fn.plain_calls}
        if plain:
            fail(f"mesh: calls on a plain route: {plain}")
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    def phase_clock(label, t0):
        log(f"mesh {label}: {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    # -- (a) the group and the mesh ---------------------------------------------
    t0 = time.perf_counter()
    if not initialize_distributed(f"localhost:{free_port()}", 1, 0, timeout_s=300):
        fail("mesh: initialize_distributed did not start a group")
    if dist.get_backend() != "nccl":
        fail(f"mesh: backend {dist.get_backend()}, expected nccl")
    mesh = M.build_mesh(("dp",))
    log(f"mesh: {dist.get_backend()} world {dist.get_world_size()}, mesh "
        f"{dict(M.mesh_shape(mesh))} on {M.mesh_device(mesh)}")
    launches = {}
    try:
        # -- (b) the data-parallel train step against make_train_step ------------
        cfg = MultiModalConfig.flagship()
        tcfg = Config(lr=TRAIN_LR, seed=SEED)
        rng = np.random.default_rng(SEED + 12)
        L = 64
        lengths = np.concatenate([[L], rng.integers(4, L, TRAIN_B - 1)])
        batch_np = {
            "image": rng.random((TRAIN_B, 224, 224, 3), dtype=np.float32),
            "input_ids": rng.integers(0, cfg.text.vocab_size, (TRAIN_B, L)).astype(np.int64),
            "attention_mask": (np.arange(L)[None, :] < lengths[:, None]).astype(np.int64),
            "labels": (rng.random((TRAIN_B, cfg.num_classes)) < 0.3).astype(np.float32),
            "kg_target": rng.standard_normal((TRAIN_B, KG_DIM)).astype(np.float32),
            "kg_target_valid": np.ones(TRAIN_B, np.float32),
        }
        # deterministic algorithms for both runs (the relative-bias tables' gather
        # backward accumulates with atomics otherwise), so that the two runs can
        # be held bit for bit; the step times are taken under it
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs = {}
        for label in ("plain", "dp"):
            m = MultiModalRetrievalModel(cfg, dtype=bf16, device=dev)
            init_params(m, seed=SEED)
            state = init_train_state(m, tcfg, seed=SEED, total_steps=TRAIN_WARMUP + TRAIN_TIMED,
                                     kg_dim=KG_DIM)
            pw = np.ones(cfg.num_classes, np.float32)
            if label == "plain":
                step, rows = make_train_step(m, tcfg, pos_weight=pw), batch_np
            else:
                step = make_train_step_dp(m, tcfg, mesh, pos_weight=pw)
                rows = {k: M.rows_of(v, mesh) for k, v in batch_np.items()}
            runs[label] = dict(model=m, state=state, step=step, batch=device_batch(rows, dev),
                               losses=[], ms=[], counts=[])
        for _ in range(MESH_STEPS):  # in turns, so that both see the same clock
            for run in runs.values():
                reset_counts()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                run["state"], metrics = run["step"](run["state"], run["batch"])
                ev[1].record()
                ev[1].synchronize()
                run["ms"].append(ev[0].elapsed_time(ev[1]))
                run["counts"].append(read_counts())
                run["losses"].append(metrics["loss/total"])
        torch.use_deterministic_algorithms(False)
        plain, dp = runs["plain"], runs["dp"]
        differ = [k for k in plain["state"].params
                  if not torch.equal(plain["state"].params[k], dp["state"].params[k])]
        l_plain, l_dp, c_dp = plain["losses"], dp["losses"], dp["counts"]
        log(f"mesh dp step (batch {TRAIN_B}, L{L}, {MESH_STEPS} steps, deterministic "
            f"algorithms): losses {l_dp} against make_train_step {l_plain}; masters bit-equal "
            f"{not differ} ({len(dp['state'].params)} tensors); step ms "
            f"{[round(t, 2) for t in dp['ms']]} against {[round(t, 2) for t in plain['ms']]}, "
            f"medians after the first {statistics.median(dp['ms'][1:]):.2f} against "
            f"{statistics.median(plain['ms'][1:]):.2f} (phase 7's median "
            f"{'not run' if train_ms is None else f'{train_ms:.2f}'}) [{smi}]")
        want_step = {**zero, **EXPECTED_TRAIN}
        for i, c in enumerate(c_dp):
            if c != want_step:
                fail(f"mesh dp step {i + 1}: launches {c}, expected {want_step}")
        log(f"mesh dp step: launches a step {({k: v for k, v in c_dp[-1].items() if v})}, "
            "plain core calls 0, every step")
        if l_dp != l_plain or differ:
            fail(f"mesh dp step: not bit-equal to make_train_step (losses {l_dp} vs {l_plain}; "
                 f"masters that differ: {differ[:5]})")
        launches["mesh_dp_step"] = c_dp[-1]
        model = dp["model"].eval()
        del runs, plain, dp
        gc.collect()
        torch.cuda.empty_cache()
        t0 = phase_clock("(a, b) group and dp step", t0)

        # -- (c) the sharded engine against the single-device engine ------------
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        gallery = torch.randn((MESH_GALLERY, cfg.joint_dim), generator=gen,
                              device=dev).cpu().numpy()
        gallery_ids = [f"g{i}" for i in range(MESH_GALLERY)]
        queries = np.concatenate([gallery[[5, 77, 100_007, 4_242]],
                                  rng.standard_normal((B - 4, cfg.joint_dim))]).astype(np.float32)
        single = RetrievalEngine(gallery, gallery_ids, device=dev)
        sharded = RetrievalEngine(gallery, gallery_ids, mesh=mesh)
        for q in queries:
            (s1, i1), (s2, i2) = (e.retrieve_batch(q[None], 10) for e in (single, sharded))
            if not (np.array_equal(i1, i2) and np.array_equal(s1, s2)):
                fail(f"mesh engine: ids {i2[0].tolist()} / scores differ from the single "
                     f"engine's {i1[0].tolist()}")
        p50 = {}
        for label, e in (("single", single), ("sharded", sharded)):
            lat = []
            for _ in range(MESH_TIMED):
                for q in queries:
                    t1 = time.perf_counter()
                    e.retrieve(q, K=10)
                    lat.append((time.perf_counter() - t1) * 1e3)
            p50[label] = statistics.median(lat)
        log(f"mesh engine over {MESH_GALLERY} x {cfg.joint_dim}: {B} requests, ids and scores "
            f"equal to the single engine's; top-10 p50 {p50['sharded']:.3f} ms sharded, "
            f"{p50['single']:.3f} ms single (host clock) [{smi}]")
        t0 = phase_clock("(c) engine", t0)

        # -- (d) entity-sharded KG evaluation on phase 8's graph ------------------
        r = np.random.default_rng(SEED + 9)
        trip = np.stack([r.integers(0, KG_ENTITIES, KG_TRIPLES),
                         r.integers(0, KG_RELATIONS, KG_TRIPLES),
                         r.integers(0, KG_ENTITIES, KG_TRIPLES)], 1)
        kgt = kg_trainer.KGTrainer(KG_ENTITIES, KG_RELATIONS, kg_trainer.KGTrainerConfig(
            model="TransE", emb_dim=KG_DIM, neg_size=KG_NEG, batch_size=KG_BATCH, epochs=1,
            use_bf16=True, seed=SEED), device=dev)
        kgt.load_triples(trip.tolist())
        t1 = time.perf_counter()
        ref = kgt.evaluate(kgt.val_arr)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        got = evaluate_sharded(kgt, kgt.val_arr, mesh)
        sh_s = time.perf_counter() - t1
        log(f"mesh KG eval ({KG_ENTITIES} entities, {len(kgt.val_arr)} val triples): sharded "
            f"{got} in {sh_s:.2f} s; evaluate {ref} in {ref_s:.2f} s [{smi}]")
        if got != ref:
            fail("mesh KG eval: evaluate_sharded differs from KGTrainer.evaluate")
        del kgt, trip
        t0 = phase_clock("(d) KG eval", t0)

        # -- (e) the mesh stream against the stream without a mesh ----------------
        threshold = np.full(cfg.num_classes, 0.5, np.float32)
        batches = []
        for bi in range(STREAM_BATCHES):
            lengths = np.concatenate([[RUN_TEXT_LEN], rng.integers(4, RUN_TEXT_LEN,
                                                                   STREAM_B - 1)])
            valid = np.ones(STREAM_B, np.float32)
            if bi == STREAM_BATCHES - 1:
                valid[-STREAM_PAD:] = 0
            batches.append({
                "image": rng.integers(0, 256, (STREAM_B, 224, 224)).astype(np.uint8),
                "input_ids": rng.integers(5, cfg.text.vocab_size, (STREAM_B, RUN_TEXT_LEN)),
                "attention_mask": (np.arange(RUN_TEXT_LEN)[None, :]
                                   < lengths[:, None]).astype(np.int64),
                "valid": valid, "ids": [f"s{bi * STREAM_B + j}" for j in range(STREAM_B)]})
        rows = {}
        for label, m_, eng in (("single", None, single), ("mesh", mesh, sharded)):
            pipe = StreamingPipeline(model, eng, LABEL_COLS, threshold, K=10, mesh=m_)
            reset_counts()
            rows[label] = list(pipe.run(batches))
            counts_ = read_counts()
            stats = pipe.stats
            log(f"mesh stream {label}: {stats['pairs']} pairs, {stats['pairs_per_sec']:.1f} "
                f"pairs/s (host clock), mesh {stats['mesh']}, launches per batch "
                f"{({k: v // STREAM_BATCHES for k, v in counts_.items() if v})}")
            want_b = {k: v * STREAM_BATCHES for k, v in EXPECTED["whole"].items()}
            if counts_ != {**zero, **want_b}:
                fail(f"mesh stream {label}: launches {counts_}, expected {want_b}")
            if label == "mesh":
                launches["mesh_stream_batch"] = {k: v // STREAM_BATCHES for k, v in
                                                 counts_.items()}
        for a_, b_ in zip(rows["single"], rows["mesh"]):
            same = (np.array_equal(a_["probs"], b_["probs"])
                    and np.array_equal(a_["joint_emb"], b_["joint_emb"])
                    and a_["ids"] == b_["ids"] and a_["predicted"] == b_["predicted"]
                    and a_["retrieval"] == b_["retrieval"])
            if not same:
                fail("mesh stream: rows differ from the stream without a mesh")
        log(f"mesh stream: {STREAM_BATCHES} batches of {STREAM_B} at L{RUN_TEXT_LEN}, rows equal "
            "to the stream without a mesh (probs, joint_emb, labels, ids, top-10)")
        del rows, batches, single, sharded, gallery
        gc.collect()
        torch.cuda.empty_cache()
        t0 = phase_clock("(e) stream", t0)

        # -- (f) a world-1 data-parallel artifact against the single-device one ----
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(image_size=224, text_len=RUN_TEXT_LEN, batch_sizes=(MESH_ART_BUCKET,),
                      platforms=("cuda",))
            paths = {}
            for label, m_ in (("single", None), ("mesh", mesh)):
                progs = EX.export_serving_programs(model, mesh=m_, **kw)
                paths[label] = Path(tmp) / f"{label}.npz"
                EX.save_artifact(paths[label], progs, EX.serving_state(model), {})
                log(f"mesh artifact {label}: keys {sorted(progs)}")
            x = (rng.random((MESH_ART_BUCKET, 224, 224, 3), dtype=np.float32),
                 rng.integers(5, cfg.text.vocab_size, (MESH_ART_BUCKET, RUN_TEXT_LEN)),
                 np.ones((MESH_ART_BUCKET, RUN_TEXT_LEN), np.int64))
            outs = {}
            for label, m_ in (("single", None), ("mesh", mesh)):
                pred = EX.ExportedPredictor.load(paths[label], platform="cuda", mesh=m_)
                outs[label] = pred.call(*x)
                del pred
        with torch.inference_mode():
            live = {k: v.float().cpu().numpy() for k, v in serving_forward(model)(
                *(torch.from_numpy(a).to(dev) for a in x)).items()}
        dlive = max(float(np.abs(outs["mesh"][k] - live[k]).max()) for k in live)
        equal = all(np.array_equal(outs["mesh"][k], outs["single"][k]) for k in outs["single"])
        log(f"mesh artifact at bucket {MESH_ART_BUCKET}: outputs equal to the single-device "
            f"artifact's {equal}; max |d| from the live forward {dlive:.3e}")
        if not equal:
            fail("mesh artifact: the world-1 data-parallel artifact differs from the "
                 "single-device artifact")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = phase_clock("(f) artifact", t0)

        # -- (g) several ranks over gloo on the CPU -------------------------------
        res = dryrun_multichip(4, backend="gloo", timeout_s=300)
        if not res["line"].endswith(" OK") or not res.get("tp_checked"):
            fail(f"mesh dryrun_multichip(4): {res}")
        phase_clock("(g) dryrun_multichip(4) over gloo", t0)
    finally:
        dist.destroy_process_group()
    return launches


# phase 3b: K3's packed form at the stream's lengths (the benchmark's
# stream-openi traffic: log-normal valid lengths, mean 38.7, sigma 0.6, 4 to
# 512, padded to 512); 3 stream batches of the flagship
PACKED_B, PACKED_L, PACKED_BATCHES = 64, 512, 3
PACKED_MEAN, PACKED_SIGMA = 38.7, 0.6
# packed K3 launches a stream batch: 12 BERT layers and, in each of the 5
# fusion layers, the text enhancer, text -> image and image -> text (the
# image enhancer and the fusion self-attention run padded: 10 more launches)
PACKED_PER_BATCH, K3_PER_BATCH = 27, 37


def stream_lengths(rng, B: int = PACKED_B):
    """B valid lengths as the stream's traffic draws them: the quantiles (i +
    0.5) / 1024 of its log-normal, rounded and clipped to [4, 512], the
    longest among them and the rest drawn from the 1,024."""
    import numpy as np

    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / 1024) for i in range(1024)])
    L = np.exp(np.log(PACKED_MEAN) - PACKED_SIGMA ** 2 / 2 + PACKED_SIGMA * z)
    L = np.clip(np.rint(L), 4, PACKED_L).astype(np.int64)
    rest = rng.choice(np.delete(L, L.argmax()), B - 1, replace=False)
    return rng.permutation(np.concatenate([[L.max()], rest]))


def packed_phase(torch, dev, smi: str) -> dict:
    """Phase 3b (module docstring): returns the kernel record of
    ``fused_attention_packed``."""
    import numpy as np

    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.labels import LABEL_COLS
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.ops import fused_attention as K3
    from mmrp_tpu_torch.serve.stream import StreamingPipeline
    from mmrp_tpu_torch.utils import trace
    from mmrp_tpu_torch.utils.convert import init_params

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)

    def rnd(shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    lengths = stream_lengths(rng)
    rows = K3.pack(lengths, PACKED_L, dev)
    T, B, L = rows.T, PACKED_B, PACKED_L
    valid = torch.arange(L, device=dev)[None, :] < torch.from_numpy(lengths).to(dev)[:, None]
    key_mask = torch.where(valid, 0.0, -1e9).to(f32)
    lq2 = int((lengths.astype(np.int64) ** 2).sum())
    log(f"packed K3 at the stream's lengths: batch {B}, T {T} of {B * L} rows "
        f"({T / (B * L):.4f}), longest {rows.max_len}, mean {lengths.mean():.1f} [{smi}]")
    alpha = torch.tensor(0.5, device=dev)
    # (label, C, heads, ln_mode, packed side, pos + alpha); txt2img and
    # img2txt against the 49 patches
    forms = (("bert", 768, 12, "post", "self", False), ("txt_enh", 1024, 8, "pre", "self", True),
             ("txt2img", 1024, 8, "post", "q", False), ("img2txt", 1024, 8, "post", "kv", False))
    agg = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, padded_ms=0.0, device_ms=0.0,
               bound_ms=0.0, flop_ms=0.0, byte_ms=0.0)
    problems, by_form = [], {}
    with torch.inference_mode():
        for label, C, heads, mode, side, enh in forms:
            w = []
            for _ in range(4):
                w += [rnd((C, C), C ** -0.5), rnd((C,), 0.1)]
            ln = (1 + rnd((C,), 0.1, f32), rnd((C,), 0.1, f32))
            pos = rnd((L, C), 0.5) if enh else None
            common = dict(pos=pos, alpha=alpha if enh else None, num_heads=heads, ln_mode=mode,
                          include_residual=side == "self", residual_from_raw=enh)
            x_pad = rnd((B, L if side != "kv" else 49, C))
            kv_pad = None if side == "self" else rnd((B, 49 if side == "q" else L, C))
            if side == "self":
                x, kw = x_pad[valid].contiguous(), dict(common, rows=rows)
                pad_kw = dict(common, key_mask=key_mask)
                flops, shape = 8 * T * C * C + 4 * lq2 * C, (T, C)
            elif side == "q":
                x, kw = x_pad[valid].contiguous(), dict(common, kv=kv_pad, rows=rows)
                pad_kw = dict(common, kv=kv_pad)
                flops, shape = 4 * T * C * C + 4 * B * 49 * C * C + 4 * T * 49 * C, (T, C)
            else:
                x = x_pad
                kw = dict(common, kv=kv_pad[valid].contiguous(), kv_rows=rows)
                pad_kw = dict(common, kv=kv_pad, key_mask=key_mask)
                flops, shape = 4 * B * 49 * C * C + 4 * T * C * C + 4 * 49 * T * C, (B, 49, C)
            args = (x, *ln, *w)
            pad_args = (x_pad, *ln, *w)

            def kern(a=args, k=kw):
                return K3.fused_attention_packed(*a, **k)

            def plain(a=args, k=kw):
                return K3.attention_plain_packed(*a, **k)

            def padded(a=pad_args, k=pad_kw):
                return K3.fused_attention(*a, **k)

            K3.fused_attention.launches = K3.fused_attention.launches_packed = 0
            got = kern()
            torch.cuda.synchronize()
            if (K3.fused_attention.launches, K3.fused_attention.launches_packed) != (1, 1):
                problems.append(f"packed {label}: launches {K3.fused_attention.launches}, "
                                f"packed {K3.fused_attention.launches_packed}, expected 1, 1")
            want = plain()
            pad_out = padded()
            pad_rows = pad_out[valid] if side != "kv" else pad_out
            if got.shape != want.shape or got.shape != shape or not torch.isfinite(got).all():
                fail(f"packed {label}: non-finite output or shape {tuple(got.shape)}")
            ref = want.float().abs().clamp(min=1.0)
            d = (got.float() - want.float()).abs()
            err, rel = d.max().item(), (d / ref).max().item()
            d_pad = (got.float() - pad_rows.float()).abs()
            ms, plain_ms, pad_ms = (cuda_ms(torch, f) for f in (kern, plain, padded))
            dev_ms = sum(device_ms_by_kernel(torch, kern).values())
            nbytes = tensor_bytes(torch, args, kw) + tensor_bytes(torch, got)
            flop_ms, byte_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            n_cuda = cuda_launches(torch, kern)
            log(f"kernel fused_attention_packed {label:8s} (T {T}, C {C}, h{heads}, {mode}, "
                f"packed {side}) max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol "
                f"{KERNEL_TOL:.3e}); vs the padded form's valid rows max {d_pad.max().item():.3e}"
                f", {int((d_pad > 0).sum().item())} of {d_pad.numel()} apart  kernel {ms:.4f} ms"
                f"  device {dev_ms:.4f} ms  plain {plain_ms:.4f} ms  padded form at L{L} "
                f"{pad_ms:.4f} ms  bound {max(flop_ms, byte_ms):.4f} ms ({flops / 1e9:.2f} "
                f"GFLOP, {nbytes / 1e6:.2f} MB)  CUDA launches per call {n_cuda}")
            if rel > KERNEL_TOL:
                problems.append(f"packed {label}: max_rel_err {rel} against its plain version")
            if (d_pad / pad_rows.float().abs().clamp(min=1.0)).max().item() > KERNEL_TOL:
                problems.append(f"packed {label}: strays from the padded form's valid rows")
            calls = 12 if label == "bert" else 5
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("padded_ms", pad_ms),
                             ("device_ms", dev_ms), ("flop_ms", flop_ms), ("byte_ms", byte_ms),
                             ("bound_ms", max(flop_ms, byte_ms))):
                agg[key] += calls * val
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            by_form[label] = dict(calls=calls, ms=ms, device_ms=dev_ms, padded_ms=pad_ms,
                                  bound_ms=max(flop_ms, byte_ms), cuda_launches_per_call=n_cuda)
            del args, pad_args, kw, pad_kw, got, want, pad_out, x_pad, kv_pad, w
    if problems:
        fail("; ".join(problems))

    # -- the flagship's stream over batches at these lengths ----------------------
    cfg = MultiModalConfig.flagship()
    model = MultiModalRetrievalModel(cfg, dtype=bf16, device=dev).eval()
    init_params(model, seed=SEED)
    batches = []
    for _ in range(PACKED_BATCHES + 1):
        n = stream_lengths(rng)
        batches.append({
            "image": rng.integers(0, 256, (B, 224, 224)).astype(np.uint8),
            "input_ids": rng.integers(5, cfg.text.vocab_size, (B, L)),
            "attention_mask": (np.arange(L)[None, :] < n[:, None]).astype(np.int64)})
    threshold = np.full(cfg.num_classes, 0.5, np.float32)
    pipe = StreamingPipeline(model, None, LABEL_COLS, threshold)
    list(pipe.run(batches[:1]))  # warm
    torch.cuda.synchronize()
    K3.fused_attention.launches = K3.fused_attention.launches_packed = 0
    before = trace.counters()
    res = list(pipe.run(batches[1:]))
    torch.cuda.synchronize()
    grown = {k: v - before.get(k, 0) for k, v in trace.counters().items()
             if v != before.get(k, 0)}
    n_b = PACKED_BATCHES
    launches = (K3.fused_attention.launches, K3.fused_attention.launches_packed)
    log(f"stream batch {B}, L{L}, {n_b} batches: K3 launches {launches[0]}, packed "
        f"{launches[1]} ({launches[1] // n_b} of {launches[0] // n_b} a batch); counters "
        f"{grown}; rows run {grown.get('text.rows', 0) / max(grown.get('text.rows_padded', 1), 1):.4f}"
        " of the padded route's")
    if launches != (K3_PER_BATCH * n_b, PACKED_PER_BATCH * n_b):
        fail(f"stream: K3 launches {launches}, expected {K3_PER_BATCH * n_b} with "
             f"{PACKED_PER_BATCH * n_b} packed")
    if grown.get("text.packed") != n_b or grown.get("text.padded") or grown.get("host_reads"):
        fail(f"stream: text route counters {grown}: expected text.packed {n_b}, no padded "
             "forward and no host read")
    fwd = serving_forward(model)
    worst_cos, worst_dp = 1.0, 0.0
    for batch, got in zip(batches[1:], res):
        img = ((batch["image"].astype(np.float32) / 255.0 - 0.5) / 0.5)[..., None].repeat(3, -1)
        want = fwd(torch.from_numpy(img).to(dev), torch.from_numpy(batch["input_ids"]).to(dev),
                   torch.from_numpy(batch["attention_mask"]).to(dev))
        wj = want["joint_emb"].float().cpu().numpy()
        cos = (got["joint_emb"] * wj).sum(-1) / (np.linalg.norm(got["joint_emb"], axis=-1)
                                                 * np.linalg.norm(wj, axis=-1))
        worst_cos = min(worst_cos, float(cos.min()))
        worst_dp = max(worst_dp, float(np.abs(got["probs"] - want["probs"].float().cpu()
                                              .numpy()).max()))
    log(f"stream packed against the padded route: joint_emb cosine min {worst_cos:.7f} (>= "
        f"{EMB_COS_MIN}), max |dprobs| {worst_dp:.3e} (<= {PROBS_MAX_DIFF})")
    if worst_cos < EMB_COS_MIN or worst_dp > PROBS_MAX_DIFF:
        fail("stream: the packed route strays from the padded route")
    del model, pipe, res, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "fused_attention_packed", "route": "cuda",
            "source": "mmrp_tpu_torch/csrc/seq_attention.cu",
            "replaces": "mmrp_tpu/ops/fused_attention.py:299",
            "launches": PACKED_PER_BATCH, "per": "stream batch", "path": "stream",
            "text_rows": T, "text_rows_padded": B * L, **agg, "by_form": by_form,
            "bound_by": "operations" if agg["flop_ms"] >= agg["byte_ms"] else "bytes"}


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
        from mmrp_tpu_torch.data import native
        from mmrp_tpu_torch.data.dicom import DICOMImagePreprocessor, read_dicom, write_dicom
        from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer
        from mmrp_tpu_torch.labels import LABEL_COLS
        from mmrp_tpu_torch.models.multimodal import (
            MultiModalConfig,
            MultiModalRetrievalModel,
            model_routes,
        )
        from mmrp_tpu_torch.models.explain import (
            ExplanationEngine,
            _resolve_chunk,
            compare_maps,
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
        from mmrp_tpu_torch.ops.preprocess import preprocess_batch
        from mmrp_tpu_torch.ops.quant import quantize_weight
        from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
        from mmrp_tpu_torch.retrieval.rerank import Reranker
        from mmrp_tpu_torch.serve.app import serve as serve_demo
        from mmrp_tpu_torch.serve.runner import build_demo_context
        from mmrp_tpu_torch.serve.stream import StreamingPipeline
        from mmrp_tpu_torch.train.joint import (
            compute_losses,
            init_train_state,
            make_train_step,
        )
        from mmrp_tpu_torch.utils.convert import (
            init_params,
            save_param_tree,
            state_dict_to_flax_flat,
        )
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
    # the kernels with nvcc, and beside them the native DICOM decoder with g++
    # (python -m mmrp_tpu_torch.data.native): every later decode takes it
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build, True)
        nvcc_log = _build.build(force=True)
        host.result()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH.relative_to(REPO)}, "
        f"{native.LIB_PATH.relative_to(REPO)}")
    (_build.BUILD_DIR / "nvcc.log").write_text(nvcc_log)
    _build.library()
    if not native.available():
        fail("build: the native decoder does not load")
    phase_done("build")
    if sys.argv[1:] == ["--pipeline-only"]:  # phases 1, 2 and 8 alone, no result line
        with tempfile.TemporaryDirectory() as tmp:
            pipeline_phase(torch, dev, smi, tmp)
        phase_done("train a run directory")
        log("chip_smoke: --pipeline-only ran phases 1, 2 and 8 alone; no result line")
        return 0
    if sys.argv[1:] == ["--cli-only"]:  # phases 1, 2 and 9 alone, no result line
        import numpy as np

        # a gallery of phase 4c's size: 100,000 seeded rows and 8 request rows
        gen = torch.Generator(device=dev).manual_seed(SEED)
        rows = torch.randn((100_000 + B, 1024), generator=gen, device=dev).cpu().numpy()
        ids_ = [f"g{i}" for i in range(100_000)] + [f"req{b}" for b in range(B)]
        with tempfile.TemporaryDirectory() as tmp:
            cli_phase(torch, dev, smi, tmp, rows, ids_, list(range(100_000, 100_000 + B)))
        phase_done("the Quick start through the cli")
        log("chip_smoke: --cli-only ran phases 1, 2 and 9 alone; no result line")
        return 0
    if sys.argv[1:] == ["--pretrained-only"]:  # phases 1, 2 and 10 alone, no result line
        with tempfile.TemporaryDirectory() as tmp:
            write_pipe_tree(Path(tmp) / "openi")
            pretrained_phase(torch, dev, smi, Path(tmp) / "openi")
        phase_done("pretrained bootstrap and the other towers")
        log("chip_smoke: --pretrained-only ran phases 1, 2 and 10 alone; no result line")
        return 0
    if sys.argv[1:] == ["--mesh-only"]:  # phases 1, 2 and 12 alone, no result line
        mesh_phase(torch, dev, smi)
        phase_done("the mesh on one card")
        log("chip_smoke: --mesh-only ran phases 1, 2 and 12 alone; no result line")
        return 0
    if sys.argv[1:] == ["--packed-only"]:  # phases 1, 2 and 3b alone, no result line
        packed_phase(torch, dev, smi)
        phase_done("packed K3 at the stream's lengths")
        log("chip_smoke: --packed-only ran phases 1, 2 and 3b alone; no result line")
        return 0
    if sys.argv[1:] == ["--export-only"]:  # phases 1, 2 and 11 alone, no result line
        with tempfile.TemporaryDirectory() as tmp:
            export_phase(torch, dev, smi, *export_alone(torch, dev, Path(tmp)))
        phase_done("the serving artifact and explain over the int8 mixes")
        log("chip_smoke: --export-only ran phases 1, 2 and 11 alone; no result line")
        return 0

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
    packed_record = packed_phase(torch, dev, smi)
    phase_done("packed K3 at the stream's lengths")

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

    counters = serving_counters()

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
    # what lax.top_k's tie order costs on one query's score row
    from mmrp_tpu_torch.retrieval.gallery import topk_ordered

    row = torch.randn((1, len(gallery_ids)), generator=gen, device=dev)
    tk_ms = {name: cuda_ms(torch, fn, reps=50, warmup=5) for name, fn in (
        ("topk_ordered (a stable sort)", lambda: topk_ordered(row, 10)),
        ("torch.topk (no tie order)", lambda: torch.topk(row, 10)))}
    log(f"top-10 of one {len(gallery_ids)}-score row (CUDA events, host issue included): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in tk_ms.items()))
    int8_models = {mix: routes[mix] for mix in INT8_EXPLAIN_MIXES}  # phase 11's
    del model_k1k2, routes, m, engine, fwd, img_d, ids_d, mask_d
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("int8 serving and throughput")

    # -- 4c. serve from a run directory ----------------------------------------
    # a run directory as the JAX trainer leaves it, written by the port alone
    # (the card has no JAX): the weights of the in-process flagship `model`
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        (run / "joint").mkdir(parents=True)
        (run / "kg").mkdir()
        t0 = time.perf_counter()
        (run / "config.yaml").write_text(
            "image_backbone: swin\nimage_size: 224\njoint_dim: 1024\nnum_fusion_layers: 5\n"
            "num_heads: 8\ntext_dim: 512\nserve_quant: none\nbatch_size: 64\n"
            "rerank_alpha: 0.6\nrerank_beta: 0.25\nrerank_gamma: 0.15\ndtype_policy: bf16\n")
        text_dims = {k: v for k, v in dataclasses.asdict(cfg.text).items() if k != "quant"}
        (run / "model_config.json").write_text(json.dumps(
            {"flagship": True, "vision_backbone": "swin",
             "text": {**text_dims, "use_fused_ffn": False, "use_fused_attention": True}}))
        words = [f"w{i}" for i in range(cfg.text.vocab_size - 5)]
        (run / "vocab.txt").write_text(
            "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
        save_param_tree(run / "joint" / "params.npz",
                        {f"model/{k}": v for k, v in state_dict_to_flax_flat(model).items()})
        r = np.random.default_rng(SEED + 4)
        thresholds = r.uniform(0.3, 0.7, len(LABEL_COLS)).astype(np.float32)
        np.save(run / "joint" / "thresholds.npy", thresholds)
        # 8 requests: 16-bit DICOM files (MONOCHROME1 and 2, with and without
        # window tags) and reports long enough to fill 512 tokens
        # window, or the preprocessor's default of 40 / 400 for the untagged
        dicoms, reports = [], []
        yy, xx = np.mgrid[0:DICOM_HW, 0:DICOM_HW] / DICOM_HW
        for b in range(B):
            wave = np.sin(6.3 * (r.random() + 1) * yy + 3 * xx * r.random())
            center, amp = (1800.0, 1000.0) if b % 2 else (100.0, 150.0)
            pixels = (center + amp * wave + r.normal(0, amp / 8, (DICOM_HW, DICOM_HW)))
            pixels = pixels.clip(0, 4095).astype(np.uint16)
            window = dict(window_center=1800.0, window_width=2400.0) if b % 2 else {}
            dicoms.append(run / f"req{b}.dcm")
            write_dicom(dicoms[-1], pixels, photometric="MONOCHROME1" if b % 4 == 3
                        else "MONOCHROME2", **window)
            reports.append(" ".join(r.choice(words, int(r.integers(40, 700)))))
        tok = WordPieceTokenizer.from_vocab_file(str(run / "vocab.txt"))
        pre = DICOMImagePreprocessor(output_size=(224, 224))
        t1 = time.perf_counter()
        req_images = np.stack([pre.load(str(p)).transpose(1, 2, 0) for p in dicoms])
        log(f"run directory: DICOM decode + preprocessing of {B} x {DICOM_HW}^2 on the host: "
            f"{time.perf_counter() - t1:.2f} s")
        enc = [tok.encode(text, RUN_TEXT_LEN) for text in reports]
        req_ids, req_mask = np.stack([e[0] for e in enc]), np.stack([e[1] for e in enc])
        inproc = MMRPredictor(model, LABEL_COLS)
        req_emb = inproc.embed(req_images, req_ids, req_mask)["joint_emb"]
        run_ids = gallery_ids[:len(gallery)] + [f"req{b}" for b in range(B)]
        run_gallery = np.concatenate([gallery, req_emb])  # also phase 9's DLS gallery
        np.save(run / "train_embeddings.npy", run_gallery)
        (run / "train_ids.json").write_text(json.dumps(run_ids))
        labels_by_id = {rid: (r.random(len(LABEL_COLS)) < 0.1).astype(int) for rid in run_ids}
        # every record names its DICOM file and report, as the data pipeline
        # writes them; only the requests' files exist (the demo's detail panel
        # skips a record whose file it cannot read)
        report_of = {f"req{b}": reports[b] for b in range(B)}
        (run / "records_cache.json").write_text(json.dumps({"records": [
            {"id": rid, "labels": lab.tolist(), "dicom_path": str(run / f"{rid}.dcm"),
             "report_text": report_of.get(rid, "")} for rid, lab in labels_by_id.items()]}))
        # KG: report nodes of every other gallery record and of the requests,
        # label nodes of every label
        nodes = ([f"report:{rid}" for rid in run_ids[:len(gallery):2]]
                 + [f"report:req{b}" for b in range(B)] + [f"label:{n}" for n in LABEL_COLS])
        node2id = {n: i for i, n in enumerate(nodes)}
        node_emb = r.standard_normal((len(nodes), KG_DIM)).astype(np.float32)
        np.save(run / "kg" / "node_embeddings.npy", node_emb)
        (run / "kg" / "node2id.json").write_text(json.dumps(node2id))
        # a seeded LabelAttention checkpoint in the JAX trainer's npz layout:
        # the reranker pools a record's label-node vectors with it
        la = {"Dense_0/kernel": r.standard_normal((KG_DIM, LA_HIDDEN)) / KG_DIM ** 0.5,
              "Dense_0/bias": r.normal(0, 0.1, LA_HIDDEN),
              "Dense_1/kernel": r.standard_normal((LA_HIDDEN, 1)) / LA_HIDDEN ** 0.5,
              "Dense_1/bias": r.normal(0, 0.1, 1)}
        np.savez_compressed(run / "label_attention.npz", hidden_dim=LA_HIDDEN,
                            log_temp=np.float32(0.0),
                            **{f"param::params/{k}": v.astype(np.float32)
                               for k, v in la.items()})
        log(f"run directory written: {time.perf_counter() - t0:.1f} s "
            f"(params.npz {(run / 'joint' / 'params.npz').stat().st_size / 1e9:.2f} GB, "
            f"gallery {len(run_ids)} x {cfg.joint_dim}, {len(nodes)} KG nodes)")

        t0 = time.perf_counter()
        served = MMRPredictor.from_run_dir(str(run))
        log(f"MMRPredictor.from_run_dir: {time.perf_counter() - t0:.1f} s, "
            f"{next(served.model.parameters()).dtype} on {served.device}")
        if served.device != dev or next(served.model.parameters()).dtype != bf16:
            fail("from_run_dir: the model is not bf16 on the card")
        no_plain_route("run_dir", served.model)
        reset_counts()
        pred = served.predict(req_images, req_ids, req_mask, K=10)
        torch.cuda.synchronize()
        launches["run_dir"] = read_counts()
        log(f"launches in one predict from the run directory (batch {B}, L{RUN_TEXT_LEN}): "
            f"{ {k: v for k, v in launches['run_dir'].items() if v} }")
        if launches["run_dir"] != EXPECTED["run_dir"]:
            fail(f"run_dir: launch counts {launches['run_dir']}, expected {EXPECTED['run_dir']}")
        # the same weights in process, with the run's engine, reranker and thresholds
        want = MMRPredictor(model, LABEL_COLS, served.retriever, served.reranker,
                            threshold=thresholds).predict(req_images, req_ids, req_mask, K=10)
        for key in ("probs", "joint_emb"):
            if not np.array_equal(pred[key], want[key]):
                fail(f"run_dir: {key} differs from the in-process predictor's "
                     f"(max |d| {np.abs(pred[key] - want[key]).max():.3e})")
        for key in ("predicted", "top_labels", "retrieval"):
            if pred[key] != want[key]:
                fail(f"run_dir: {key} differs from the in-process predictor's")
        # the reranked lists against the port's Reranker applied by hand, for
        # the batch (no query id) and request 0 keyed by its own record
        # the served pooler (LabelAttention on the card) against the npz's
        # function in numpy (f64) on the label-node vectors of records
        pooler = served.reranker.label_pooler
        if pooler is None:
            fail("run_dir: label_attention.npz is present, but the reranker has no pooler")
        pool_err = 0.0
        for rid in run_ids[1:40:2]:
            rows = [node2id[f"label:{n}"] for n, v in zip(LABEL_COLS, labels_by_id[rid]) if v]
            if rows:
                vecs = node_emb[rows].astype(np.float64)
                score = np.tanh(vecs @ la["Dense_0/kernel"] + la["Dense_0/bias"]) \
                    @ la["Dense_1/kernel"][:, 0] + la["Dense_1/bias"][0]
                w = np.exp(score - score.max())
                pool_err = max(pool_err, float(np.abs(pooler(node_emb[rows])
                                                      - (w / w.sum()) @ vecs).max()))
        log(f"run_dir: LabelAttention pooler on {dev} against numpy: max |d| {pool_err:.3e} "
            f"(<= {POOL_TOL})")
        if not pool_err <= POOL_TOL:
            fail("run_dir: the LabelAttention pooler strays from its npz's function")
        hand = Reranker(alpha=0.6, beta=0.25, gamma=0.15, labels_by_id=labels_by_id,
                        label_names=LABEL_COLS, kg_node_embeddings=node_emb,
                        kg_node2id=node2id, label_pooler=pooler)
        one = served.predict(req_images[:1], req_ids[:1], req_mask[:1], K=10, query_id="req0")
        for b, qid, q, got in ([(b, None, pred["joint_emb"][b], pred["retrieval"][b])
                                 for b in range(B)]
                                + [(0, "req0", one["joint_emb"][0], one["retrieval"][0])]):
            cands = [h[0] for h in served.retriever.retrieve(q, K=30, query_id=qid)]
            ranked = hand.rerank(qid or "", cands, served.retriever.get_embeddings_for_ids(cands),
                                 q, topk=10)
            if got != [(x[0], x[1]) for x in ranked]:
                fail(f"run_dir: request {b} (query id {qid}): the reranked list differs from "
                     "the Reranker's by hand")
        if "req0" in [rid for rid, _ in one["retrieval"][0]]:
            fail("run_dir: a request keyed by its own record retrieved itself")
        log(f"run_dir: probs and joint_emb bit-identical to the in-process predictor; "
            f"reranked top-3 of request 0 {pred['retrieval'][0][:3]}, keyed by req0 "
            f"{one['retrieval'][0][:3]}")

        # preprocessing on the card: the requests' raw pixels and windows
        dcms = [read_dicom(str(p)) for p in dicoms]
        raw = np.stack([d.pixel_array.astype(np.float32) for d in dcms])
        wc = np.array([pre.default_window_center if d.window_center is None
                       else d.window_center for d in dcms], np.float32)
        ww = np.array([pre.default_window_width if d.window_width is None
                       else d.window_width for d in dcms], np.float32)
        args = [torch.from_numpy(a) for a in (raw, wc, ww)]
        want_pre = preprocess_batch(*args)
        args = [a.to(dev) for a in args]
        got_pre = preprocess_batch(*args)
        err = (got_pre.cpu() - want_pre).abs().max().item()
        pre_ms = cuda_ms(torch, lambda: preprocess_batch(*args), reps=10, warmup=2)
        log(f"preprocess_batch ({B}, {DICOM_HW}, {DICOM_HW}) -> 224 on {dev}: "
            f"max |d| against the CPU {err:.3e} (<= {PREPROCESS_TOL}), {pre_ms:.3f} ms")
        if tuple(got_pre.shape) != (B, 224, 224, 3) or not err <= PREPROCESS_TOL:
            fail("preprocess_batch on the card strays from the CPU")
        del args, got_pre, want_pre, raw

        # the stream: batch 64 at 512 tokens, 4 batches, the last with padded
        # rows, in the uint16 + window, uint8 and f32 forms; each compact form
        # beside the f32 form of the same pixels
        r = np.random.default_rng(SEED + 5)
        n_valid = STREAM_BATCHES * STREAM_B - STREAM_PAD
        forms = {}
        for form in ("uint16", "uint8"):
            batches, f32_batches = [], []
            for i in range(STREAM_BATCHES):
                if form == "uint16":
                    img = r.integers(0, 4096, (STREAM_B, 224, 224)).astype(np.uint16)
                    wcs = r.uniform(1500, 2500, STREAM_B).astype(np.float32)
                    wws = r.uniform(800, 3000, STREAM_B).astype(np.float32)
                    lo, hi = (wcs - wws / 2)[:, None, None], (wcs + wws / 2)[:, None, None]
                    x = (np.clip(img.astype(np.float32), lo, hi) - lo) / (hi - lo)
                    extra = {"window_center": wcs, "window_width": wws}
                else:
                    img = r.integers(0, 256, (STREAM_B, 224, 224)).astype(np.uint8)
                    x = img.astype(np.float32) / 255.0
                    extra = {}
                lengths = r.integers(8, RUN_TEXT_LEN + 1, STREAM_B)
                valid = np.ones(STREAM_B, np.float32)
                if i == STREAM_BATCHES - 1:
                    valid[STREAM_B - STREAM_PAD:] = 0.0
                text = {"input_ids": r.integers(5, cfg.text.vocab_size, (STREAM_B, RUN_TEXT_LEN)),
                        "attention_mask": (np.arange(RUN_TEXT_LEN)[None, :]
                                           < lengths[:, None]).astype(np.int64),
                        "valid": valid,
                        "ids": [f"{form}_{i * STREAM_B + j}" for j in range(STREAM_B)]}
                batches.append({"image": img, **extra, **text})
                f32_batches.append({"image": ((x - 0.5) / 0.5)[..., None].repeat(3, -1)
                                    .astype(np.float32), **text})
            forms[form] = batches
            forms[f"f32_of_{form}"] = f32_batches
        t0 = time.perf_counter()
        embs, ids_s = [], []
        plain_pipe = StreamingPipeline(served.model, None, LABEL_COLS, thresholds)
        for form in ("f32_of_uint16", "f32_of_uint8"):
            for res in plain_pipe.run(forms[form]):
                embs.append(res["joint_emb"])
                ids_s += res["ids"]
        stream_engine = RetrievalEngine(np.concatenate([gallery] + embs),
                                        gallery_ids[:len(gallery)] + ids_s, device=dev)
        pipe = StreamingPipeline(served.model, stream_engine, LABEL_COLS, thresholds, K=10)
        out = {}
        for form, batches in forms.items():
            res = list(pipe.run(batches))
            if pipe.stats["pairs"] != n_valid or len(res[-1]["probs"]) != STREAM_B - STREAM_PAD:
                fail(f"stream {form}: {pipe.stats['pairs']} rows, expected {n_valid}")
            top1 = [row[0][0] for part in res for row in part["retrieval"]]
            own = [rid for part in res for rid in part["ids"]]
            if top1 != own:
                fail(f"stream {form}: a request's own id is not at rank 1")
            out[form] = np.concatenate([part["joint_emb"] for part in res])
        for form in ("uint16", "uint8"):
            cos = cosine(out[form], out[f"f32_of_{form}"])
            log(f"stream {form} form against its f32 form: joint_emb cosine min {cos.min():.6f} "
                f"(>= {EMB_COS_MIN}), {n_valid} rows, every own id at rank 1")
            if not cos.min() >= EMB_COS_MIN:
                fail(f"stream {form}: the compact form strays from the f32 form")
        log(f"stream checks: {time.perf_counter() - t0:.1f} s")
        timed = forms["uint16"] * STREAM_TIMED_REPEATS
        for depth in (1, 2) * STREAM_TIMED_ROUNDS:
            list(pipe.run(timed, depth=depth))
            log(f"stream uint16 + window, batch {STREAM_B}, L{RUN_TEXT_LEN}, depth {depth}: "
                f"{pipe.stats['pairs_per_sec']:.1f} pairs/s ({pipe.stats['pairs']} pairs, "
                f"{pipe.stats['wall_s']:.3f} s, host clock)")
        del pred, want, pipe, plain_pipe, stream_engine, forms, out, embs, timed
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("serve from a run directory")

        # -- 4d. explain and the demo ------------------------------------------
        # (1) each bf16 serving kernel on its gradient route (the kernel
        # forward, the backward through its plain version recomputed) at the
        # flagship shapes of one predict at L512, batch 1: the forward within
        # the kernel's bound of the plain version, every input gradient bit for
        # bit the all-plain route's (the same plain math on the same inputs),
        # one launch counted per call and no plain call
        ggen = torch.Generator(device=dev).manual_seed(SEED + 6)

        def grnd(shape, scale=1.0, dtype=bf16):
            return (torch.randn(shape, generator=ggen, device=dev) * scale).to(dtype)

        def gln(C):
            return 1 + grnd((C,), 0.1, f32), grnd((C,), 0.1, f32)

        def gblock(C, heads, res, shift):
            blk = (*gln(C), grnd((3 * C, C), C ** -0.5), grnd((3 * C,), 0.1),
                   grnd((C, C), C ** -0.5), grnd((C,), 0.1), *gln(C),
                   grnd((4 * C, C), C ** -0.5), grnd((4 * C,), 0.1),
                   grnd((C, 4 * C), (4 * C) ** -0.5), grnd((C,), 0.1))
            table = grnd(((2 * ws - 1) ** 2, heads), 0.5, f32)
            return blk, K1.build_bias_full(table, ws, res, res, shift)

        D, h, L = cfg.joint_dim, cfg.num_heads, RUN_TEXT_LEN
        mask_l = torch.zeros((1, L), device=dev)
        mask_l[:, 3 * L // 4:] = -1e9
        grad_cases = []  # (kernel, label, wrapper call, plain call, tensors, masks' indices)
        for label, Nq, Nk, cross, key_mask, pos, alpha_g, mode, incl, raw in (
                ("txt_enh", L, L, False, mask_l, grnd((L, D), 0.5),
                 torch.tensor(0.5, device=dev), "pre", True, True),
                ("img_enh", 49, 49, False, None, grnd((49, D), 0.5),
                 torch.tensor(0.5, device=dev), "pre", True, True),
                ("txt2img", L, 49, True, None, None, None, "post", False, False),
                ("img2txt", 49, L, True, mask_l, None, None, "post", False, False),
                ("self", 51, 51, False, None, grnd((51, D), 0.5), None, "pre", True, False)):
            w = []
            for _ in range(4):
                w += [grnd((D, D), D ** -0.5), grnd((D,), 0.1)]
            kw = dict(num_heads=h, ln_mode=mode, include_residual=incl, residual_from_raw=raw)
            grad_cases.append((
                "fused_attention", f"{label} (1,{Nq}<-{Nk},{D}) {mode}",
                lambda *a, k=kw: K3.fused_attention(*a, **k),
                lambda *a, k=kw: K3.attention_plain(*a, **k),
                (grnd((1, Nq, D)), *gln(D), *w, grnd((1, Nk, D)) if cross else None, key_mask,
                 pos, alpha_g), {12}))
        for M, C, Hd in ((3136, 128, 512), (51, D, 4 * D)):  # Swin stage 1; the fusion FFN
            grad_cases.append((
                "fused_ln_mlp", f"x({M},{C}) hidden {Hd}", K2.fused_ln_mlp_residual,
                K2.ln_mlp_plain, (grnd((M, C)), *gln(C), grnd((Hd, C), C ** -0.5),
                                  grnd((Hd,), 0.1), grnd((C, Hd), Hd ** -0.5),
                                  grnd((C,), 0.1)), set()))
        blk, bias = gblock(128, 4, 56, 3)
        grad_cases.append((
            "fused_window_attention", "xw(1,64,49,128) h4 shift 3",
            lambda *a: K1.fused_window_attention_windows(*a, 4),
            lambda *a: K1.window_attention_plain(*a, 4),
            (grnd((1, 64, 49, 128)), *blk[:6], bias), set()))
        blk, bias = gblock(256, 8, 28, 0)
        blk1, bias1 = gblock(256, 8, 28, 3)
        grad_cases.append((
            "fused_swin_block_pair", "map(1,28,28,256) h8",
            lambda x, *t: SP.fused_swin_block_pair(x, t[:12], t[12], t[13:25], t[25], 8, ws, 3),
            lambda x, *t: SP.pair_plain(x, t[:12], t[12], t[13:25], t[25], 8, ws, 3),
            (grnd((1, 28, 28, 256)), *blk, bias, *blk1, bias1), set()))
        for roll, shift in ((-3, 0), (3, 3)):
            blk, bias = gblock(512, 16, 14, shift)
            grad_cases.append((
                "fused_swin_block_chain", f"map(1,14,14,512) h16 roll {roll:+d}",
                lambda x, *t, r=roll: SP.fused_swin_block_chain(x, t[:12], t[12], 16, ws, r),
                lambda x, *t, r=roll: SP.chain_plain(x, t[:12], t[12], 16, ws, r),
                (grnd((1, 14, 14, 512)), *blk, bias), set()))
        grad_cases.append((
            "fused_swin_block_raw", "map(1,14,14,512) h16",
            lambda *a: SB.fused_swin_block_raw(*a, 16, ws),
            lambda *a: SB.raw_plain(*a, num_heads=16, ws=ws),
            (grnd((1, 14, 14, 512)), *blk, bias), set()))
        blk, bias = gblock(1024, 32, 7, 0)
        grad_cases.append((
            "fused_swin_block_windows", "xw(1,1,49,1024) h32",
            lambda *a: SB.fused_swin_block_windows(*a, 32), lambda *a: SB.swin_block_plain(*a, 32),
            (grnd((1, 1, 49, 1024)), *blk, bias), set()))

        grad_route, problems = {}, []
        reset_counts()
        for name, label, call, plain, tensors, masks in grad_cases:
            leaves = [None if t is None else
                      t.detach().clone().requires_grad_(t.is_floating_point() and i not in masks)
                      for i, t in enumerate(tensors)]
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            fn, attr = counters[name]
            n0 = getattr(fn, attr)
            out = call(*leaves)
            launched = getattr(fn, attr) - n0
            ref_out = plain(*leaves)
            cot = torch.randn(out.shape, generator=ggen, device=dev).to(out.dtype)
            got = torch.autograd.grad(out, wrt, cot)
            want = torch.autograd.grad(ref_out, wrt, cot)
            rel = max_rel(out.detach(), ref_out.detach()).item()
            gdiff = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            equal = all(torch.equal(a, b) for a, b in zip(got, want))

            def fwd_bwd(fn=call):
                torch.autograd.grad(fn(*leaves), wrt, cot)

            ms = cuda_ms(torch, fwd_bwd, reps=5, warmup=1)
            plain_ms = cuda_ms(torch, lambda: fwd_bwd(plain), reps=5, warmup=1)
            log(f"gradient route {name:24s} {label:34s} forward max_rel_err {rel:.3e} (tol "
                f"{KERNEL_TOL:.3e}), {len(wrt)} input gradients bit-equal to the plain route: "
                f"{equal} (max |d| {gdiff:.3e}), launches {launched}; forward + backward "
                f"{ms:.4f} ms against the plain route's {plain_ms:.4f} ms")
            if rel > KERNEL_TOL or not equal or launched != 1:
                problems.append(f"gradient route {name} {label}: max_rel_err {rel}, "
                                f"gradients equal {equal}, launches {launched}")
            agg = grad_route.setdefault(name, dict(cases=0, max_rel_err=0.0, max_grad_diff=0.0,
                                                   grads_bit_equal=True, ms=0.0, plain_ms=0.0))
            agg.update(cases=agg["cases"] + 1, max_rel_err=max(agg["max_rel_err"], rel),
                       max_grad_diff=max(agg["max_grad_diff"], gdiff),
                       grads_bit_equal=agg["grads_bit_equal"] and equal,
                       ms=agg["ms"] + ms, plain_ms=agg["plain_ms"] + plain_ms)
            del leaves, wrt, out, ref_out, got, want
        read_counts()  # fails on a plain call
        if problems:
            fail("; ".join(problems))
        del grad_cases, blk, bias, blk1, bias1, mask_l
        gc.collect()
        torch.cuda.empty_cache()

        # (2) explain on the default route at L512: predict(explain=True) at
        # batch 1 with its 5 auto targets and the default 50 IG steps, its
        # launches counted (the slice's main path); then the engine's methods
        # against the same weights in f32 on the CPU
        x1 = (req_images[:1], req_ids[:1], req_mask[:1])
        eng = served.explainer
        reset_counts()
        t0 = time.perf_counter()
        pred_x = served.predict(*x1, K=5, explain=True)
        first_s = time.perf_counter() - t0
        launches["explain"] = read_counts()
        targets = list(pred_x["explanation"]["per_target"])
        want_launches = explain_expected(EXPLAIN_STEPS, _resolve_chunk(EXPLAIN_STEPS, 5),
                                         len(targets))
        log(f"launches in one predict(explain=True) (batch 1, L{L}, {len(targets)} targets, "
            f"{EXPLAIN_STEPS} IG steps): { {k: v for k, v in launches['explain'].items() if v} }")
        if launches["explain"] != want_launches or len(targets) != 5:
            fail(f"explain: launch counts {launches['explain']}, expected {want_launches}")
        # Grad-CAM is ReLU(sum_c w_c act_c): a target whose weighted sum is
        # negative on every patch has a flat map; the attention and IG maps
        # never are
        for t, maps in pred_x["explanation"]["per_target"].items():
            for key, m in maps.items():
                if m.shape != (1, 224, 224) or not np.isfinite(m).all() or (
                        key != "grad_cam" and np.ptp(m) <= 0):
                    fail(f"explain: target {t} {key}: shape {m.shape}, or not finite, or flat")
        if all(np.ptp(maps["grad_cam"]) <= 0
               for maps in pred_x["explanation"]["per_target"].values()):
            fail("explain: every target's Grad-CAM map is flat")
        predict_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            served.predict(*x1, K=5, explain=True)
            predict_s.append(time.perf_counter() - t0)
        log(f"predict(explain=True), batch 1, L{L}, 5 targets, {EXPLAIN_STEPS} IG steps: "
            f"{predict_s[0]:.3f} / {predict_s[1]:.3f} s (first call {first_s:.3f} s; host "
            f"clock); K3 launches {launches['explain']['fused_attention']}, K2 "
            f"{launches['explain']['fused_ln_mlp']} per explain request")

        ref = MultiModalRetrievalModel(cfg, dtype=f32, device="cpu").eval()
        ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        ref_eng = ExplanationEngine(ref)
        t0 = time.perf_counter()
        want_fwd = serving_forward(ref)(*(torch.from_numpy(a) for a in x1))
        cos = cosine(pred_x["joint_emb"], want_fwd["joint_emb"].numpy()).min()
        dprobs = float(np.abs(pred_x["probs"] - want_fwd["probs"].numpy()).max())
        log(f"explain request vs plain path: joint_emb cosine {cos:.6f} (>= {EMB_COS_MIN}), "
            f"max |dprobs| {dprobs:.3e} (<= {PROBS_MAX_DIFF})")
        if not (cos >= EMB_COS_MIN and dprobs <= PROBS_MAX_DIFF):
            fail("explain: the request's outputs stray from the plain path")
        agreement = {}

        def hold(what, got_m, want_m, pearson_min, iou_min=None):
            """A map of the card against the CPU's: Pearson (and IoU@20%)
            bounds; a flat map fails (its Pearson is NaN), except a Grad-CAM
            map that is flat on the CPU too (no patch with a positive
            weighted sum there), which must then be flat on the card as well."""
            if "grad_cam" in what and np.ptp(want_m) <= 0:
                agreement[what] = {"flat": True}
                log(f"explain {what}: flat on the CPU (ReLU leaves no positive patch), on "
                    f"the card flat: {np.ptp(got_m) <= 0}")
                if np.ptp(got_m) > 0:
                    problems.append(f"explain {what}: flat on the CPU, not on the card")
                return
            cmp = compare_maps(np.asarray(got_m), np.asarray(want_m))
            agreement[what] = cmp
            ok = cmp["pearson"] >= pearson_min and (iou_min is None
                                                    or cmp["iou@20%"] >= iou_min)
            log(f"explain {what}: pearson {cmp['pearson']:.5f} (>= {pearson_min}), iou@20% "
                f"{cmp['iou@20%']:.3f}" + (f" (>= {iou_min})" if iou_min else ""))
            if not ok:
                problems.append(f"explain {what}: {cmp}")

        # the attention maps are layer-, head- and token-means of near-uniform
        # softmax weights, whose spatial spread is of the order of bf16's
        # rounding of the scores: the card is held to the f32 path as closely as
        # the plain versions in bf16 on the CPU (the same weights) are
        ref16 = MultiModalRetrievalModel(cfg, dtype=bf16, device="cpu").eval()
        ref16.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        eng16 = ExplanationEngine(ref16)

        def hold_attention(what, card_m, bf16_m, f32_m):
            """Pearson(card, f32) >= ATTN_PEARSON_MIN, or, where the plain bf16
            path itself is further than that from f32, 1 - Pearson(card, f32)
            <= ATTN_BF16_FACTOR (1 - Pearson(plain bf16, f32)) + 1e-3."""
            kf, pf, kp = (compare_maps(np.asarray(a), np.asarray(b)) for a, b in (
                (card_m, f32_m), (bf16_m, f32_m), (card_m, bf16_m)))
            agreement[what] = dict(kf, plain_bf16_vs_f32=pf["pearson"],
                                   card_vs_plain_bf16=kp["pearson"])
            limit = min(ATTN_PEARSON_MIN, 1 - ATTN_BF16_FACTOR * (1 - pf["pearson"]) - 1e-3)
            log(f"explain {what}: pearson against f32 {kf['pearson']:.5f} (>= {limit:.5f}); "
                f"the plain bf16 path against f32 {pf['pearson']:.5f}, the card against it "
                f"{kp['pearson']:.5f}; iou@20% against f32 {kf['iou@20%']:.3f}")
            if not kf["pearson"] >= limit:
                problems.append(f"explain {what}: {agreement[what]}")

        got = served.explain(*x1, targets, ig_steps=EXPLAIN_CMP_STEPS)
        want = ref_eng.explain(*x1, targets, ig_steps=EXPLAIN_CMP_STEPS)
        hold_attention("attn_final", got["attention"]["attn_final"],
                       eng16.attention_maps(*x1)["attn_final"], want["attention"]["attn_final"])
        for t in targets:
            for key in ("ig", "grad_cam"):
                hold(f"target {t} {key}", got["per_target"][t][key],
                     want["per_target"][t][key], MAP_PEARSON_MIN, MAP_IOU_MIN)
        items = (req_images[1:6], req_ids[1:6], req_mask[1:6])
        got_b = eng.explain_batch(*items, n_steps=EXPLAIN_CMP_STEPS)
        want_b = ref_eng.explain_batch(*items, n_steps=EXPLAIN_CMP_STEPS)
        log(f"explain_batch over requests 1-5: top-1 targets card {got_b['targets'].tolist()}, "
            f"CPU {want_b['targets'].tolist()}; max |dprobs| "
            f"{np.abs(got_b['probs'] - want_b['probs']).max():.3e}")
        if not np.array_equal(got_b["targets"], want_b["targets"]):
            problems.append("explain_batch: the card's top-1 targets are not the CPU's")
        items16 = eng16.attention_maps(*items)["attn_final"]
        for b in range(5):
            hold_attention(f"explain_batch item {b} attn_final", got_b["attn_final"][b],
                           items16[b], want_b["attn_final"][b])
            for key in ("ig", "grad_cam"):
                hold(f"explain_batch item {b} {key}", got_b[key][b], want_b[key][b],
                     MAP_PEARSON_MIN, MAP_IOU_MIN)
        n_tok = int(req_mask[0].sum())
        hold("token_attribution", eng.token_attribution(*x1, targets[0], n_steps=4)[0, :n_tok],
             ref_eng.token_attribution(*x1, targets[0], n_steps=4)[0, :n_tok],
             MAP_PEARSON_MIN, MAP_IOU_MIN)
        hold("integrated_gradients_pixels",
             eng.integrated_gradients_pixels(*x1, targets[0], n_steps=2),
             ref_eng.integrated_gradients_pixels(*x1, targets[0], n_steps=2),
             MAP_PEARSON_MIN, MAP_IOU_MIN)
        log(f"explain against the plain path (f32, CPU): {time.perf_counter() - t0:.1f} s")
        if not any("grad_cam" in k and "pearson" in v for k, v in agreement.items()):
            problems.append("explain: no Grad-CAM map was compared (every one flat)")
        if problems:
            fail("; ".join(problems))
        del ref, ref_eng, ref16, eng16, want_fwd
        gc.collect()

        # (3) times on the card (host clock: each call returns numpy)
        batch_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.explain_batch(*items)
            batch_s.append(time.perf_counter() - t0)
        pixel_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.integrated_gradients_pixels(*x1, targets[0], n_steps=1)
            pixel_s.append(time.perf_counter() - t0)
        log(f"explain_batch over 5 items ({EXPLAIN_STEPS} IG steps, chunk 10): "
            + " / ".join(f"{v:.3f}" for v in batch_s) + " s; one pixel-IG step at batch 1: "
            + " / ".join(f"{v * 1e3:.1f}" for v in pixel_s) + f" ms (host clock, {smi})")
        # where one target's explain goes (patch IG at 50 steps and Grad-CAM):
        # the profiler's device time by kernel against the host clock
        t0 = time.perf_counter()
        eng.explain(*x1, targets[:1], ig_steps=EXPLAIN_STEPS)
        one_ms = (time.perf_counter() - t0) * 1e3
        split = device_ms_by_kernel(
            torch, lambda: eng.explain(*x1, targets[:1], ig_steps=EXPLAIN_STEPS), reps=1)
        busy = sum(split.values())
        ours = sum(v for k, v in split.items() if any(n in k for n in PORT_KERNELS))
        top = sorted(split.items(), key=lambda kv: -kv[1])[:5]
        log(f"one target's explain ({EXPLAIN_STEPS} IG steps + Grad-CAM, batch 1, L{L}): "
            f"{one_ms:.1f} ms host clock; device busy {busy:.1f} ms ({100 * busy / one_ms:.1f}%"
            f"), the port's kernels {ours:.1f} ms, in {sum(1 for _ in split)} kernel kinds; "
            "largest: " + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))

        # (4) the HTTP demo over build_demo_context of the run directory
        demo_ctx = build_demo_context(str(run))
        server = serve_demo(lambda: demo_ctx, port=0, block=False, host="127.0.0.1")
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(url + "/health", timeout=60) as resp:
                health = (resp.status, json.loads(resp.read()))
            body = json.dumps({"dicom_b64": base64.b64encode(dicoms[0].read_bytes()).decode(),
                               "text": reports[0], "detail": True}).encode()
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/api/predict", data=body,
                    headers={"Content-Type": "application/json"}), timeout=600) as resp:
                status, payload = resp.status, json.loads(resp.read())
            demo_s = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
        keys = {"top_labels", "retrieval", "agreement", "retrieval_detail"}
        log(f"demo: GET /health {health}; POST /api/predict (DICOM {DICOM_HW}^2, "
            f"{len(body) / 1e6:.1f} MB body, detail) -> HTTP {status} in {demo_s:.2f} s, "
            f"latency_ms {payload.get('latency_ms', float('nan')):.1f}, retrieval "
            f"{[rid for rid, _ in payload.get('retrieval', [])]}, "
            f"{len(payload.get('retrieval_detail', []))} detail items, agreement "
            f"{payload.get('agreement')}")
        if health != (200, {"status": "ok"}) or status != 200 or not keys <= payload.keys() \
                or len(payload["retrieval"]) != 5 or not payload["agreement"]:
            fail("demo: /health or /api/predict did not answer with a full payload")
        del served, demo_ctx, eng, pred_x, got, want, got_b, want_b
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("explain and the demo")

        # -- 11. the serving artifact and explain over the int8 mixes ------------
        ids_l, mask_l = text_batch(RUN_TEXT_LEN)
        got_launches, got_routes = export_phase(torch, dev, smi, run, dict(
            images=images, ids=ids_l, mask=mask_l, want_joint=wants[RUN_TEXT_LEN][0],
            want_probs=wants[RUN_TEXT_LEN][1],
            int8=int8_models))
        launches.update(got_launches)
        grad_route.update(got_routes)
        del int8_models
        phase_done("the serving artifact and explain over the int8 mixes")
    del model, gallery
    gc.collect()
    torch.cuda.empty_cache()


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
            # waits
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
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. train a run directory (pipeline_phase) -------------------------------
    with tempfile.TemporaryDirectory() as tmp8:
        launches.update(pipeline_phase(torch, dev, smi, tmp8))
        shutil.rmtree(Path(tmp8) / "openi" / "train")  # phase 10 keeps only the tree
        phase_done("train a run directory")

        # -- 9. the Quick start through the cli (cli_phase) ----------------------------
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(cli_phase(torch, dev, smi, tmp, run_gallery, run_ids,
                                      list(range(len(run_gallery) - B, len(run_gallery)))))
        del run_gallery
        phase_done("the Quick start through the cli")

        # -- 10. the pretrained bootstrap and the other towers (phase 8's tree) --------
        launches.update(pretrained_phase(torch, dev, smi, Path(tmp8) / "openi"))
        phase_done("pretrained bootstrap and the other towers")

    # -- 12. the mesh on one card (mesh_phase) ------------------------------------
    launches.update(mesh_phase(torch, dev, smi, train_ms=ms))
    phase_done("the mesh on one card")

    # -- records ----------------------------------------------------------------
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
            "grad_route": grad_route.get(name),
            **{k: agg[k] for k in ("device_ms", "attn_ms", "attn_bound_ms", "proj_ms",
                                   "proj_bound_ms", "mlp_ms", "mlp_bound_ms") if k in agg},
            **extra})
    records.append(packed_record)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
