"""Drives ``serve.stream.StreamingPipeline.run(loader, depth)`` with the
gallery top-K, the per-class thresholds and the compact uint16 ingest.

Set-up: the model from the seed, a ``RetrievalEngine`` over a gallery of
unit rows from the seed, thresholds from the seed, and a ring of distinct
host batches that the loader cycles; then a few batches through the
pipeline warm every shape the window uses. The window feeds the ring for
``--seconds``, closed loop (the pipeline dispatches batch i+1 before it
reads batch i's results); the loader stops when the window closes and the
pipeline drains. With ``--trace 1`` the same window runs with the
benchmark's spans, and a short stretch after it runs under the profiler.

The check, once the window has closed and the program is freed: every
batch that went in came out; every answer's label set is its probabilities
against the thresholds; every answer's top-K is the top-K of its own
embedding over the gallery (float64) with its scores; and for batches drawn
from the seed (and the one holding the longest report) the joint
embeddings and the logits (from the served probabilities) against the
plain float32 reference, each row by 1 - cosine.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from mmrp_bench import gen, harness, work
from mmrp_bench.reference.model import forward_blocks, window_normalize
from mmrp_bench.trace import Spans, counter_sources, kinds_line, reduce_profile

SPANS = ("model.vision", "model.text", "model.fusion", "retrieval.topk")


class Feed:
    """Cycles the ring: stops at ``stop_at`` (host clock) or after
    ``count`` batches; records when each batch was handed over."""

    def __init__(self, ring: List[dict], stop_at: float = None, count: int = None,
                 marker: bool = False):
        self.ring, self.stop_at, self.count, self.marker = ring, stop_at, count, marker
        self.yield_t: List[float] = []

    def __iter__(self):
        i = 0
        while self.count is None or i < self.count:
            now = time.perf_counter()
            if self.stop_at is not None and now >= self.stop_at:
                return
            self.yield_t.append(now)
            if self.marker:
                with torch.profiler.record_function("bench.yield"):
                    pass
            yield self.ring[i % len(self.ring)]
            i += 1


def make_ring(ctx):
    """(host batches, valid lengths per batch)."""
    tr = ctx.traffic
    B, R = tr["batch"], tr["ring"]
    text = dict(tr["text"], vocab_size=ctx.config["text"]["vocab_size"])
    ids, mask, L = gen.texts(B * R, text, ctx.seed, ctx.device)
    px, wc, ww = gen.raw_images(B * R, tr["image"], ctx.seed, ctx.device)
    ids, mask = ids.cpu().numpy(), mask.cpu().numpy()
    px = px.cpu().numpy().view(np.uint16)
    wc, ww = wc.cpu().numpy(), ww.cpu().numpy()
    ring = [{"image": px[i * B:(i + 1) * B], "input_ids": ids[i * B:(i + 1) * B],
             "attention_mask": mask[i * B:(i + 1) * B],
             "window_center": wc[i * B:(i + 1) * B], "window_width": ww[i * B:(i + 1) * B]}
            for i in range(R)]
    return ring, [L[i * B:(i + 1) * B] for i in range(R)]


def install_spans(spans: Spans, pipe, model, engine) -> None:
    spans.wrap_method(pipe, "_put", "stream.put")
    finish = pipe._finish

    def waited_finish(batch, host, done):
        if done is not None:
            with spans.span("bench.wait"):
                done.synchronize()
        with spans.span("stream.finish"):
            return finish(batch, host, None)

    pipe._finish = waited_finish
    spans.wrap_method(model.backbones.vision, "forward", "model.vision")
    spans.wrap_method(model.backbones.text, "forward", "model.text")
    for i in range(model.config.num_fusion_layers):
        spans.wrap_method(model._modules[f"fusion_layer{i}"], "forward", "model.fusion")
    spans.wrap_method(engine, "retrieve_batch_device", "retrieval.topk")


def layer_bytes(cfg, B: int) -> Dict[str, int]:
    """Bytes each layer's calls of one batch read and write once: weights,
    inputs, outputs (bf16 activations, int64 ids, f32 images)."""
    T = cfg["text"]["max_positions"]
    H, D = cfg["text"]["hidden_dim"], cfg["fusion"]["joint_dim"]
    Np, F = work.vision_out(cfg)
    img = cfg["vision"]["img_size"]
    nl = cfg["fusion"]["num_fusion_layers"]
    return {"text": work.layer_param_bytes(cfg, "text") + B * T * 8 + B * T * H * 2,
            "fusion": work.layer_param_bytes(cfg, "fusion")
            + nl * (B * (T + Np + 1) * D * 2 + B * T * 8 + B * D * 2),
            "vision": work.layer_param_bytes(cfg, "vision") + B * img * img * 3 * 4
            + B * (Np + 1) * F * 2}


def run(ctx) -> dict:
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
    from mmrp_tpu_torch.serve.stream import StreamingPipeline

    tr, cfg = ctx.traffic, ctx.config
    B, depth, K = tr["batch"], tr["depth"], tr["K"]
    cuda = torch.device(ctx.device).type == "cuda"
    ctx.phase("imports")
    model, w = harness.build_model(ctx)
    sch = harness.schema(model)
    del w
    ctx.phase("model and weights")
    g = gen.gallery(tr["gallery"]["rows"], tr["gallery"]["dim"], ctx.seed, ctx.device)
    engine = RetrievalEngine(g.cpu().numpy(), [str(i) for i in range(g.shape[0])],
                             device=ctx.device)
    del g
    ctx.phase("gallery")
    thr = gen.thresholds(cfg["num_classes"], *tr["thresholds"], ctx.seed)
    ring, ring_len = make_ring(ctx)
    ctx.phase("ring")
    pipe = StreamingPipeline(model, engine, None, thr, K=K)
    for _ in pipe.run(iter(ring[: tr["warmup_batches"]]), depth=depth):
        pass
    spans = Spans(counter_sources() if cuda else None) if ctx.trace else None
    if spans is not None:
        install_spans(spans, pipe, model, engine)
        for _ in pipe.run(iter(ring[:2]), depth=depth):  # the spans' first calls
            pass
        spans.host.clear()
    if cuda:
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.phase("warm-up, window opens")
    feed = Feed(ring, stop_at=t0 + ctx.seconds)
    results, done_t = [], []
    for res in pipe.run(feed, depth=depth):
        done_t.append(time.perf_counter())
        results.append(res)
    end = t0 + ctx.seconds
    n_in = sum(t <= end for t in done_t)
    R = len(ring)
    lat_ms = [(d - y) * 1e3 for d, y in zip(done_t, feed.yield_t)]
    out = {"setup_s": setup_s, "attempted": len(feed.yield_t) * B,
           "end_to_end": {"embed_pairs_per_s": n_in * B / ctx.seconds,
                          "result_p95_ms": float(np.percentile(lat_ms, 95))}}
    data = {"window": {"seconds": ctx.seconds, "pairs": n_in * B, "batches": n_in,
                       "useful_flops": sum(work.batch_flops(cfg, ring_len[i % R])
                                           for i in range(n_in))}}
    if spans is not None:
        data["host_spans"] = {k: list(v) for k, v in spans.host.items()}
        data["host_spans_batches"] = len(feed.yield_t)
        if cuda:
            data["trace"], data["trace_work"] = profile_stretch(ctx, pipe, ring, ring_len,
                                                                spans)
    if cuda:
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    del pipe, engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["checks"] = check(ctx, sch, ring, ring_len, thr, feed, results)
    out["failed"] = (len(feed.yield_t) - len(results)) * B
    out["layer_data"] = data
    return out


def profile_stretch(ctx, pipe, ring, ring_len, spans):
    """A short steady stretch under the profiler: ``trace_batches`` batch
    periods between two loader hand-overs, after two that fill the pipeline,
    and two after it."""
    from torch.profiler import ProfilerActivity, profile

    n = ctx.traffic["trace_batches"]
    spans.calls.clear()
    feed = Feed(ring, count=n + 4, marker=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in pipe.run(feed, depth=ctx.traffic["depth"]):
            pass
        torch.cuda.synchronize()
    red = reduce_profile(prof, SPANS, ("bench.yield", 2, 2 + n), spans)
    ctx.log(f"trace: complete {red['complete']} {red['incomplete_why'][:3]}, port kernels "
            f"{red['port_events']}, " + ", ".join(f"{k} {sorted(set(red['span_counts'][k]))}"
                                                 for k in SPANS))
    ctx.log(f"trace by kind: {kinds_line(red)}")
    B, R = ctx.traffic["batch"], len(ring)
    lens = [L for i in range(n + 4) for L in ring_len[i % R]]
    nb = layer_bytes(ctx.config, B)
    tw = {"batches": n + 4,
          "text_fusion": (work.batch_flops(ctx.config, lens, ("text", "fusion")),
                          (nb["text"] + nb["fusion"]) * (n + 4)),
          "vision": (work.batch_flops(ctx.config, lens, ("vision",)), nb["vision"] * (n + 4))}
    return red, tw


def check(ctx, sch, ring, ring_len, thr, feed, results) -> List[tuple]:
    tr, cfg, lim = ctx.traffic, ctx.config, ctx.limits
    B, R, K = tr["batch"], len(ring), tr["K"]
    dev = ctx.device
    if torch.device(dev).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = len(results)
    missing = (len(feed.yield_t) - n) * B
    # labels: each answer's set is its probabilities against the thresholds
    label_bad = 0
    for res in results:
        want = [np.where(p >= thr)[0].tolist() for p in res["probs"]]
        label_bad += sum(a != b for a, b in zip(res["predicted"], want))
        label_bad += B - len(res["predicted"])
    # top-K of each answer's own embedding, in float64
    G = gen.gallery(tr["gallery"]["rows"], tr["gallery"]["dim"], ctx.seed, dev).double()
    G = G / torch.linalg.vector_norm(G, dim=-1, keepdim=True)
    tol = tr["check"]["score_tol"]
    misses = 0
    block = tr["check"]["topk_block"]
    for s in range(0, n, block):
        chunk = results[s:s + block]
        q = torch.from_numpy(np.concatenate([r["joint_emb"] for r in chunk])).to(dev).double()
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
        rows = [row for r in chunk for row in r["retrieval"]]
        ids = torch.tensor([[int(i) for i, _ in row] + [-1] * (K - len(row)) for row in rows],
                           device=dev)
        got = torch.tensor([[sc for _, sc in row] + [np.nan] * (K - len(row)) for row in rows],
                           device=dev, dtype=torch.float64)
        S = q @ G.T
        best = torch.topk(S, K, dim=1).values
        true = S.gather(1, ids.clamp(min=0))
        dup = torch.tensor([len(set(int(i) for i, _ in row)) != len(row) for row in rows],
                           device=dev)
        bad = (ids < 0) | (true < best - tol) | ~((got - true).abs() <= tol) | dup[:, None]
        misses += int(bad.sum())
        del S
    del G
    # the model's outputs against the reference, on batches drawn from the seed
    longest = int(np.argmax([max(L) for L in ring_len]))
    pos = set(gen.sample(n, tr["check"]["sample_batches"], ctx.seed))
    pos |= {p for p in range(min(n, R)) if p % R == longest}
    wref = {k: v.float() for k, v in gen.weights(sch, ctx.seed, dev).items()}
    emb_gap, logit_gap = 0.0, 0.0
    for p in sorted(pos):
        hb = ring[p % R]
        image = window_normalize(torch.from_numpy(hb["image"].view(np.int16)).to(dev),
                                 torch.from_numpy(hb["window_center"]).to(dev),
                                 torch.from_numpy(hb["window_width"]).to(dev))
        ref = forward_blocks(cfg, wref, image,
                             torch.from_numpy(hb["input_ids"]).to(dev).long(),
                             torch.from_numpy(hb["attention_mask"]).to(dev).long(),
                             rows=tr["check"]["rows_per_block"])
        probs = torch.from_numpy(results[p]["probs"]).to(dev)
        emb = torch.from_numpy(results[p]["joint_emb"]).to(dev)
        p = probs.double().clamp(1e-7, 1 - 1e-7)
        z = torch.log(p) - torch.log1p(-p)  # the served logits, from the served probabilities
        zc = torch.nn.functional.cosine_similarity(z, ref["logits"].double(), dim=-1)
        logit_gap = max(logit_gap, float((1.0 - zc).max()))
        cos = torch.nn.functional.cosine_similarity(emb.double(), ref["joint_emb"].double(),
                                                    dim=-1)
        emb_gap = max(emb_gap, float((1.0 - cos).max()))
    return [("missing_pairs", missing, lim["missing_pairs"]),
            ("label_mismatches", label_bad, lim["label_mismatches"]),
            ("topk_misses", misses, lim["topk_misses"]),
            ("emb_cos_gap", emb_gap, lim["emb_cos_gap"]),
            ("logit_cos_gap", logit_gap, lim["logit_cos_gap"])]
