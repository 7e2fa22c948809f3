"""The port's spans and counters (``mmrp_tpu_torch/utils/trace.py``): spans
record only inside ``recording()``, counters always count; a train step
records one ``train.step`` tree with its phases and the towers', a stream
batch its dispatch, wait and results under one number; the numbers are the
same with recording on and off; and a span's clock is the profiler's.

Micro sizes on the CPU: Swin at 56 px with embed 16 and one stage, one BERT
layer at 16, one fusion layer at 16.
"""

import contextlib
import copy
import time

import numpy as np
import pytest
import torch

from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.serve.stream import StreamingPipeline
from mmrp_tpu_torch.train.joint import init_train_state, make_train_step
from mmrp_tpu_torch.utils import trace

B, L, KG = 3, 8, 6
STEP_TREE = {"train.forward", "train.loss", "train.backward", "train.read_losses",
             "train.optimizer", "train.write_back"}


def micro_model(dropout=0.0):
    torch.manual_seed(0)
    cfg = MultiModalConfig(
        swin=SwinConfig(img_size=56, embed_dim=16, depths=(1,), num_heads=(2,),
                        drop_path_rate=0.0),
        text=TextConfig.small(hidden_dim=16, num_layers=1, num_heads=2, intermediate_dim=32,
                              max_positions=16, dropout=dropout),
        joint_dim=16, num_fusion_layers=1, num_heads=2, num_classes=5, max_text_len=L,
        dropout=dropout, drop_path=0.0)
    return MultiModalRetrievalModel(cfg, device="cpu")


def micro_batch(kg=True):
    rng = np.random.default_rng(4)
    lengths = np.array([L, 3, 5])
    b = {"image": torch.from_numpy(rng.random((B, 56, 56, 3), dtype=np.float32)),
         "input_ids": torch.from_numpy(rng.integers(0, 8192, (B, L))),
         "attention_mask": torch.from_numpy((np.arange(L) < lengths[:, None]).astype(np.int64)),
         "labels": torch.from_numpy((rng.random((B, 5)) < 0.3).astype(np.float32))}
    if kg:
        b["kg_target"] = torch.from_numpy(rng.standard_normal((B, KG)).astype(np.float32))
    return b


def names_under(records, index):
    return [r.name for r in records if r.parent == index]


def root(records, index):
    while records[index].parent is not None:
        index = records[index].parent
    return index


def test_spans_record_only_inside_a_recording_and_counters_always_count():
    before = trace.counters()
    with trace.span("outside"):
        trace.count("calls", 2)
    assert trace.host_read(torch.tensor(1.5), "read") == 1.5
    after = trace.counters()
    assert after["calls"] - before.get("calls", 0) == 2
    assert after["host_reads"] - before.get("host_reads", 0) == 1

    with trace.recording() as rec:
        with trace.span("a", id=7):
            with trace.span("b"):
                trace.host_read(torch.tensor(2.0), "a.read")
            trace.count("calls")
        with trace.span("c"):
            pass
    assert [(r.name, r.id, r.parent) for r in rec.records] == \
        [("a", 7, None), ("b", 7, 0), ("a.read", 7, 1), ("c", None, None)]
    assert all(r.start_ns <= r.end_ns for r in rec.records)
    assert rec.records[1].start_ns >= rec.records[0].start_ns
    assert rec.records[1].end_ns <= rec.records[0].end_ns
    assert rec.counts == {"calls": 1, "host_reads": 1}
    with trace.span("after"):  # the recording has ended
        pass
    assert len(rec.records) == 4


@pytest.mark.parametrize("kg", [True, False])
def test_a_train_step_records_one_tree_per_call(kg):
    """Two steps: a ``train.step`` per call under the state's count, its
    phases as children, the towers under ``train.forward``, the norm's read
    under ``train.optimizer``; 6 host reads a step with the KG loss, 5
    without."""
    model = micro_model()
    cfg = Config(lr=1e-3, adam_mu_bf16=False)
    state = init_train_state(model, cfg, total_steps=10, kg_dim=KG if kg else None)
    step = make_train_step(model, cfg)
    batch = micro_batch(kg)
    with trace.recording() as rec:
        for _ in range(2):
            step(state, batch)
    recs = rec.records
    tops = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in tops] == ["train.step", "train.step"]
    assert [recs[i].id for i in tops] == [0, 1]
    for i in tops:
        kids = names_under(recs, i)
        assert set(kids) == STEP_TREE
        assert kids.count("train.read_losses") == (5 if kg else 4)
        assert kids[:3] == ["train.forward", "train.loss", "train.backward"]
        assert kids[-2:] == ["train.optimizer", "train.write_back"]
        fwd = next(j for j, r in enumerate(recs) if r.parent == i and r.name == "train.forward")
        assert names_under(recs, fwd) == ["tower.vision", "tower.text", "tower.fusion"]
        opt = next(j for j, r in enumerate(recs) if r.parent == i and r.name == "train.optimizer")
        assert names_under(recs, opt) == ["train.read_norm"]
    assert all(r.id == recs[root(recs, i)].id for i, r in enumerate(recs))
    assert rec.counts["host_reads"] == 2 * (6 if kg else 5)


def test_recording_changes_no_number_of_the_step():
    """Loss terms, grad norm and masters after two steps with dropout: the
    same bits with recording on and off."""
    cfg = Config(lr=1e-2, adam_mu_bf16=True)
    runs = []
    base = micro_model(dropout=0.1)
    for on in (False, True):
        model = copy.deepcopy(base)
        state = init_train_state(model, cfg, total_steps=10, kg_dim=KG)
        step = make_train_step(model, cfg)
        metrics = []
        with trace.recording() if on else contextlib.nullcontext():
            for _ in range(2):
                metrics.append(step(state, micro_batch())[1])
        runs.append((metrics, state))
    (m0, s0), (m1, s1) = runs
    assert m0 == m1
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k
        assert torch.equal(s0.mu[k], s1.mu[k]) and torch.equal(s0.nu[k], s1.nu[k]), k


def stream_batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        lengths = rng.integers(1, L + 1, B)
        out.append({"image": rng.random((B, 56, 56, 3), dtype=np.float32),
                    "input_ids": rng.integers(0, 8192, (B, L)),
                    "attention_mask": (np.arange(L) < lengths[:, None]).astype(np.int64)})
    return out


def test_a_stream_records_each_batch_under_its_number():
    """Three batches at depth 2: each has its dispatch (copies in, towers,
    top-K), wait and results spans under its dispatch number, and the
    results are the same as without recording."""
    model = micro_model().eval()
    gallery = np.random.default_rng(6).standard_normal((20, 16)).astype(np.float32)
    engine = RetrievalEngine(gallery, [f"g{i}" for i in range(20)], device="cpu")
    batches = stream_batches()
    want = list(StreamingPipeline(model, engine, None, 0.5, K=4).run(batches, depth=2))
    with trace.recording() as rec:
        got = list(StreamingPipeline(model, engine, None, 0.5, K=4).run(batches, depth=2))
    for g, w in zip(got, want, strict=True):
        assert g["predicted"] == w["predicted"] and g["retrieval"] == w["retrieval"]
        assert np.array_equal(g["probs"], w["probs"])
        assert np.array_equal(g["joint_emb"], w["joint_emb"])
    recs = rec.records
    tops = [(r.name, r.id) for r in recs if r.parent is None]
    assert tops == [("stream.dispatch", 0), ("stream.dispatch", 1), ("stream.wait", 0),
                    ("stream.results", 0), ("stream.dispatch", 2), ("stream.wait", 1),
                    ("stream.results", 1), ("stream.wait", 2), ("stream.results", 2)]
    for i, r in enumerate(recs):
        if r.name == "stream.dispatch":
            assert names_under(recs, i) == ["stream.h2d", "tower.vision", "tower.text",
                                             "tower.fusion", "gallery.topk"]
            assert {x.id for x in recs if x.parent == i} == {r.id}


def test_a_span_is_on_the_profilers_clock():
    """A span around a ``record_function`` of the same extent: its start and
    end, converted to the trace's microseconds, within 200 us of the range's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            for i in range(4):  # the first call pays for the profiler's own set-up
                with trace.span(f"clock{i}"):
                    with record_function(f"clock{i}"):
                        for _ in range(10):
                            x = torch.tanh(x @ x)
                time.sleep(0.001)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("clock")}
    for r in rec.records[1:]:
        got = ((r.start_ns - t0) / 1e3, (r.end_ns - t0) / 1e3)
        want = ranges[r.name]
        assert abs(got[0] - want.start) < 200 and abs(got[1] - want.end) < 200, (got, want)
