"""The program's spans against a trace (``program_trace.py``): each idle gap
goes to the innermost span open when it began, the four per-layer numbers
read what the records hold and nothing where there are none, and the clock
check finds a record shifted against the device. ``-m cuda``: the clock
over real traced train steps on the card."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from mmrp_bench import program_trace as P
from mmrp_tpu_torch.utils.trace import Record


def ev(name, a, b, device=True, id=0):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           time_range=SimpleNamespace(start=a, end=b), id=id)


def test_records_move_to_the_trace_clock():
    recs = [Record("a", 1, None, 5_000_000, 7_500_000), Record("b", 1, 0, 6_000_000, None)]
    assert P.on_profile(recs, 4_000_000) == [["a", 1, None, 1000.0, 3500.0]]


def test_each_gap_goes_to_the_innermost_span_open_when_it_began():
    ops = P.device_ops([ev("k1", 0, 10), ev("k2", 30, 50), ev("bench.s", 0, 100),
                        ev("k3", 45, 60), ev("k4", 90, 100), ev("cpu op", 60, 90, False)])
    assert [o[2] for o in ops] == ["k1", "k2", "k3", "k4"]
    gaps = P.holes(ops, 0, 120)
    assert gaps == [(10, 30), (60, 90), (100, 120)]
    opened = [(0, 110, "train.step"), (5, 35, "train.read_losses"), (55, 80, "train.optimizer")]
    got = P.attribute(gaps, opened)
    assert got == [[10, 30, "train.read_losses"], [60, 90, "train.optimizer"],
                   [100, 120, "train.step"]]
    assert P.attribute([(115, 120)], opened) == [[115, 120, P.OUTSIDE]]
    assert P.summary(got + [[0, 5, "train.step"]]) == [
        ["train.optimizer", 30e-6], ["train.step", 25e-6], ["train.read_losses", 20e-6]]


def program(gaps, records, counts, steps=2):
    return {"program": {"idle_gaps": gaps, "records": records, "counts": counts,
                        "steps": steps}}


def test_the_train_readers():
    recs = [["train.step", 0, None, 0, 500], ["train.read_losses", 0, 0, 100, 180],
            ["train.read_norm", 0, 5, 300, 320], ["train.step", 1, None, 600, 1000],
            ["train.read_losses", 1, 3, 700, 740], ["tower.vision", 1, 3, 610, 650]]
    gaps = [[120, 200, "train.read_losses"], [310, 330, "train.read_norm"],
            [400, 450, "train.optimizer"], [710, 750, "train.read_losses"]]
    data = program(gaps, recs, {"host_reads": 12})
    assert P.sync_idle_ms_train(data) == pytest.approx((80 + 20 + 40) / 1e3 / 2)
    assert P.issue_ms_train(data) == pytest.approx((900 - 80 - 20 - 40) / 1e3 / 2)
    assert P.host_reads_train(data) == 6
    assert P.queue_ms_stream(data) is None


def test_the_stream_reader_takes_the_first_operation_each_batch_launched():
    recs = [["stream.dispatch", 0, None, 100, 200], ["stream.h2d", 0, 0, 110, 120],
            ["stream.dispatch", 1, None, 300, 400], ["stream.dispatch", 2, None, 900, 950]]
    ops = [(150, 160, "k0", 7), (250, 260, "copy", 8), (420, 500, "k1", 9),
           (260, 270, "k1b", 10)]
    launch = {7: 105.0, 8: 190.0, 9: 310.0, 10: 399.0}
    queue = P.first_ops(recs, ops, launch, 0, 800)
    assert queue == {0: 50, 1: -40}  # batch 1's earlier launch ran first; 2 is outside
    data = {"program": {"queue_us": {0: 50.0, 1: 70.0}}}
    assert P.queue_ms_stream(data) == pytest.approx(0.06)
    assert P.sync_idle_ms_train(data) is None


@pytest.mark.parametrize("data", [None, {}, {"trace": {"busy_s": 1.0}}])
def test_no_program_records_no_number(data):
    assert all(f(data) is None for f in P.READERS.values())


@pytest.mark.parametrize("shift,bad", [(0, 0), (200, 2), (-200, 2)])
def test_the_clock_check_finds_a_shifted_record(shift, bad):
    """Two reads, each ending 10 us after its copy; the next operation 30 us
    after that. Records shifted by 200 us break one side of each."""
    ops = [(0, 100, "k", 0), (100, 105, "Memcpy DtoH (Device -> Pageable)", 1),
           (145, 200, "k", 2), (200, 203, "Memcpy DtoH (Device -> Pageable)", 3),
           (243, 300, "k", 4)]
    recs = [["train.read_losses", 0, 0, 20 + shift, 115 + shift],
            ["train.read_norm", 0, 0, 150 + shift, 213 + shift],
            ["train.forward", 0, 0, 0, 10]]
    assert len(P.clock_violations(recs, ops)) == bad


@pytest.mark.cuda
def test_the_clock_holds_over_traced_train_steps_on_the_card(card):
    """Micro train steps under a profiler of device activity alone, inside a
    recording: every read's copy ends within 50 us of the read's span end,
    and nothing after it starts earlier than 50 us before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmrp_bench import harness
    from mmrp_bench.tests import micro
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step
    from mmrp_tpu_torch.utils import trace

    mc = harness.program_config(micro.MICRO)
    model = MultiModalRetrievalModel(mc, dtype=torch.bfloat16, device="cuda")
    cfg = Config(lr=1e-3, adam_mu_bf16=True)
    state = init_train_state(model, cfg, total_steps=10, kg_dim=8)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, L = 4, mc.max_text_len
    batch = {"image": torch.rand(B, 56, 56, 3, device="cuda", generator=g),
             "input_ids": torch.randint(0, 8192, (B, L), device="cuda", generator=g),
             "attention_mask": torch.ones(B, L, dtype=torch.long, device="cuda"),
             "labels": (torch.rand(B, 43, device="cuda", generator=g) < 0.1).float(),
             "kg_target": torch.randn(B, 8, device="cuda", generator=g)}
    step = make_train_step(model, cfg)
    for _ in range(2):
        step(state, batch)
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(state, batch)
            torch.cuda.synchronize()
    prog = P.train_program(rec, prof, 3)
    assert sum(r[0] in P.READS for r in prog["records"]) == 18
    assert prog["clock_violations"] == []
    assert P.host_reads_train({"program": prog}) == 6
