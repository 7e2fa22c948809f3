"""The work and byte counters against counts by hand at small shapes, and a
share above 100% reported as an error."""

import json

import pytest

from mmrp_bench import harness, work
from mmrp_bench.tests import micro


def test_launch_work_by_hand():
    # M = 2 rows, C = 4: proj + FC1 + FC2 = 2*M*C*C + 2*2*M*C*4C = 18 M C^2
    assert work.mlp_launch_work(2, 4, 1, False) == (576, 0, 3 * 2 * 4 * 2 + 9 * 16 * 2)
    assert work.mlp_launch_work(2, 4, 1, True) == (0, 576, 3 * 2 * 4 * 2 + 9 * 16)
    # qkv 6 M C^2 = 192, scores + p.v over N = 3 keys: 4 M N C = 96
    flops, ops8, nbytes = work.attn_launch_work(2, 4, heads=2, nW=1, N=3)
    assert (flops, ops8) == (288, 0)
    assert nbytes == 2 * 2 * 4 * 2 + 3 * 16 * 2 + 3 * 4 * 2 + 1 * 2 * 3 * 3 * 4
    assert work.proj_launch_work(2, 4) == (64, 0, 3 * 2 * 4 * 2 + 16 * 2 + 4 * 2)
    # q, o over M = 3; k, v over 5 rows; q k^T and p v: 4 * 3 * 5 * C
    assert work.attn_flops(3, 5, 2, 5) == 4 * 3 * 4 + 4 * 5 * 4 + 4 * 3 * 5 * 2


def test_model_work_by_hand():
    cfg = micro.MICRO
    # Swin at 56 px: 14 x 14 tokens of C 16, then 7 x 7 of C 32, window 7
    T1, T2 = 196, 49
    emb = 2 * T1 * 48 * 16
    s1 = 2 * (24 * T1 * 16 ** 2 + 4 * T1 * 49 * 16)
    merge = 2 * T2 * 64 * 32
    s2 = 2 * (24 * T2 * 32 ** 2 + 4 * T2 * 49 * 32)
    assert work.vision_flops(cfg) == emb + s1 + merge + s2
    # BERT over L = 10 valid tokens: 2 layers of 8 L H^2 + 4 L H I + 4 L^2 H
    assert work.text_flops(cfg, 10) == 2 * (8 * 10 * 32 ** 2 + 4 * 10 * 32 * 64 + 4 * 100 * 32)
    parts = work.pair_work(cfg, 10)
    assert work.batch_flops(cfg, [10, 10]) == 2 * sum(parts.values())
    assert work.batch_flops(cfg, [10], ("text",)) == parts["text"]
    flagship = json.loads((harness.HERE / "configs" / "flagship.json").read_text())
    # Swin-B at 224: 15.4 GMAC, 30.9 GFLOP in its GEMMs and attention products
    assert 30.5e9 < work.vision_flops(flagship) < 31.2e9


def test_roofline_is_the_larger_bound():
    assert work.roofline_ms(989e9, 0) == pytest.approx(1.0)
    assert work.roofline_ms(0, 3.35e9) == pytest.approx(1.0)
    assert work.roofline_ms(989e9, 6.7e9) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["mfu.embed", "mfu.train"])
def test_mfu_above_100_is_an_error(name):
    read = harness.metric_reader(name)
    data = {"window": {"seconds": 1.0, "pairs": 1, "steps": 1, "useful_flops": 0.5e15}}
    assert read(data) == pytest.approx(0.5e15 / 989e12 * 100)
    data["window"]["useful_flops"] = 1.0e15
    with pytest.raises(ValueError, match="100%"):
        read(data)


@pytest.mark.parametrize("name,part,span", [("text_fusion_roofline", "text_fusion", "model.text"),
                                            ("vision_roofline", "vision", "model.vision")])
def test_roofline_above_100_is_an_error(name, part, span):
    read = harness.metric_reader(name)
    trace = {"complete": True, "span_device_s": {span: 1e-3}}
    data = {"trace": trace, "trace_work": {part: (0.5e-3 * 989e12, 0)}}
    assert read(data) == pytest.approx(50.0)
    data["trace_work"][part] = (2e-3 * 989e12, 0)
    with pytest.raises(ValueError, match="100%"):
        read(data)
    trace["complete"] = False
    assert read(data) is None
