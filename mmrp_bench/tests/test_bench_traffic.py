"""The general generator: the same seed gives the same inputs, another seed
other inputs, and every seed the same set of text lengths."""

import numpy as np
import pytest
import torch

from mmrp_bench import gen, harness

TEXT = dict(harness.traffic_file("stream-openi")["text"], vocab_size=28996)
IMAGE = harness.traffic_file("stream-openi")["image"]


def draws(seed):
    ids, mask, L = gen.texts(64, TEXT, seed, "cpu")
    px, wc, ww = gen.raw_images(4, dict(IMAGE, size=32), seed, "cpu")
    schema = [("a.weight", (8, 4), torch.bfloat16), ("a.bias", (8,), torch.bfloat16),
              ("n.weight", (4,), torch.float32), ("g.alpha", (), torch.float32)]
    w = gen.weights(schema, seed, "cpu")
    return {"ids": ids, "mask": mask, "L": torch.from_numpy(L), "px": px, "wc": wc, "ww": ww,
            "img": gen.model_images(2, {"size": 8}, seed, "cpu"),
            "labels": gen.labels(16, 43, 0.1, seed, "cpu"),
            "kg": gen.kg_targets(4, 300, seed, "cpu"),
            "gallery": gen.gallery(50, 16, seed, "cpu"),
            "kg_proj": gen.kg_proj(16, 8, seed, "cpu"),
            "thr": torch.from_numpy(gen.thresholds(43, 0.2, 0.8, seed)),
            **{f"w:{k}": v for k, v in w.items()}}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345, 3_000_000_001])
def test_same_seed_same_inputs(seed):
    a, b = draws(seed), draws(seed)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_another_seed_other_inputs_same_lengths():
    a, b = draws(3_000_000_001), draws(3_000_000_002)
    for k in ("ids", "px", "wc", "img", "labels", "kg", "gallery", "thr", "w:a.weight"):
        assert not torch.equal(a[k], b[k]), k
    assert not torch.equal(a["L"], b["L"])
    assert torch.equal(torch.sort(a["L"]).values, torch.sort(b["L"]).values)


def test_texts_are_cls_body_sep_then_padding():
    ids, mask, L = gen.texts(256, TEXT, 9, "cpu")
    # the traffic's published mean (R2Gen's IU X-Ray reports, with [CLS] and [SEP])
    assert L.min() >= 4 and L.max() <= 512 and abs(L.mean() - TEXT["len_mean"]) < 0.5
    for row, n in zip(range(ids.shape[0]), L):
        assert ids[row, 0] == 101 and ids[row, n - 1] == 102
        assert int(mask[row].sum()) == n and not ids[row, n:].any()
        body = ids[row, 1:n - 1]
        assert ((body >= 104) & (body < 28996)).all()


def test_weights_follow_their_rules_and_dtypes():
    schema = [("x.weight", (256, 1024), torch.bfloat16), ("x.bias", (256,), torch.bfloat16),
              ("ln.weight", (1024,), torch.float32), ("e.alpha", (), torch.float32)]
    w = gen.weights(schema, 1, "cpu")
    assert w["x.weight"].dtype == torch.bfloat16 and w["ln.weight"].dtype == torch.float32
    assert abs(float(w["x.weight"].float().std()) - 1024 ** -0.5) < 2e-3
    assert abs(float(w["ln.weight"].mean()) - 1.0) < 5e-3
    assert abs(float(w["x.bias"].float().std()) - 0.02) < 5e-3
    assert w["e.alpha"].shape == ()


def test_gallery_rows_are_unit_and_pos_weight_is_clamped():
    g = gen.gallery(100, 32, 4, "cpu")
    torch.testing.assert_close(g.norm(dim=1), torch.ones(100))
    labels = np.zeros((10, 3), np.float32)
    labels[0, 0] = 1
    labels[:6, 1] = 1
    assert gen.pos_weight(labels, 5.0).tolist() == [5.0, 1.0, 1.0]
