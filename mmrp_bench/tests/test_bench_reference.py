"""The plain float32 reference against the port's plain routes (the CPU runs
every kernel's plain version) at micro sizes, with the benchmark's weights."""

import pytest
import torch

from mmrp_bench import gen, harness
from mmrp_bench.reference.model import Ref, window_normalize
from mmrp_bench.tests import micro


@pytest.mark.parametrize("cfg", [micro.MICRO, micro.micro_medclip()], ids=["swin", "medclip"])
def test_reference_forward_matches_the_port(cfg):
    from mmrp_tpu_torch.api import serving_forward

    ctx = micro.ctx(cfg, micro.stream_traffic(), "flagship.stream-openi", seed=11)
    model, w = harness.build_model(ctx)
    text = dict(ctx.traffic["text"], vocab_size=cfg["text"]["vocab_size"])
    ids, mask, L = gen.texts(6, text, 11, "cpu")
    px, wc, ww = gen.raw_images(6, ctx.traffic["image"], 11, "cpu")
    image = window_normalize(px, wc, ww)
    got = serving_forward(model)(image, ids.long(), mask.long())
    ref = Ref(cfg, {k: v.float() for k, v in w.items()}).forward(image, ids.long(), mask.long())
    assert L.min() >= 4 and L.max() <= 24
    torch.testing.assert_close(got["probs"].float(), ref["probs"], rtol=0, atol=2e-6)
    torch.testing.assert_close(got["joint_emb"].float(), ref["joint_emb"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["img_emb"].float(), ref["img_emb"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["txt_emb"].float(), ref["txt_emb"], rtol=1e-5, atol=1e-5)


def test_reference_window_normalize_matches_the_stream_ingest():
    from mmrp_tpu_torch.ops.preprocess import window_normalize as port_window

    px, wc, ww = gen.raw_images(3, {"size": 16, "bits": 12, "center": [1024.0, 3072.0],
                                    "width": [1024.0, 4096.0]}, 5, "cpu")
    want = (port_window((px.int() & 0xFFFF).float(), wc, ww) - 0.5) / 0.5
    got = window_normalize(px, wc, ww)
    assert got.shape == (3, 16, 16, 3)
    torch.testing.assert_close(got[..., 0], want)


def test_stream_run_is_correct_against_the_reference():
    out = harness.driver("stream").run(
        micro.ctx(micro.MICRO, micro.stream_traffic(), "flagship.stream-openi"))
    readings = {n: v for n, v, _ in out["checks"]}
    assert readings["missing_pairs"] == readings["label_mismatches"] == 0
    assert readings["topk_misses"] == 0
    assert readings["emb_cos_gap"] < 1e-9 and readings["logit_cos_gap"] < 1e-9


def test_train_steps_match_the_reference_steps():
    out = harness.driver("train").run(
        micro.ctx(micro.MICRO, micro.train_traffic(), "flagship.train-openi", seconds=0.2))
    readings = {n: v for n, v, _ in out["checks"]}
    assert readings["loss_gap"] < 1e-5
    assert readings["change_norm_gap"] < 1e-2
    assert readings["grad_coord_gap"] < 1e-4
    # the window's last step, from the program's state before it
    assert readings["last_loss_gap"] < 1e-5
    assert readings["last_change_gap"] < 1e-2
