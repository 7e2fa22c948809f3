"""Serving from a training-run directory: the port against JAX on the CPU.

One run directory, laid out as the JAX trainer leaves it (``cli train --data
D --out D/train``): ``config.yaml``, ``vocab.txt``, ``model_config.json``
with a text tower pinned to other dims than the config's, the same weights
twice (JAX's orbax best checkpoint under ``joint/ckpt``, which the JAX
package reads, and the ``save_param_tree`` npz ``joint/params.npz``, which
the port reads), calibrated thresholds, a gallery, labels in
``D/records_cache.json``, KG node embeddings, and DICOM files of a test
split. ``build_demo_context`` of each package on it, ``predict`` on the
same requests, ``run_stream`` over the split; ``StreamingPipeline`` on the
batches of ``tests/test_stream.py`` in each ingest form; the engine's
device-resident top-K.

Tolerance 1e-5 on probs and joint_emb: the micro model in f32 through both
packages, sums in other orders. Labels, retrieval ids and their order are
held exactly.
"""

import base64
import dataclasses
import json
import os
import shlex
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmrp_tpu.api import serving_forward as jax_serving_forward
from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.kg.label_attention import LabelAttentionTrainer, LabelAttentionTrainerConfig
from mmrp_tpu.labels import LABEL_COLS
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.retrieval.gallery import RetrievalEngine as JRetrievalEngine
from mmrp_tpu.serve import app as japp
from mmrp_tpu.serve import runner as jrunner
from mmrp_tpu.serve import stream as jstream
from mmrp_tpu.utils.checkpoint import CheckpointManager
from mmrp_tpu.utils.checkpoint import save_param_tree as jsave_param_tree
from mmrp_tpu_torch.api import MMRPredictor
from mmrp_tpu_torch.data.dicom import write_dicom
from mmrp_tpu_torch.kg.label_attention import load_label_attention
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.serve import app, runner, stream
from mmrp_tpu_torch.utils.convert import load_flax_params
from test_stream import _batches
from test_torch_data import no_native_decoder  # noqa: F401 (autouse)
from test_torch_config import assert_same_model
from test_torch_slice import randomize

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(image_backbone="swin_micro", image_size=28, joint_dim=32, num_fusion_layers=1,
           num_heads=2, text_dim=16, use_pallas_attention=False, rerank_alpha=0.5,
           rerank_beta=0.3, rerank_gamma=0.2, batch_size=4)
# the text tower a ported checkpoint would pin: not the micro backbone's default
TEXT = dict(vocab_size=96, hidden_dim=48, num_layers=2, num_heads=2, intermediate_dim=80,
            max_positions=48)
WORDS = ["the", "lung", "lungs", "are", "clear", "heart", "size", "is", "normal",
         "effusion", "pleural", "no", "focal", "consolidation", "mild", "cardiomegaly",
         "opacity", "left", "right", "base", "atelectasis", "pneumothorax", "."]
N_GALLERY, N_QUERY = 40, 6


def report(rng):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(3, 14))))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """(run directory, data directory, the JAX params) of a micro run."""
    return write_run_dir(tmp_path_factory.mktemp("serve") / "data")


def write_run_dir(data):
    """A micro run at ``data / "train"`` with its data directory ``data``, as
    the module docstring lays it out: (run directory, data directory, the JAX
    params)."""
    rng = np.random.default_rng(0)
    run = data / "train"
    (run / "kg").mkdir(parents=True)
    (data / "splits").mkdir()
    (data / "dicom").mkdir()
    jcfg = JConfig(**CFG)
    (run / "config.yaml").write_text(yaml.safe_dump(
        {k: v for k, v in jcfg.to_dict().items() if k != "run_name"}))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    vocab += [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"]
    vocab += [f"tok{i}" for i in range(TEXT["vocab_size"] - len(vocab))]
    (run / "vocab.txt").write_text("\n".join(vocab) + "\n")

    text = JTextConfig(**TEXT, use_fused_attention=False)
    mm_cfg = jmm.MultiModalConfig.from_config(jcfg, num_classes=len(LABEL_COLS),
                                              text_override=text)
    (run / "model_config.json").write_text(json.dumps({
        "flagship": False,
        "vision_backbone": mm_cfg.vision_backbone,
        "text": {k: v for k, v in dataclasses.asdict(mm_cfg.text).items()
                 if k not in ("quant", "remat")},
    }))
    model = jmm.MultiModalRetrievalModel(mm_cfg)
    params = randomize(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))["params"])
    assert CheckpointManager(str(run / "joint" / "ckpt")).update_best(
        1.0, {"model": params}, {})
    jsave_param_tree(str(run / "joint" / "params.npz"), {"model": params})
    np.save(run / "joint" / "thresholds.npy",
            rng.uniform(0.3, 0.7, len(LABEL_COLS)).astype(np.float32))

    gallery = [f"g{i}" for i in range(N_GALLERY)]
    np.save(run / "train_embeddings.npy",
            rng.standard_normal((N_GALLERY, CFG["joint_dim"])).astype(np.float32))
    (run / "train_ids.json").write_text(json.dumps(gallery))
    records = []
    for i, rid in enumerate(gallery + [f"q{i}" for i in range(N_QUERY)]):
        path = data / "dicom" / f"{rid}.dcm"
        if rid.startswith("q"):
            pixels = (rng.random((64, 56)) * 3000).astype(np.uint16)
            window = dict(window_center=1500.0, window_width=2000.0) if i % 2 else {}
            write_dicom(path, pixels, photometric="MONOCHROME1" if i % 3 == 0
                        else "MONOCHROME2", **window)
        records.append({"id": rid, "dicom_path": str(path), "report_text": report(rng),
                        "labels": (rng.random(len(LABEL_COLS)) < 0.2).astype(int).tolist()})
    records[5]["labels"] = [0] * len(LABEL_COLS)  # a record with no label
    (data / "records_cache.json").write_text(json.dumps({"records": records}))
    (data / "splits" / "test_ids.json").write_text(
        json.dumps([f"q{i}" for i in range(N_QUERY)]))
    # KG: report nodes of half the gallery and of q0, label nodes of 30 labels
    names = ([f"report:g{i}" for i in range(0, N_GALLERY, 2)] + ["report:q0"]
             + [f"label:{n}" for n in LABEL_COLS[:30]])
    np.save(run / "kg" / "node_embeddings.npy",
            rng.standard_normal((len(names), 16)).astype(np.float32))
    (run / "kg" / "node2id.json").write_text(json.dumps({n: i for i, n in enumerate(names)}))
    return run, data, params


def copy_run(run_dir, tmp_path):
    run, data, _ = run_dir
    dst = tmp_path / "data"
    shutil.copytree(data, dst)
    return dst / run.name


def requests(ctx, ids, records):
    """The ids' images through the port's preprocessor (NHWC) and their
    reports through the run's tokenizer."""
    images = np.stack([ctx["preprocessor"].load(records[i]["dicom_path"]).transpose(1, 2, 0)
                       for i in ids])
    enc = [ctx["tokenizer"].encode(records[i]["report_text"], ctx["max_length"]) for i in ids]
    return images, np.stack([e[0] for e in enc]), np.stack([e[1] for e in enc])


def test_run_dir_predicts_as_jax(run_dir):
    """from_run_dir / build_demo_context of both packages on one run: the
    same tokenizer, preprocessor, thresholds and records, and predict's
    probs, joint_emb, predicted and top labels and reranked retrieval (a
    batch without a query id; single requests keyed by a gallery record,
    which is excluded from its own list, and by a query record with a KG
    report node; the gallery records have no image, so q1 stands in)."""
    run, data, _ = run_dir
    want_ctx = jrunner.build_demo_context(str(run))
    ctx = runner.build_demo_context(str(run), device="cpu")
    pred, jpred = ctx["predictor"], want_ctx["predictor"]
    assert isinstance(pred, MMRPredictor) and pred.reranker is not None
    assert ctx["max_length"] == want_ctx["max_length"] == CFG["text_dim"]
    assert ctx["records_by_id"] == want_ctx["records_by_id"]
    np.testing.assert_array_equal(pred.threshold, jpred.threshold)
    assert pred.label_names == jpred.label_names
    assert (pred.reranker.alpha, pred.reranker.beta, pred.reranker.gamma) == (0.5, 0.3, 0.2)
    records = ctx["records_by_id"]
    for rid in ("q0", "q1", "q3"):  # MONOCHROME1 and 2, with and without window tags
        np.testing.assert_array_equal(
            ctx["preprocessor"].load(records[rid]["dicom_path"]),
            want_ctx["preprocessor"].load(records[rid]["dicom_path"]))
        text = records[rid]["report_text"]
        for got, want in zip(ctx["tokenizer"].encode(text, 16),
                             want_ctx["tokenizer"].encode(text, 16)):
            np.testing.assert_array_equal(got, want)

    for ids, query_id in ((["q0", "q1", "q2", "q3"], None), (["q1"], "g3"), (["q0"], "q0")):
        image, input_ids, mask = requests(ctx, ids, records)
        got = pred.predict(image, input_ids, mask, K=5, query_id=query_id)
        want = jpred.predict(image, input_ids, mask, K=5, query_id=query_id)
        for key in ("probs", "joint_emb"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
        for key in ("predicted", "top_labels", "retrieval"):
            assert [[n for n, _ in row] for row in got[key]] == \
                [[n for n, _ in row] for row in want[key]], key
            np.testing.assert_allclose([s for row in got[key] for _, s in row],
                                       [s for row in want[key] for _, s in row],
                                       err_msg=key, **TOL)
        if query_id == "g3":
            assert "g3" not in [n for n, _ in got["retrieval"][0]]


def test_run_dir_rebuilds_the_text_override(run_dir):
    """model_config.json's text tower, not the micro backbone's default, with
    the JAX model's fields; its kernel switches choose no route here."""
    run, _, _ = run_dir
    model = MMRPredictor.from_run_dir(str(run), device="cpu").model
    assert model.config.text == TextConfig(**TEXT)
    want = jmm.MultiModalConfig.from_config(
        JConfig(**CFG), num_classes=len(LABEL_COLS), text_override=JTextConfig(**TEXT))
    assert_same_model(model.config, want)
    assert model.config.swin == SwinConfig.micro(use_pallas=False, img_size=28)
    assert next(model.parameters()).dtype == torch.float32


def test_run_dir_picks_up_the_calibration_file(run_dir, tmp_path):
    """serve_quant int8_static with no swin_act_amax_path: the run's
    swin_act_amax.json, as the JAX runner picks it up."""
    from mmrp_tpu_torch.models.quant_calib import save_act_amax

    run = copy_run(run_dir, tmp_path)
    text = (run / "config.yaml").read_text()
    assert "serve_quant: none" in text
    (run / "config.yaml").write_text(text.replace("serve_quant: none", "serve_quant: int8_static"))
    amax = ((1.5, 2.5, 3.5, 4.5),)
    save_act_amax(str(run / "swin_act_amax.json"), amax)
    model = MMRPredictor.from_run_dir(str(run), device="cpu").model
    assert model.config.swin.quant == "int8_static" and model.config.swin.act_amax == amax


def test_run_dir_refuses_weights_that_do_not_fit(run_dir, tmp_path):
    """Without model_config.json the rebuilt text tower is the micro
    default: the npz does not fit, and that is an error, not fresh weights."""
    run = copy_run(run_dir, tmp_path)
    (run / "model_config.json").unlink()
    with pytest.raises(RuntimeError, match="does not match the model shape"):
        runner.build_demo_context(str(run), device="cpu")


def test_run_dir_needs_the_npz_beside_an_orbax_checkpoint(run_dir, tmp_path):
    """An orbax checkpoint the port cannot read, and no npz: an error that
    names the conversion, which then writes the npz the port serves (run
    here as a JAX host runs it); with no weights at all, the seeded demo
    weights."""
    run = copy_run(run_dir, tmp_path)
    want = MMRPredictor.from_run_dir(str(run), device="cpu").model.state_dict()
    (run / "joint" / "params.npz").unlink()
    with pytest.raises(RuntimeError, match="(?s)orbax checkpoint.*write it on a JAX host"):
        runner.build_demo_context(str(run), device="cpu")
    cmd = shlex.split(runner.CONVERT.replace("RUN", str(run)))
    assert cmd[0] == "python"
    subprocess.run([sys.executable] + cmd[1:], check=True, capture_output=True, timeout=300)
    got = MMRPredictor.from_run_dir(str(run), device="cpu").model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    (run / "joint" / "params.npz").unlink()
    shutil.rmtree(run / "joint" / "ckpt")
    a = MMRPredictor.from_run_dir(str(run), device="cpu").model.state_dict()
    b = MMRPredictor.from_run_dir(str(run), device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_dir_refuses_an_npz_older_than_its_checkpoint(run_dir, tmp_path):
    """A run trained again after its npz was written: the old npz would be
    served against the new gallery and thresholds, so the runner raises,
    naming the conversion; once the npz is newer, it serves."""
    run = copy_run(run_dir, tmp_path)
    npz, best = run / "joint" / "params.npz", run / "joint" / "ckpt" / "best"
    t = max(p.stat().st_mtime for p in [best, *best.rglob("*")])
    os.utime(npz, (t - 3600, t - 3600))
    with pytest.raises(RuntimeError, match="(?s)newer than.*write the npz again on a JAX host"):
        runner.build_demo_context(str(run), device="cpu")
    os.utime(npz, (t + 1, t + 1))
    assert runner.build_demo_context(str(run), device="cpu")["predictor"] is not None


def write_label_attention(run, seed=1):
    """A LabelAttention checkpoint of the run's KG table, as the JAX trainer
    saves it, with randomized weights; returns the JAX trainer."""
    table = np.load(run / "kg" / "node_embeddings.npy")
    trainer = LabelAttentionTrainer(table, LabelAttentionTrainerConfig(hidden_dim=8))
    trainer.init(jax.random.PRNGKey(seed))
    trainer.params = randomize(trainer.params, seed)
    trainer.save(str(run / "label_attention.npz"))
    return trainer


def test_label_attention_matches_jax(tmp_path):
    """LabelAttention loaded from a real LabelAttentionTrainer.save npz:
    pooled vectors and weights as the Flax module's on the same inputs, with
    masked labels (atol 1e-6)."""
    rng = np.random.default_rng(6)
    (tmp_path / "kg").mkdir()
    np.save(tmp_path / "kg" / "node_embeddings.npy",
            rng.standard_normal((20, 12)).astype(np.float32))
    trainer = write_label_attention(tmp_path)
    model = load_label_attention(str(tmp_path / "label_attention.npz"), device="cpu")
    assert (model.Dense_0.in_features, model.Dense_0.out_features) == (12, 8)
    embs = rng.standard_normal((3, 5, 12)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1], [1, 0, 1, 0, 0], [0, 0, 0, 1, 0]], np.float32)
    want_pooled, want_w = trainer.model.apply(trainer.params, jnp.asarray(embs),
                                              jnp.asarray(mask))
    with torch.no_grad():
        pooled, w = model(torch.from_numpy(embs), torch.from_numpy(mask))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(want_pooled) - (embs * mask[..., None]).sum(1)
                  / mask.sum(1, keepdims=True)).max() > 1e-2  # not the masked mean


@pytest.fixture(scope="module")
def la_run(run_dir, tmp_path_factory):
    """A copy of the micro run with a label_attention.npz and a DICOM file for
    every record, and the demo context of each package on it: (run, JAX
    context, port context)."""
    run = copy_run(run_dir, tmp_path_factory.mktemp("la_run"))
    write_label_attention(run)
    cache = run.parent / "records_cache.json"
    records = json.loads(cache.read_text())["records"]
    rng = np.random.default_rng(8)
    for rec in records:
        rec["dicom_path"] = str(run.parent / "dicom" / f"{rec['id']}.dcm")
        if rec["id"].startswith("g"):
            write_dicom(rec["dicom_path"], (rng.random((40, 48)) * 3000).astype(np.uint16))
    cache.write_text(json.dumps({"records": records}))
    return (run, jrunner.build_demo_context(str(run)),
            runner.build_demo_context(str(run), device="cpu"))


def test_run_dir_refuses_the_label_attention_pooler(la_run, tmp_path):
    """(The name is kept from the refusal this test replaced.) A run with a
    label_attention.npz beside its KG: both packages pool the label-node
    vectors with it, so the reranked lists are JAX's, in order (scores 1e-5),
    for a batch and for requests keyed by a record; without the KG id map
    there is nothing to pool and no pooler."""
    run, want_ctx, ctx = la_run
    pred, jpred = ctx["predictor"], want_ctx["predictor"]
    assert pred.reranker.label_pooler is not None
    vecs = np.load(run / "kg" / "node_embeddings.npy")[-4:]
    np.testing.assert_allclose(pred.reranker.label_pooler(vecs),
                               jpred.reranker.label_pooler(vecs), rtol=0, atol=1e-6)
    for ids, query_id in ((["q0", "q1", "q2", "q3"], None), (["q1"], "g4"), (["q0"], "q0")):
        image, input_ids, mask = requests(ctx, ids, ctx["records_by_id"])
        got = pred.predict(image, input_ids, mask, K=5, query_id=query_id)["retrieval"]
        want = jpred.predict(image, input_ids, mask, K=5, query_id=query_id)["retrieval"]
        assert [[n for n, _ in row] for row in got] == [[n for n, _ in row] for row in want]
        np.testing.assert_allclose([s for row in got for _, s in row],
                                   [s for row in want for _, s in row], **TOL)
    run = copy_run((run, run.parent, None), tmp_path)
    (run / "kg" / "node2id.json").unlink()  # no KG: nothing to pool, no pooler
    reranker = runner.build_demo_context(str(run), device="cpu")["predictor"].reranker
    assert reranker is not None and reranker.label_pooler is None


def test_run_dir_serves_a_remat_backbone_run_as_jax(run_dir, tmp_path):
    """A run trained with remat_backbone: true is served (remat only matters
    in training): probs and joint_emb of the JAX model built from the same
    config (remat on every tower) with the same weights, within 1e-5. (JAX's
    own build_demo_context cannot restore such a run's orbax checkpoint on
    this CPU: its remat init template holds literal leaves that orbax
    refuses, so the JAX side is its model applied directly.)"""
    run = copy_run(run_dir, tmp_path)
    text = (run / "config.yaml").read_text()
    assert "remat_backbone: false" in text
    (run / "config.yaml").write_text(text.replace("remat_backbone: false",
                                                  "remat_backbone: true"))
    ctx = runner.build_demo_context(str(run), device="cpu")
    assert ctx["predictor"].model.config.remat_backbone
    jcfg = jmm.MultiModalConfig.from_config(
        JConfig(**CFG, remat_backbone=True), num_classes=len(LABEL_COLS),
        text_override=JTextConfig(**TEXT, use_fused_attention=False))
    assert jcfg.remat_fusion and jcfg.swin.remat and jcfg.text.remat
    image, input_ids, mask = requests(ctx, ["q0", "q2"], ctx["records_by_id"])
    got = ctx["predictor"].embed(image, input_ids, mask)
    want = jax.jit(jax_serving_forward(jmm.MultiModalRetrievalModel(jcfg)))(
        {"model": run_dir[2]}, image, input_ids, mask)
    for key in ("probs", "joint_emb"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), err_msg=key, **TOL)


def test_run_dir_on_the_card_by_default(run_dir, tmp_path, monkeypatch, capsys):
    """No device argument: the card, and a clear error where there is none.
    A run with dtype_policy f32 is served: on the card in bf16, saying so in
    one line (the card's model stands in here: the build stops where it is
    asked for), and on the CPU in f32 with JAX's probs."""
    run, _, _ = run_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        MMRPredictor.from_run_dir(str(run))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    f32_run = copy_run(run_dir, tmp_path)
    text = (f32_run / "config.yaml").read_text()
    assert "dtype_policy: bf16" in text
    (f32_run / "config.yaml").write_text(text.replace("dtype_policy: bf16",
                                                      "dtype_policy: f32"))
    built = []

    class Built(Exception):
        pass

    def model_on_the_card(cfg, dtype, device):  # stands in for the card's model
        built.append((dtype, device))
        raise Built

    monkeypatch.setattr(runner, "MultiModalRetrievalModel", model_on_the_card)
    with pytest.raises(Built):
        runner.build_demo_context(str(f32_run))
    assert built == [(torch.bfloat16, torch.device("cuda"))]
    assert "dtype_policy 'f32': the card computes in bf16" in capsys.readouterr().out
    monkeypatch.undo()
    ctx = runner.build_demo_context(str(f32_run), device="cpu")
    assert next(ctx["predictor"].model.parameters()).dtype == torch.float32
    image, input_ids, mask = requests(ctx, ["q1"], ctx["records_by_id"])
    np.testing.assert_allclose(
        ctx["predictor"].predict(image, input_ids, mask)["probs"],
        jrunner.build_demo_context(str(f32_run))["predictor"].predict(
            image, input_ids, mask)["probs"], **TOL)


def test_load_rerank_inputs_explicit_data_dir(tmp_path, capsys):
    """records_cache.json: an explicit data dir wins, run.parent is the
    fallback, a miss warns; KG files only as a pair. The JAX function's
    outputs on each layout."""
    data = tmp_path / "data"
    data.mkdir()
    recs = [{"id": "r0", "labels": [1, 0, 1], "report_text": "t"}]
    (data / "records_cache.json").write_text(json.dumps({"records": recs}))
    run = tmp_path / "elsewhere" / "run"
    (run / "kg").mkdir(parents=True)

    def both(**kw):
        got = runner.load_rerank_inputs(run, **kw)
        out = capsys.readouterr().out
        want = jrunner.load_rerank_inputs(run, **kw)
        assert capsys.readouterr().out == out
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        return got, out

    (labels, records, kg), _ = both(data_dir=str(data))
    assert set(labels) == {"r0"} and records["r0"]["report_text"] == "t" and kg == {}
    (labels, records, kg), out = both()
    assert labels == {} and records == {} and "records_cache.json not found" in out
    np.save(run / "kg" / "node_embeddings.npy", np.ones((2, 3), np.float32))
    (_, _, kg), out = both(data_dir=str(data))
    assert kg == {} and "node2id.json missing" in out
    (run / "kg" / "node2id.json").write_text(json.dumps({"label:a": 0, "report:r0": 1}))
    (run.parent / "records_cache.json").write_text(json.dumps({"records": recs}))
    (labels, _, kg), _ = both()
    assert set(labels) == {"r0"} and kg["kg_node2id"] == {"label:a": 0, "report:r0": 1}


@pytest.fixture(scope="module")
def micro():
    """The micro model of tests/test_stream.py with randomized JAX weights,
    and the port model with the same weights."""
    jcfg = jmm.MultiModalConfig(
        swin=JSwinConfig.micro(use_pallas=False),
        text=JTextConfig.small(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64,
                               vocab_size=64),
        joint_dim=32, num_fusion_layers=1, num_heads=2, num_classes=5, max_text_len=8,
        dropout=0.0)
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    params = randomize(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 28, 28, 3)), jnp.zeros((2, 8), jnp.int32),
        jnp.ones((2, 8), jnp.int32))["params"])
    cfg = MultiModalConfig(
        swin=SwinConfig.micro(use_pallas=False),
        text=TextConfig.small(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64,
                              vocab_size=64),
        joint_dim=32, num_fusion_layers=1, num_heads=2, num_classes=5, max_text_len=8,
        dropout=0.0)
    model = MultiModalRetrievalModel(cfg, device="cpu").eval()
    load_flax_params(model, {"model": params})
    return jmodel, {"model": params}, model


def ingest_forms(batches, form, seed=5):
    """The batches with their images in one ingest form: f32 NHWC as given;
    uint8 (B, H, W) pixels; uint16 raw pixels with per-sample windows."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        b = dict(b)
        B = len(b["valid"])
        if form == "uint8":
            b["image"] = rng.integers(0, 256, (B, 28, 28)).astype(np.uint8)
        elif form == "uint16":
            b["image"] = rng.integers(0, 4096, (B, 28, 28)).astype(np.uint16)
            b["window_center"] = rng.uniform(1500, 2500, B).astype(np.float32)
            b["window_width"] = rng.uniform(600, 1500, B).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("form", ["float32", "uint8", "uint16"])
def test_stream_matches_jax(micro, form):
    """StreamingPipeline of both packages on the batches of
    tests/test_stream.py (the last with a padded row), at depth 2 and 1,
    in each ingest form."""
    jmodel, params, model = micro
    rng = np.random.default_rng(2)
    gallery = rng.standard_normal((64, 32)).astype(np.float32)
    gal_ids = [f"g{i}" for i in range(64)]
    th = np.full(5, 0.4, np.float32)
    names = [f"c{i}" for i in range(5)]
    batches = ingest_forms(_batches(), form)
    jpipe = jstream.StreamingPipeline(jmodel, params, JRetrievalEngine(gallery, gal_ids),
                                      label_names=names, threshold=th, K=7)
    want = list(jpipe.run(batches))
    pipe = stream.StreamingPipeline(model, RetrievalEngine(gallery, gal_ids, device="cpu"),
                                    label_names=names, threshold=th, K=7)
    for depth in (2, 1):
        got = list(pipe.run(batches, depth=depth))
        assert len(got) == len(want) == 3
        assert {k: v for k, v in pipe.stats.items() if k not in ("wall_s", "pairs_per_sec")} \
            == {"pairs": 11, "retrieval": True, "depth": depth, "mesh": None}
        assert jpipe.stats["pairs"] == 11
        for g, w in zip(got, want):
            assert g["ids"] == w["ids"] and g["predicted"] == w["predicted"]
            np.testing.assert_allclose(g["probs"], w["probs"], **TOL)
            np.testing.assert_allclose(g["joint_emb"], w["joint_emb"], **TOL)
            assert [[r for r, _ in row] for row in g["retrieval"]] == \
                [[r for r, _ in row] for row in w["retrieval"]]
            np.testing.assert_allclose([[s for _, s in row] for row in g["retrieval"]],
                                       [[s for _, s in row] for row in w["retrieval"]], **TOL)
    assert got[-1]["ids"] == ["q2_0", "q2_1", "q2_2"]


def test_run_stream_writes_the_jax_rows(run_dir, tmp_path):
    """run_stream of both packages over the run's test split (6 records at
    batch 4: the second batch padded): the same rows of predictions.jsonl
    and the same stream_stats.json keys."""
    run, data, _ = run_dir
    stats = stream.run_stream(str(run), str(data), out_dir=str(tmp_path / "port"), K=5,
                              device="cpu")
    jstats = jstream.run_stream(str(run), str(data), out_dir=str(tmp_path / "jax"), K=5)
    assert stats["pairs"] == jstats["pairs"] == N_QUERY and stats.keys() == jstats.keys()
    assert json.loads((tmp_path / "port" / "stream_stats.json").read_text()).keys() == \
        jstats.keys()

    def rows(side):
        return [json.loads(line) for line in
                (tmp_path / side / "predictions.jsonl").read_text().splitlines()]

    got, want = rows("port"), rows("jax")
    assert [r["id"] for r in got] == [r["id"] for r in want] == [f"q{i}" for i in range(6)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["predicted"] == w["predicted"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=1.1e-5)
        assert [r for r, _ in g["retrieval"]] == [r for r, _ in w["retrieval"]]
        np.testing.assert_allclose([s for _, s in g["retrieval"]],
                                   [s for _, s in w["retrieval"]], **TOL)


def test_engine_device_path_matches_jax(tmp_path):
    """from_files, then retrieve_batch_device (tensors left on the device)
    and finalize_batch, against the JAX engine; k past the gallery size."""
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((30, 16)).astype(np.float32)
    np.save(tmp_path / "e.npy", emb)
    (tmp_path / "ids.json").write_text(json.dumps([f"g{i}" for i in range(30)]))
    eng = RetrievalEngine.from_files(str(tmp_path / "e.npy"), str(tmp_path / "ids.json"),
                                     device="cpu")
    jeng = JRetrievalEngine.from_files(str(tmp_path / "e.npy"), str(tmp_path / "ids.json"))
    assert eng.ids == jeng.ids
    np.testing.assert_array_equal(eng.embeddings, jeng.embeddings)
    q = rng.standard_normal((5, 16)).astype(np.float32) * 3
    for k in (7, 40):
        s, i = eng.retrieve_batch_device(torch.from_numpy(q).to(torch.bfloat16), k)
        assert isinstance(s, torch.Tensor) and isinstance(i, torch.Tensor)
        assert s.dtype == torch.float32 and s.shape == (5, min(k, 30))
        js, ji = jeng.finalize_batch(*jeng.retrieve_batch_device(
            jnp.asarray(q, jnp.bfloat16), k))
        got_s, got_i = eng.finalize_batch(s, i)
        np.testing.assert_array_equal(got_i, ji)
        np.testing.assert_allclose(got_s, js, **TOL)


PAYLOAD = {
    "top_labels": [("cardiac", 0.9), ("<b>", 0.25)],
    "retrieval": [("id1", 0.8), ("id<2>", 0.5)],
    "images": {"attention": "QUJD"},
    "token_html": "<span>x</span>",
    "agreement": {"attn_vs_ig": {"pearson": 0.5, "spearman": 0.4, "iou@5%": 0.1,
                                 "iou@20%": 0.2}},
    "latency_ms": 12.0,
    "retrieval_detail": [{"id": "id1", "score": 0.8, "overlay": "QUJD",
                          "top_labels": [("a", 0.5)],
                          "agreement": {"attn_vs_ig": {"pearson": 0.1}},
                          "cross_map": {"pearson": 0.3, "iou@20%": 0.1}}],
    "retrieval_diversity": 0.4,
}


def multipart(boundary, payload, quoted=False):
    body = (f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="text_query"\r\n\r\nhello world\r\n'
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="dicom_file"; filename="a.dcm"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode() + payload \
        + f"\r\n--{boundary}--\r\n".encode()
    b = f'"{boundary}"' if quoted else boundary
    return body, f"multipart/form-data; boundary={b}; charset=utf-8"


def test_app_units_match_jax():
    """The demo's units are the JAX app's: PNG overlays byte for byte, the
    escaped token HTML, the multipart parser on a binary payload ending in
    CR / LF / '-' bytes with plain and quoted boundaries, and the rendered
    results page."""
    rng = np.random.default_rng(7)
    g, heat = rng.random((16, 16)), rng.random((16, 16))
    assert app._png_base64(g) == japp._png_base64(g)
    assert app._png_base64(g, heat) == japp._png_base64(g, heat)
    tok = app.token_attention_html(["<script>", "heart"], [0.9, 0.1])
    assert tok == japp.token_attention_html(["<script>", "heart"], [0.9, 0.1])
    assert "&lt;script&gt;" in tok and "<script>" not in tok
    for quoted in (False, True):
        body, ctype = multipart("XBOUND", b"PIXELDATA\x0a\x0d\x2d\x2d\x0a", quoted)
        fields = app._parse_multipart(body, ctype)
        assert fields == japp._parse_multipart(body, ctype)
        assert fields["dicom_file"] == b"PIXELDATA\x0a\x0d\x2d\x2d\x0a"
    with pytest.raises(ValueError, match="not multipart"):
        app._parse_multipart(b"x", "application/json")
    html = app.render_results(PAYLOAD)
    assert html == japp.render_results(PAYLOAD) and app.render_results({}) == ""
    for frag in ("cardiac", "&lt;b&gt;", "Similar cases", "Retrieved case detail",
                 "diversity", "12.0 ms"):
        assert frag in html


def post(port, path, data, ctype="application/json"):
    """(status, body) of one POST to the local demo."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_app_http_error_paths():
    """400 / 413 on malformed bodies before any model is touched, 404 off
    the routes, and /health, as the JAX demo answers."""
    import http.client
    import urllib.request

    server = app.serve(lambda: {}, port=0, block=False, host="127.0.0.1")
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert b'name="dicom_file"' in r.read()
        for body in (b"{nope", json.dumps({"text": "x"}).encode(),
                     json.dumps({"dicom_b64": "!!!"}).encode()):
            assert post(port, "/api/predict", body)[0] == 400
        assert post(port, "/", b"text_query=x", "application/x-www-form-urlencoded")[0] == 400
        body, ctype = multipart("BB", b"")
        assert post(port, "/", body.replace(b'name="dicom_file"', b'name="other"'),
                    ctype)[0] == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/api/predict")
        conn.putheader("Content-Length", str(100 * 1024 * 1024))
        conn.endheaders()
        conn.send(b"x")
        assert conn.getresponse().status == 413
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/nothing")
        assert conn.getresponse().status == 404
        conn.close()
    finally:
        server.shutdown()
        server.server_close()


def test_app_api_predict_round_trip_matches_jax(la_run):
    """POST /api/predict with one 16-bit DICOM, a report and detail=true to
    the port's demo and to the JAX demo, each over its build_demo_context of
    one run (LabelAttention pooler, gallery records with DICOM files): the
    same payload keys, labels, retrieval and detail ids in order, and its
    numbers: probabilities, scores and diversity within 1e-5, map agreement
    metrics (Pearson, Spearman) within 1e-4 and the IoUs within one pixel
    swapped at the top-k boundary (the maps agree at 1e-4 / 1e-5)."""
    run, want_ctx, ctx = la_run
    records = list(ctx["records_by_id"].values())
    q = next(r for r in records if r["id"] == "q1")
    request = json.dumps({"dicom_b64": base64.b64encode(
        open(q["dicom_path"], "rb").read()).decode(), "text": q["report_text"],
        "detail": True}).encode()
    servers = [japp.serve(lambda: want_ctx, port=0, block=False),
               app.serve(lambda: ctx, port=0, block=False, host="127.0.0.1")]
    try:
        (wcode, wbody), (code, body) = [post(srv.server_address[1], "/api/predict", request)
                                        for srv in servers]
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    assert code == wcode == 200, body
    got, want = json.loads(body), json.loads(wbody)
    assert got.keys() == want.keys() >= {"top_labels", "retrieval", "agreement",
                                         "retrieval_detail", "latency_ms"}
    assert got["latency_ms"] > 0 and len(got["retrieval"]) == 5

    def same_pairs(g, w):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w], **TOL)

    def same_metrics(g, w):
        assert g.keys() == w.keys()
        for name, metrics in w.items():
            assert g[name].keys() == metrics.keys()
            for key, value in metrics.items():
                k = max(1, int(784 * float(key[4:-1]) / 100)) if key.startswith("iou") else 0
                atol = 2 / (k + 1) if k else 1e-4
                np.testing.assert_allclose(g[name][key], value, rtol=0, atol=atol,
                                           err_msg=f"{name} {key}")

    for key in ("top_labels", "predicted", "retrieval"):
        same_pairs(got[key], want[key])
    same_metrics(got["agreement"], want["agreement"])
    assert len(got["retrieval_detail"]) == len(want["retrieval_detail"]) == 5
    for g, w in zip(got["retrieval_detail"], want["retrieval_detail"]):
        assert g["id"] == w["id"] and g.keys() == w.keys()
        np.testing.assert_allclose(g["score"], w["score"], **TOL)
        same_pairs(g["top_labels"], w["top_labels"])
        same_metrics({k: g[k] for k in ("cross_map", "cross_map_ig")},
                     {k: w[k] for k in ("cross_map", "cross_map_ig")})
        same_metrics(g["agreement"], w["agreement"])
    np.testing.assert_allclose(got["retrieval_diversity"], want["retrieval_diversity"], **TOL)
    assert got["retrieval_label_diversity"] == pytest.approx(want["retrieval_label_diversity"])
