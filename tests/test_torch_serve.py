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

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.data import native as jnative
from mmrp_tpu.labels import LABEL_COLS
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.retrieval.gallery import RetrievalEngine as JRetrievalEngine
from mmrp_tpu.serve import runner as jrunner
from mmrp_tpu.serve import stream as jstream
from mmrp_tpu.utils.checkpoint import CheckpointManager
from mmrp_tpu.utils.checkpoint import save_param_tree as jsave_param_tree
from mmrp_tpu_torch.api import MMRPredictor
from mmrp_tpu_torch.data.dicom import write_dicom
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.serve import runner, stream
from mmrp_tpu_torch.utils.convert import load_flax_params
from test_stream import _batches
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


@pytest.fixture(autouse=True)
def no_native_decoder(monkeypatch):
    """The JAX preprocessor on its Python path, as the port's always is."""
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """(run directory, data directory, the JAX params) of a micro run."""
    rng = np.random.default_rng(0)
    data = tmp_path_factory.mktemp("serve") / "data"
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


def test_run_dir_refuses_the_label_attention_pooler(run_dir, tmp_path):
    run = copy_run(run_dir, tmp_path)
    np.savez(run / "label_attention.npz", w=np.zeros(2))
    with pytest.raises(NotImplementedError, match="LabelAttention.*Queue 1 item 7"):
        runner.build_demo_context(str(run), device="cpu")
    (run / "kg" / "node2id.json").unlink()  # no KG: nothing to pool, no pooler
    assert runner.build_demo_context(str(run), device="cpu")["predictor"].reranker is not None


def test_run_dir_on_the_card_by_default(run_dir, tmp_path, monkeypatch):
    """No device argument: the card, and a clear error where there is none;
    an f32 dtype policy is refused on the card before anything is built."""
    run, _, _ = run_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        MMRPredictor.from_run_dir(str(run))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    (tmp_path / "config.yaml").write_text("dtype_policy: f32\n")
    with pytest.raises(ValueError, match="dtype_policy 'f32' cannot be served on the card"):
        runner.build_demo_context(str(tmp_path))


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
