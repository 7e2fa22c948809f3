"""The training pipeline: port against JAX on the CPU.

The metrics (batched, on a relevance matrix, and the classification ones),
``make_eval_step`` with ``patch_attention``, the ``remat_backbone`` step,
``CheckpointManager``, both packages' joint stage (``run_joint_training`` and
``dump_embeddings``) from the same weights, a resumed joint stage against the
uninterrupted one, ``eval/gt.py`` and ``eval/retrieval_eval.py`` on the same
embeddings, and
``run_training_pipeline`` on a tiny OpenI-format tree with the tiny config
of ``tests/test_end_to_end.py`` (``configs/config.yaml`` cut to a micro Swin,
one fusion layer and 16 tokens): the same artifact names as JAX's run, the
config read by both packages, and the run served by ``from_run_dir``, also
from its best checkpoint where the npz is stale or missing.

Tolerances: batched metrics 1e-6; the classification metrics, GT and the
list metrics exactly (the same numpy code); the eval step 2e-4 (f32 through
the tiny model, the LayerNorm variance in one pass against two); the joint
stage as its test states; the remat step, the resumed run and served probs
bit for bit (the same operations in the same order on the CPU).
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.eval import gt as jgt
from mmrp_tpu.eval import metrics as JM
from mmrp_tpu.eval import retrieval_eval as jre
from mmrp_tpu.retrieval.gallery import RetrievalEngine as JRetrievalEngine
from mmrp_tpu.train import joint as jjoint
from mmrp_tpu_torch.api import MMRPredictor, serving_forward
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.data.dataset import ChestXRDataset, build_dataloader
from mmrp_tpu_torch.data.dicom import write_dicom
from mmrp_tpu_torch.data.tokenizer import load_or_train_tokenizer
from mmrp_tpu_torch.eval import gt as tgt
from mmrp_tpu_torch.eval import metrics as TM
from mmrp_tpu_torch.eval import retrieval_eval as tre
from mmrp_tpu_torch.labels import LABEL_COLS
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.train import pipeline as tpipe
from mmrp_tpu_torch.train import runner as trunner
from mmrp_tpu_torch.train.joint import init_train_state, make_eval_step, make_train_step
from mmrp_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_data import no_native_decoder  # noqa: F401 (autouse)
from test_torch_train import step_batch, tiny_models

REPO = Path(__file__).resolve().parent.parent


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["precision_at_k_batch", "recall_at_k_batch",
                                  "average_precision_batch", "reciprocal_rank_batch",
                                  "ndcg_at_k_batch"])
def test_batched_metrics_match_jax(rng, name):
    rel = (rng.random((9, 10)) < 0.3).astype(np.float32)
    rel[0] = 0  # a query with nothing relevant retrieved
    n_rel = rng.integers(0, 6, 9).astype(np.float32) + rel.sum(1)
    n_rel[1] = 0
    args = {"precision_at_k_batch": lambda r, n: (r, 5),
            "recall_at_k_batch": lambda r, n: (r, n, 5),
            "average_precision_batch": lambda r, n: (r, n),
            "reciprocal_rank_batch": lambda r, n: (r,),
            "ndcg_at_k_batch": lambda r, n: (r, 7)}[name]
    want = getattr(JM, name)(*args(jnp.asarray(rel), jnp.asarray(n_rel)))
    got = getattr(TM, name)(*args(t(rel), t(n_rel)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_classification_metrics_match_jax(rng):
    y = (rng.random((40, 6)) < 0.3).astype(np.float32)
    y[:, 5] = 0  # a single-class column: NaN AUROC / AP
    p = rng.random((40, 6)).astype(np.float32)
    p[:10, 1] = 0.5  # ties
    th = TM.find_best_thresholds(y, p)
    np.testing.assert_array_equal(th, JM.find_best_thresholds(y, p))
    grid = np.linspace(0.05, 0.95, 19)
    np.testing.assert_array_equal(TM.find_best_thresholds(y, p, grid),
                                  JM.find_best_thresholds(y, p, grid))
    names = [f"c{i}" for i in range(6)]
    got, want = TM.per_class_report(y, p, th, names), JM.per_class_report(y, p, th, names)
    assert json.dumps(got, default=float) == json.dumps(want, default=float)
    assert TM.composite_score(got) == JM.composite_score(want)
    for c in range(6):
        for fn in ("safe_roc_auc", "safe_average_precision"):
            np.testing.assert_array_equal(getattr(TM, fn)(y[:, c], p[:, c]),
                                          getattr(JM, fn)(y[:, c], p[:, c]))
        assert TM.prf1(y[:, c], p[:, c] > 0.5) == JM.prf1(y[:, c], p[:, c] > 0.5)
    for a, b in zip(TM.pr_curve(y[:, 0], p[:, 0]), JM.pr_curve(y[:, 0], p[:, 0])):
        np.testing.assert_array_equal(a, b)


def test_logging_matches_jax(tmp_path, monkeypatch, capsys):
    """``MetricWriter`` (metrics.jsonl, run_config.json), ``TeeLogger`` and
    ``StepTimer`` write and return what JAX's do, byte for byte, on one
    clock given to both modules; the port's profiler writes a trace."""
    import types

    from mmrp_tpu.utils import logging as jlog
    from mmrp_tpu_torch.utils import logging as tlog

    def clock():
        ticks = iter([10.0, 10.5, 11.25, 11.5])
        return types.SimpleNamespace(time=lambda: 1.5e9, perf_counter=lambda: next(ticks))

    out = {}
    for name, mod in (("jax", jlog), ("port", tlog)):
        monkeypatch.setattr(mod, "time", clock())
        d = tmp_path / name
        w = mod.MetricWriter(str(d), "run", {"lr": 1e-3, "path": Path("x")})
        w.log({"loss": np.float32(0.25), "tag": "a"})
        w.log({"loss": torch.tensor(0.5) if name == "port" else jnp.asarray(0.5)}, step=7)
        w.log({"n": 3})
        w.close()
        capsys.readouterr()
        mod.TeeLogger(str(d / "sub" / "report.txt"))("line one")
        printed = capsys.readouterr().out
        timer = mod.StepTimer(total_steps=5)
        out[name] = ([(d / f).read_bytes() for f in ("metrics.jsonl", "run_config.json",
                                                       "sub/report.txt")],
                     printed, [timer.tick() for _ in range(4)])
    assert out["port"] == out["jax"]
    assert out["port"][2][-1]["eta_s"] > 0
    tlog.start_profiler(str(tmp_path / "trace"))
    with pytest.raises(RuntimeError, match="already running"):
        tlog.start_profiler(str(tmp_path / "trace"))
    torch.ones(4).sum()
    tlog.stop_profiler()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())


# ---------------------------------------------------------------------------
# eval step, remat
# ---------------------------------------------------------------------------


def tbatch_of(batch):
    out = {k: t(v) for k, v in batch.items()}
    out["input_ids"] = out["input_ids"].long()
    out["attention_mask"] = out["attention_mask"].long()
    return out


def test_eval_step_with_patch_attention_matches_jax():
    jmodel, jparams, model, _ = tiny_models()
    batch = step_batch()
    want = jjoint.make_eval_step(jmodel, return_attention=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(model, return_attention=True)(tbatch_of(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    assert got["patch_attention"].shape == (4, 49)
    # rows average to 1 over the patches: softmax weights, masked text averaged
    np.testing.assert_allclose(got["patch_attention"].sum(1).numpy(), 1.0, rtol=1e-5)
    # without the weights, the fusion layers take their kernel routes (plain
    # versions here): the same function, summed in other orders
    plain = make_eval_step(model)(tbatch_of(batch))
    assert set(plain) == {"probs", "joint_emb", "img_emb", "txt_emb"}
    torch.testing.assert_close(plain["joint_emb"], got["joint_emb"], rtol=1e-5, atol=1e-5)


def test_remat_step_matches_the_plain_step():
    """remat_backbone: every Swin block, BERT layer and fusion layer under
    activation checkpointing, dropout 0.1 and drop path 0.1 (their masks
    replayed in the backward): two steps' metrics and every master bit-equal
    to the same model without remat."""
    import dataclasses

    _, _, base, kg_proj = tiny_models(seed=3)
    cfg = Config(lr=1e-3, adam_mu_bf16=False)
    runs = []
    for remat in (False, True):
        mcfg = dataclasses.replace(
            base.config, remat_backbone=remat, dropout=0.1, drop_path=0.1,
            swin=dataclasses.replace(base.config.swin, drop_path_rate=0.1),
            text=dataclasses.replace(base.config.text, dropout=0.1))
        model = MultiModalRetrievalModel(mcfg, device="cpu")
        model.load_state_dict(base.state_dict())
        state = init_train_state(model, cfg, total_steps=4, kg_dim=kg_proj.shape[1])
        state.params["kg_proj"].copy_(kg_proj)
        step = make_train_step(model, cfg)
        metrics = [step(state, tbatch_of(step_batch(seed=s)))[1] for s in (3, 4)]
        runs.append((metrics, state))
    assert runs[0][0] == runs[1][0]
    assert runs[0][0][1]["loss/total"] != runs[0][0][0]["loss/total"]
    for name, m in runs[0][1].params.items():
        assert torch.equal(m, runs[1][1].params[name]), name


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_manager_save_restore_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.best_metrics() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    states = {s: {"w": torch.full((3,), float(s)), "n": torch.tensor(s),
                  "sub": {"m": np.full(2, s, np.float32)}} for s in range(4)}
    for s, st in states.items():
        mgr.save(s, st)
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt" / "steps").iterdir()) == ["2", "3"]
    got = mgr.restore(states[0])
    assert torch.equal(got["w"], states[3]["w"]) and int(got["n"]) == 3
    assert torch.equal(mgr.restore(step=2)["sub"]["m"], torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(4), "n": torch.tensor(0), "sub": {"m": np.zeros(2)}})
    with pytest.raises(ValueError, match="keys"):
        mgr.restore({"w": torch.zeros(3)})
    assert mgr.update_best(0.5, {"w": torch.ones(2)}, {"epoch": 1})
    assert not mgr.update_best(0.4, {"w": torch.zeros(2)}, {"epoch": 2})
    assert mgr.update_best(0.7, {"w": torch.full((2,), 7.0)}, {"epoch": 3})
    assert torch.equal(mgr.restore_best()["w"], torch.full((2,), 7.0))
    assert mgr.best_metrics() == {"_best_value": 0.7, "epoch": 3}
    assert not (tmp_path / "ckpt" / "best.tmp").exists()
    # a new manager reads the best value back; lower-is-better updates
    again = CheckpointManager(str(tmp_path / "ckpt"))
    assert not again.update_best(0.6, {"w": torch.zeros(2)}, {})
    assert again.update_best(0.6, {"w": torch.zeros(2)}, {}, higher_better=False)


# ---------------------------------------------------------------------------
# the tiny OpenI-format tree and the joint stage
# ---------------------------------------------------------------------------

TEXTS = ["Cardiomegaly with small left pleural effusion.", "No acute disease. Clear lungs.",
         "Right lower lobe pneumonia with consolidation.",
         "Degenerative change of the thoracic spine.", "Stable cardiomegaly. No pneumothorax.",
         "Atelectasis at the left base with volume loss.",
         "Hyperinflation consistent with emphysema.", "Normal chest. No effusion or pneumothorax."]
# tests/test_end_to_end.py's cuts of configs/config.yaml, one Swin finetune
# epoch, and one KG and LabelAttention epoch
TINY = dict(image_backbone="swin_micro", image_size=28, joint_dim=32, num_fusion_layers=1,
            num_heads=2, text_dim=16, batch_size=4, epochs=2, patience=3, kg_epochs=1,
            kg_emb_dim=16, kg_neg_size=4, lr=1e-3, use_pallas_attention=False, augment=False,
            kg_model="TransE", la_epochs=1, swin_finetune_epochs=1, data_workers=0)


def make_tree(root: Path, n=24, seed=11) -> Path:
    """records_cache.json (24 records, labels seeded), splits and 16-bit
    DICOM files of 40 x 40, as the data CLI leaves them."""
    rng = np.random.default_rng(seed)
    (root / "dcm").mkdir(parents=True)
    (root / "splits").mkdir()
    recs = []
    for i in range(n):
        rid = str(i + 1)
        path = root / "dcm" / f"{rid}.dcm"
        write_dicom(path, (rng.random((40, 40)) * 2000).astype(np.uint16), window_center=1000,
                    window_width=2000)
        labels = (rng.random(len(LABEL_COLS)) < 0.15).astype(int).tolist()
        recs.append({"id": rid, "report_text": f"{TEXTS[i % 8]} Study number {i + 1}.",
                     "labels": labels, "dicom_path": str(path)})
    (root / "records_cache.json").write_text(json.dumps({"records": recs}))
    ids = [r["id"] for r in recs]
    for name, part in (("train", ids[:14]), ("val", ids[14:19]), ("test", ids[19:])):
        (root / "splits" / f"{name}_ids.json").write_text(json.dumps(part))
    return root


def tiny_config(cls, **kw):
    raw = yaml.safe_load((REPO / "configs" / "config.yaml").read_text())
    raw.update(TINY, **kw)
    names = {f.name for f in __import__("dataclasses").fields(cls) if f.init}
    return cls(**{k: v for k, v in raw.items() if k in names})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("openi"))


JAX_RUN = """
import sys
from mmrp_tpu.config import Config
from mmrp_tpu.data import native
from mmrp_tpu.train.runner import run_training_pipeline
from test_torch_pipeline import tiny_config
native.available = lambda: False  # the Python decode, as the port's side (no_native_decoder)
run_training_pipeline(tiny_config(Config), sys.argv[1], sys.argv[2])
"""


@pytest.fixture(scope="module", autouse=True)
def jax_run(tree):
    """JAX's run of the tree in a subprocess, started before the module's
    first test so that the port's tests run beside it (about a minute of
    JAX compiles on the CPU); the run directory once it has ended."""
    out = tree / "jax_run"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_RUN, str(tree), str(out)], env=env,
                            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def finished():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        return out

    yield finished
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def joint_loaders(tree, cfg):
    recs = {r["id"]: r for r in json.loads((tree / "records_cache.json").read_text())["records"]}
    split = {n: [recs[i] for i in json.loads((tree / "splits" / f"{n}_ids.json").read_text())]
             for n in ("train", "val")}
    tok = load_or_train_tokenizer(str(tree / "vocab_joint.txt"),
                                  corpus=(r["report_text"] for r in recs.values()))
    ds = {n: ChestXRDataset(v, tok, max_length=cfg.text_dim, image_size=cfg.image_size)
          for n, v in split.items()}
    return (build_dataloader(ds["train"], cfg.batch_size, weighted=True, seed=cfg.seed),
            build_dataloader(ds["val"], cfg.batch_size, shuffle=False))


def jax_joint_loaders(tree, cfg):
    """JAX's loaders of the same records, with the vocab ``joint_loaders``
    wrote: the same data order (the weighted sampler seeded from cfg.seed)."""
    from mmrp_tpu.data.dataset import ChestXRDataset as JDataset
    from mmrp_tpu.data.dataset import build_dataloader as jbuild
    from mmrp_tpu.data.tokenizer import load_or_train_tokenizer as jtok

    recs = {r["id"]: r for r in json.loads((tree / "records_cache.json").read_text())["records"]}
    split = {n: [recs[i] for i in json.loads((tree / "splits" / f"{n}_ids.json").read_text())]
             for n in ("train", "val", "test")}
    tok = jtok(str(tree / "vocab_joint.txt"))
    ds = {n: JDataset(v, tok, max_length=cfg.text_dim, image_size=cfg.image_size)
          for n, v in split.items()}
    return (jbuild(ds["train"], cfg.batch_size, weighted=True, seed=cfg.seed),
            jbuild(ds["val"], cfg.batch_size, shuffle=False),
            jbuild(ds["test"], cfg.batch_size, shuffle=False))


def no_dropout(mcfg):
    """A MultiModalConfig (either package's) with every dropout and drop
    path rate at 0: the two steps then draw nothing."""
    import dataclasses

    def zero(c):
        return dataclasses.replace(c, **{f.name: 0.0 for f in dataclasses.fields(c)
                                         if f.name in ("dropout", "drop_path",
                                                       "drop_path_rate")})

    return dataclasses.replace(zero(mcfg), swin=zero(mcfg.swin), text=zero(mcfg.text))


def test_joint_training_matches_jax(tree, tmp_path, monkeypatch):
    """Both packages' ``run_joint_training`` on the tree for 3 epochs from the
    same weights (JAX's init, carried into the port through ``warm_start``),
    dropout and drop path 0, the same data order: every step's losses, each
    epoch's validation (F1-optimal thresholds, composite), the best epoch and
    its artifacts (``thresholds.npy``, ``best_multimodal_metrics.json``,
    ``val_per_class.json``, ``val_embeddings`` / ``val_attention`` /
    ``val_ids``), the returned best weights with ``kg_proj``, the checkpoint
    layout, and ``dump_embeddings`` of the best model. In both packages the
    last epoch's composite is lowered by 1 (the same seam in each), so an
    earlier epoch is the best and both return its weights, not the last.
    Tolerances (f32 on the CPU): losses rtol 1e-4; thresholds, attention and
    metrics atol 2e-4; embeddings (values of order 1) atol 5e-4; weights atol
    1e-4, but a key projection's bias 2 lr per step taken, since Adam's
    normalised update moves a weight whose gradient is zero up to rounding
    by up to the learning rate per step whichever way the rounding tips its
    sign; ids, epochs and file names exactly."""
    import dataclasses

    import jax

    from mmrp_tpu.models.multimodal import MultiModalConfig as JMMConfig
    from mmrp_tpu.models.multimodal import MultiModalRetrievalModel as JModel
    from mmrp_tpu.train import pipeline as jpipe
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig
    from mmrp_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax_flat

    losses = {"jax": [], "port": []}
    for mod, key in ((jpipe, "jax"), (tpipe, "port")):
        def recording(*a, _real=mod.make_train_step, _key=key, **kw):
            step = _real(*a, **kw)

            def run(state, batch):
                state, m = step(state, batch)
                losses[_key].append({k: float(v) for k, v in m.items()
                                     if k.startswith("loss/")})
                return state, m
            return run
        monkeypatch.setattr(mod, "make_train_step", recording)

    for mod in (jpipe, tpipe):
        def lowered(rep, _real=mod.composite_score, _seen=[]):
            _seen.append(1)
            return _real(rep) - (1.0 if len(_seen) == 3 else 0.0)
        monkeypatch.setattr(mod, "composite_score", lowered)

    cfg = tiny_config(Config, epochs=3, patience=10)
    jcfg = tiny_config(JConfig, epochs=3, patience=10)
    t_train, t_val = joint_loaders(tree, cfg)
    j_train, j_val, j_test = jax_joint_loaders(tree, jcfg)
    jmodel = JModel(no_dropout(JMMConfig.from_config(jcfg, len(LABEL_COLS))))
    # the init that JAX's init_train_state calls, jitted: eagerly it takes
    # about 17 s on the CPU (the instance attribute shadows the method)
    object.__setattr__(jmodel, "init", jax.jit(jmodel.init, static_argnames=("deterministic",)))
    init = {}

    def jax_warm(params):
        init["params"] = jax.device_get(params)
        return params

    jres = jpipe.run_joint_training(jcfg, jmodel, j_train, j_val, str(tmp_path / "jax"),
                                    kg_dim=8, class_names=LABEL_COLS, warm_start=jax_warm)
    model = MultiModalRetrievalModel(
        no_dropout(MultiModalConfig.from_config(cfg, len(LABEL_COLS))), device="cpu")

    def port_warm(masters):
        src = flax_to_state_dict(init["params"])
        assert set(src) == set(masters)
        with torch.no_grad():
            for k, v in masters.items():
                v.copy_(src[k])

    res = tpipe.run_joint_training(cfg, model, t_train, t_val, str(tmp_path / "port"),
                                   kg_dim=8, class_names=LABEL_COLS, warm_start=port_warm)

    assert len(losses["port"]) == len(losses["jax"]) == 12  # 3 epochs of 4 batches
    for i, (got, want) in enumerate(zip(losses["port"], losses["jax"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jbest = json.loads((jout / "best_multimodal_metrics.json").read_text())
    tbest = json.loads((tout / "best_multimodal_metrics.json").read_text())
    assert tbest.keys() == jbest.keys() and tbest["epoch"] == jbest["epoch"] < 2
    for k in jbest:
        np.testing.assert_allclose(tbest[k], jbest[k], atol=2e-4, err_msg=k)
    assert res.best_metrics == tbest
    for name, atol in (("thresholds.npy", 2e-4), ("val_attention.npy", 2e-4),
                       ("val_embeddings.npy", 5e-4)):
        np.testing.assert_allclose(np.load(tout / name), np.load(jout / name), atol=atol,
                                   err_msg=name)
    np.testing.assert_array_equal(res.thresholds, np.load(tout / "thresholds.npy"))
    assert (tout / "val_ids.json").read_text() == (jout / "val_ids.json").read_text()
    jpc = json.loads((jout / "val_per_class.json").read_text())
    tpc = json.loads((tout / "val_per_class.json").read_text())
    assert [sorted(c) for c in tpc] == [sorted(c) for c in jpc]
    for tc, jc in zip(tpc, jpc):
        for k, v in jc.items():
            if isinstance(v, str):
                assert tc[k] == v
            else:
                np.testing.assert_allclose(tc[k], v, atol=2e-4, err_msg=f"per class {k}")
    for ckpt in (tout, jout):
        assert sorted(p.name for p in (ckpt / "ckpt" / "steps").iterdir()) == ["0", "1", "2"]
    # the returned state holds the best epoch's weights, kg_proj included,
    # not the last epoch's
    want = flax_to_state_dict(jax.device_get(jres.state.params))
    assert set(want) == set(res.state.params)
    steps = 4 * (tbest["epoch"] + 1)
    for k, v in want.items():
        # a key projection's bias (in Swin's fused qkv too) has a gradient
        # that is zero up to rounding: up to 2 lr per step either way
        bound = 2 * cfg.lr * steps if k.endswith(("key.bias", "qkv.bias")) else 1e-4
        assert np.abs(res.state.params[k].numpy() - v.numpy()).max() <= bound, k
    last = CheckpointManager(str(tout / "ckpt")).restore()["params"]
    assert not all(torch.equal(res.state.params[k], v) for k, v in last.items())
    flat = state_dict_to_flax_flat(model)
    for k, v in state_dict_to_flax_flat(model, res.state.params).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # the gallery dump of the best model
    test_loader = build_dataloader(dataclasses.replace(t_val.ds, records=j_test.ds.records),
                                   cfg.batch_size, shuffle=False)
    jpipe.dump_embeddings(jmodel, jres.state.params, j_test, str(jout / "test"))
    tpipe.dump_embeddings(model, test_loader, str(tout / "test"))
    np.testing.assert_allclose(np.load(tout / "test_embeddings.npy"),
                               np.load(jout / "test_embeddings.npy"), atol=5e-4)
    assert (tout / "test_ids.json").read_text() == (jout / "test_ids.json").read_text()


class Killed(Exception):
    """A run stopped from outside between two steps."""


def test_resumed_run_continues_as_the_uninterrupted_run(tree, tmp_path, monkeypatch, capsys):
    """The joint stage for 3 epochs, against the same run killed at the first
    step of epoch 1 and started again with ``cfg.resume`` (a new model): the
    state the resumed run's first step is given is the one saved after epoch
    0 (masters, Adam moments and count, seed), the run says it continues at
    epoch 1 after step 4, and the losses of every step after the resume, the
    final masters, the best metrics and the thresholds are the uninterrupted
    run's, bit for bit."""
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig

    losses = []
    kill = {"at": None}
    first_step = {}  # fn(state), called with the state of a run's first step
    real = tpipe.make_train_step

    def recording(model, cfg, pw):
        step = real(model, cfg, pw)
        check = first_step.pop("check", None)

        def run(state, batch):
            nonlocal check
            if check is not None:
                check(state)
                check = None
            if len(losses) == kill["at"]:
                raise Killed("the run is killed here")
            state, m = step(state, batch)
            losses.append(m["loss/total"])
            return state, m

        return run

    monkeypatch.setattr(tpipe, "make_train_step", recording)

    def run(out, resume=False):
        cfg = tiny_config(Config, epochs=3, resume=resume, patience=10)
        model = MultiModalRetrievalModel(MultiModalConfig.from_config(cfg, len(LABEL_COLS)),
                                         device="cpu")
        res = tpipe.run_joint_training(cfg, model, *joint_loaders(tree, cfg), str(out),
                                       kg_dim=8, class_names=LABEL_COLS)
        return res, model

    full, full_model = run(tmp_path / "full")
    full_losses = list(losses)
    cut_steps = 4  # one epoch of 14 records at batch 4
    losses.clear()
    kill["at"] = cut_steps
    with pytest.raises(Killed):
        run(tmp_path / "cut")
    kill["at"] = None
    assert losses == full_losses[:cut_steps]
    saved = CheckpointManager(str(tmp_path / "cut" / "ckpt")).restore()
    restored = {}

    def check(state):
        restored["count"] = state.count
        for k, v in saved["params"].items():
            assert torch.equal(state.params[k], v), k
            assert torch.equal(state.mu[k], saved["opt_state"]["mu"][k]), k
            assert torch.equal(state.nu[k], saved["opt_state"]["nu"][k]), k
        assert state.seed == int(saved["base_rng"])

    first_step["check"] = check
    capsys.readouterr()
    resumed, model = run(tmp_path / "cut", resume=True)
    assert restored == {"count": cut_steps}
    assert f"[resume] continuing from epoch 1 (step {cut_steps})" in capsys.readouterr().out
    assert losses == full_losses
    for k, v in full.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k
    assert resumed.best_metrics == full.best_metrics
    np.testing.assert_array_equal(resumed.thresholds, full.thresholds)
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(full_model.named_parameters())[name]), name


# ---------------------------------------------------------------------------
# GT and retrieval eval
# ---------------------------------------------------------------------------


def test_gt_and_retrieval_eval_match_jax(rng, tmp_path):
    ids = [f"q{i}" for i in range(12)]
    gids = [f"g{i}" for i in range(30)] + ids[:4]
    ql = (rng.random((12, 8)) < 0.3).astype(int)
    gl = (rng.random((34, 8)) < 0.3).astype(int)
    adj = jgt.ontology_label_adjacency([f"l{i}" for i in range(8)],
                                       {"l0": ["D:1"], "l1": ["D:1"], "l2": ["D:2"]},
                                       [("D:2", "D:3")])
    np.testing.assert_array_equal(
        tgt.ontology_label_adjacency([f"l{i}" for i in range(8)],
                                     {"l0": ["D:1"], "l1": ["D:1"], "l2": ["D:2"]},
                                     [("D:2", "D:3")]), adj)
    for kw in (dict(), dict(min_shared=2), dict(label_adjacency=adj)):
        g = tgt.build_label_overlap_gt(ids, ql, gids, gl, **kw)
        assert g == jgt.build_label_overlap_gt(ids, ql, gids, gl, **kw)
    gt_a = tgt.build_label_overlap_gt(ids, ql, gids, gl)
    gt_b = tgt.build_label_overlap_gt(ids, ql, ids, ql, out_path=str(tmp_path / "gt.json"))
    assert json.loads((tmp_path / "gt.json").read_text()) == gt_b
    q = rng.standard_normal((12, 16)).astype(np.float32)
    gal = rng.standard_normal((34, 16)).astype(np.float32)
    gal[30:] = q[:4] + 0.01
    strip = lambda r: {p: {k: v for k, v in m.items() if not k.endswith("_ms")}  # noqa: E731
                       for p, m in r.items()}
    got = tre.dual_gallery_eval(RetrievalEngine(q, ids, device="cpu"),
                                RetrievalEngine(gal, gids, device="cpu"), q, ids, gt_b, gt_a,
                                out_dir=str(tmp_path / "port"))
    want = jre.dual_gallery_eval(JRetrievalEngine(q, ids), JRetrievalEngine(gal, gids), q, ids,
                                 gt_b, gt_a, out_dir=str(tmp_path / "jax"))
    assert strip(got) == strip(want)
    assert all(np.isfinite(got[p]["p50_ms"]) for p in got)
    assert json.loads((tmp_path / "port" / "retrieval_results.json").read_text()).keys() == \
        want.keys()
    pq = tre.evaluate_gallery(RetrievalEngine(gal, gids, device="cpu"), q, ids, gt_a,
                              per_query=True, time_queries=False)
    assert pq == jre.evaluate_gallery(JRetrievalEngine(gal, gids), q, ids, gt_a,
                                      per_query=True, time_queries=False)
    got = tre.embedding_rank_eval(q, ids, gal, gids, gt_a, device="cpu")
    if not torch.cuda.is_available():  # on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="embedding_rank_eval: no CUDA device"):
            tre.embedding_rank_eval(q, ids, gal, gids, gt_a)
    want = jre.embedding_rank_eval(q, ids, gal, gids, gt_a)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# run_training_pipeline
# ---------------------------------------------------------------------------


def files_under(root: Path):
    """Relative paths of a run directory's files, the joint checkpoints'
    insides (orbax's or the port's own format) left out."""
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()
                  and "ckpt" not in p.relative_to(root).parts)


@pytest.fixture(scope="module")
def port_run(tree):
    """The port's run of the tree, and the joint model it trained (kept from
    the joint stage, which the runner passes it to)."""
    cfg = tiny_config(Config)
    out = tree / "port_run"
    kept = []

    def keep(c, model, *a, **kw):
        kept.append(model)
        return real(c, model, *a, **kw)

    real = tpipe.run_joint_training
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "run_joint_training", keep)
        summary = trunner.run_training_pipeline(cfg, str(tree), str(out), device="cpu")
    return cfg, out, summary, kept[0]


def serve_and_check(run: Path, model):
    """from_run_dir on the CPU: each train record's own gallery row at rank 1
    (no rerank), probs bit-identical to the in-process model's."""
    pred = MMRPredictor.from_run_dir(str(run), device="cpu")
    tree = run.parent
    recs = {r["id"]: r for r in json.loads((tree / "records_cache.json").read_text())["records"]}
    ids = json.loads((run / "train_ids.json").read_text())[:4]
    ds = ChestXRDataset([recs[i] for i in ids], pred_tok(run), max_length=16, image_size=28)
    items = [ds[i] for i in range(len(ids))]
    image = np.stack([s["image"] for s in items])
    tok_ids = np.stack([s["input_ids"] for s in items]).astype(np.int64)
    mask = np.stack([s["attention_mask"] for s in items]).astype(np.int64)
    got = pred.predict(image, tok_ids, mask, K=3, retrieve=False)
    want = serving_forward(model)(t(image), t(tok_ids), t(mask))
    np.testing.assert_array_equal(got["probs"], want["probs"].numpy())
    for b, rid in enumerate(ids):
        assert pred.retrieve(got["joint_emb"][b], K=1, rerank=False)[0][0] == rid
    return pred


def pred_tok(run):
    from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_vocab_file(str(run / "vocab.txt"))


def test_port_run_is_served_by_from_run_dir(port_run):
    """The run as written (``joint/params.npz``); then, repaired run-directory
    check, a copy whose npz is older than its best checkpoint and one without
    the npz: both served from the port's best checkpoint with the same
    probs. A JAX-style orbax best newer than the npz still raises, naming
    the conversion a JAX host runs."""
    _, out, _, model = port_run
    pred = serve_and_check(out, model)
    assert np.asarray(pred.threshold).shape == (len(LABEL_COLS),)
    stale = out.parent / "stale_run"  # beside the run: the same records_cache.json
    shutil.copytree(out, stale)
    npz = stale / "joint" / "params.npz"
    past = time.time() - 100
    os.utime(npz, (past, past))
    serve_and_check(stale, model)
    npz.unlink()
    serve_and_check(stale, model)
    shutil.copyfile(out / "joint" / "params.npz", npz)
    os.utime(npz, (past, past))
    best = stale / "joint" / "ckpt" / "best"
    shutil.rmtree(best)
    (best / "state").mkdir(parents=True)
    (best / "state" / "_METADATA").write_text("{}")
    with pytest.raises(RuntimeError, match="JAX host"):
        MMRPredictor.from_run_dir(str(stale), device="cpu")


def test_run_training_pipeline_writes_the_jax_run_directory(tree, port_run, jax_run, tmp_path):
    """The same files as JAX's run of the same tree and config (the joint
    checkpoints' formats aside; the port adds ``joint/params.npz``, the
    weights it serves), byte for byte where a file does not depend on the
    weights (the vocab, the KG builder's graph, the split ids of the
    validation set and the gallery dumps, the resolved model shape), the
    summary's metrics in [0, 1], a duplicate-free gallery, and a
    ``config.yaml`` both packages read back. The two runs start from each
    package's own seeded init, so their numbers differ; each stage's numbers
    are held to JAX's from the same weights by its own test (the joint stage
    above, the finetune, KG and LabelAttention trainers in
    ``test_torch_finetune.py`` and ``test_torch_kg.py``)."""
    cfg, out, summary, _ = port_run
    jout = jax_run()
    assert files_under(out) == sorted(files_under(jout) + ["joint/params.npz"])
    for name in ("vocab.txt", "kg/triples.csv", "kg/node2id.json", "kg/relation2id.json",
                 "kg/entity_meta.json", "joint/val_ids.json", "test_ids.json",
                 "train_ids.json", "model_config.json"):
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name
    for ckpt in (out, jout):
        assert sorted(p.name for p in (ckpt / "joint" / "ckpt").iterdir()) == \
            ["best", "best_metrics.json", "steps"]
        assert sorted(p.name for p in (ckpt / "joint" / "ckpt" / "steps").iterdir()) == ["0", "1"]
    assert np.isfinite(summary["joint"]["composite"])
    for proto in ("generalization", "historical"):
        for m in ("P@10", "mAP", "MRR", "nDCG@10"):
            assert 0.0 <= summary["retrieval"][proto][m] <= 1.0
    assert summary == json.loads((out / "pipeline_summary.json").read_text())
    train_ids = json.loads((out / "train_ids.json").read_text())
    assert len(train_ids) == len(set(train_ids)) == 14
    assert Config.load(str(out / "config.yaml")) == cfg
    jcfg = JConfig.load(str(out / "config.yaml"))
    for f in __import__("dataclasses").fields(cfg):
        assert getattr(jcfg, f.name) == getattr(cfg, f.name), f.name
    assert json.loads((out / "model_config.json").read_text()).keys() == \
        json.loads((jout / "model_config.json").read_text()).keys()
    # a checkpoint name that is no local path: nothing is fetched
    with pytest.raises(FileNotFoundError, match="fetches nothing"):
        trunner.run_training_pipeline(Config(pretrained_swin="x"), str(tree),
                                      str(tmp_path / "no"), device="cpu")


def test_variant_eval_matches_jax(rng):
    """The reranker ablations over one gallery, each variant reranked by the
    package's own Reranker, with the paired tests against the baseline."""
    from mmrp_tpu.retrieval.rerank import Reranker as JReranker
    from mmrp_tpu_torch.retrieval.rerank import Reranker

    ids = [f"q{i}" for i in range(10)]
    gids = [f"g{i}" for i in range(40)]
    labels = {i: (rng.random(6) < 0.4).astype(int) for i in ids + gids}
    gt = tgt.build_label_overlap_gt(ids, np.stack([labels[i] for i in ids]), gids,
                                    np.stack([labels[i] for i in gids]))
    q = rng.standard_normal((10, 8)).astype(np.float32)
    gal = rng.standard_normal((40, 8)).astype(np.float32)
    names = [f"l{i}" for i in range(6)]

    def factory(cls):
        return lambda a, b, c: cls(alpha=a, beta=b, gamma=c, labels_by_id=labels,
                                   label_names=names)

    got = tre.variant_eval(RetrievalEngine(gal, gids, device="cpu"), q, ids, gt,
                           factory(Reranker), k=5)
    want = jre.variant_eval(JRetrievalEngine(gal, gids), q, ids, gt, factory(JReranker), k=5)
    strip = lambda r: json.loads(json.dumps(  # noqa: E731
        {v: {k: x for k, x in m.items() if not k.endswith("_ms")} for v, m in r.items()},
        default=float))
    assert strip(got) == strip(want)
    assert set(got) == {"baseline", "kg_only", "la_only", "kg_la", "full"}
