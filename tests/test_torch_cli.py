"""The Quick start through the port's CLI, against JAX's, on the CPU.

``python -m mmrp_tpu_torch.cli`` and ``python -m mmrp_tpu.cli`` on the same
inputs: ``data`` on an OpenI-layout tree (the XML reports and 16-bit DICOM
files of ``tests/test_end_to_end.py``) writes the same records, splits, EDA
JSONs and phrase check; ``eval-cls``, ``eval-ret --variants``, ``kg-probe``
and ``mapper`` write the same reports (timings aside; real values within
1e-6). The port's ``train`` on its own ``data`` output (the tiny config of
``tests/test_end_to_end.py``, ``--device cpu``), then ``calibrate``,
``stream``, ``parity`` and ``serve`` on that run; ``bench`` exits 2, naming
its ROADMAP item, and ``export-serving --platforms cpu`` on the run below
prints JAX's meta.

Then both packages' ``run_parity`` on one run directory that both read,
written as ``tests/test_torch_serve.py`` writes it (orbax for JAX, npz for
the port), with the test split as its gallery so that each explained
query's top-1 neighbour is a test record whose map can be compared. JAX's
side runs in a subprocess started before the module's first test.
``parity_results.json``: rank-based metrics (precision, recall, mAP, MRR,
nDCG, hit rates, AUROC, the top-k overlaps) equal, real-valued ones within
1e-4 (the micro model in f32 through both packages), explain-alignment
correlations within 1e-3 (maps through a softmax and an upsampling),
timings and paths aside.
"""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mmrp_tpu import cli as jcli
from mmrp_tpu_torch import cli
from mmrp_tpu_torch.config import Config, dump_flat_yaml
from mmrp_tpu_torch.eval.gt import build_label_overlap_gt
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.serve.exported import ExportedPredictor
from mmrp_tpu_torch.serve.runner import build_demo_context
from test_torch_data import no_native_decoder  # noqa: F401 (autouse)
from test_torch_data_tools import openi_tree
from test_torch_eval_tools import close, cls_inputs
from test_torch_pipeline import REPO, tiny_config
from test_torch_serve import write_run_dir

# keys of timings and of paths, which differ between any two runs
NOT_COMPARED = ("_ms", "ms_", "wall_s", "latency", "qps", "seconds", "run_dir", "plots",
                "_csv")
PARITY_SECTIONS = ("classification", "retrieval", "variants", "embedding_rank",
                   "explain_alignment", "diversity", "kg_health")
K, EXPLAIN_N = 3, 2


JAX_PARITY = """
import functools, sys, time
from pathlib import Path

import jax

from mmrp_tpu.data import native
from mmrp_tpu.eval.parity import run_parity
from mmrp_tpu.models import multimodal

native.available = lambda: False
# the runner's parameter template (replaced by the restored checkpoint) jitted:
# an eager init compiles each op apart (about 30 s)
init = multimodal.MultiModalRetrievalModel.init
multimodal.MultiModalRetrievalModel.init = lambda self, *a: jax.jit(
    functools.partial(init, self))(*a)
data = Path(sys.argv[1])
deadline = time.time() + 300
while not (data / "train" / "written").exists():  # the test module writes the run
    assert time.time() < deadline, "the run directory was not written"
    time.sleep(0.2)
run_parity(str(data), str(data / "train"), out_dir=str(data / "train" / "parity_jax"),
           k=int(sys.argv[2]), explain_queries=int(sys.argv[3]))
"""


@pytest.fixture(scope="module", autouse=True)
def parity_run(tmp_path_factory):
    """JAX's run_parity in a subprocess started before the module's first
    test, on tests/test_torch_serve.py's micro run (written here while the
    subprocess imports) with the test split as its gallery; (run, data,
    JAX's report) once it has ended."""
    data = tmp_path_factory.mktemp("parity") / "data"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", JAX_PARITY, str(data), str(K), str(EXPLAIN_N)],
                            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    run, _, _ = write_run_dir(data)
    test_ids = read(data / "splits" / "test_ids.json")
    np.save(run / "train_embeddings.npy",
            np.random.default_rng(4).standard_normal((len(test_ids), 32)).astype(np.float32))
    (run / "train_ids.json").write_text(json.dumps(test_ids))
    (run / "written").touch()

    def finished():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-4000:]
        return run, data, read(run / "parity_jax" / "parity_results.json")

    finished.run, finished.data = run, data  # written: usable before JAX's run ends
    yield finished
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    """``data`` of both CLIs on one OpenI-layout tree: (tree, port out, JAX out)."""
    root = tmp_path_factory.mktemp("openi")
    xml_dir, dcm_dir = openi_tree(root, mesh=True)
    outs = {}
    for name, mod in (("port", cli), ("jax", jcli)):
        outs[name] = root / f"data_{name}"
        assert mod.main(["data", "--xml-dir", xml_dir, "--dicom-dir", dcm_dir,
                         "--out", str(outs[name]), "--seed", "5"]) == 0
    return (xml_dir, dcm_dir), outs["port"], outs["jax"]


@pytest.fixture(scope="module")
def trained(data_dirs, tmp_path_factory):
    """The port's ``train --device cpu`` on its own ``data`` output, with the
    shipped config cut to the tiny model of tests/test_end_to_end.py."""
    _, data, _ = data_dirs
    cfg_path = tmp_path_factory.mktemp("cfg") / "tiny_config.yaml"
    dump_flat_yaml(tiny_config(Config).to_dict(), str(cfg_path))
    run = data / "train"
    assert cli.main(["train", "--config", str(cfg_path), "--data", str(data), "--out", str(run),
                     "--device", "cpu"]) == 0
    return data, run


def read(path):
    return json.loads(path.read_text())


def test_cli_data_matches_jax(data_dirs):
    """records_cache.json, the splits (ids, CSVs, counts), the EDA JSONs,
    the DICOM debug statistics, verify_cache.json and phrase_check.json:
    equal to JAX's; both drew the PNGs (matplotlib is installed here)."""
    _, port, jax = data_dirs
    assert read(port / "records_cache.json") == read(jax / "records_cache.json")
    assert len(read(port / "records_cache.json")["records"]) == 24
    files = sorted(p.relative_to(jax) for p in jax.rglob("*") if p.is_file())
    assert sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file()) == files
    for f in files:
        if f.suffix != ".png":
            assert (port / f).read_bytes() == (jax / f).read_bytes(), f
    assert {p.name for p in (port / "eda").glob("*.png")} == \
        {"dicom_debug.png", "final_norm.png", "label_distribution.png", "mesh_term_counts.png"}
    assert sum(len(read(port / "splits" / f"{s}_ids.json")) for s in ("train", "val", "test")) \
        == len([r for r in read(port / "records_cache.json")["records"] if any(r["labels"])])


def test_cli_train_writes_a_run(trained):
    """The port's run directory: the summary of every stage, the serving
    artifacts and the joint checkpoints, as tests/test_end_to_end.py
    asks of JAX's."""
    _, run = trained
    summary = read(run / "pipeline_summary.json")
    assert np.isfinite(summary["joint"]["composite"])
    for key in ("generalization", "historical"):
        for m in ("P@10", "mAP", "MRR", "nDCG@10"):
            assert 0.0 <= summary["retrieval"][key][m] <= 1.0
    for f in ("test_embeddings.npy", "vocab.txt", "kg/node_embeddings.npy",
              "swin/swin_backbone.npz", "label_attention.npz", "joint/params.npz"):
        assert (run / f).exists(), f
    assert any((run / "joint" / "ckpt" / "steps").iterdir())


def test_cli_calibrate_stream_and_serve(trained, monkeypatch):
    """calibrate (one abs-max row per Swin block, all positive), stream (one
    row per test record) and serve (the context it builds) on the port's run
    (``parity``: test_run_parity_matches_jax)."""
    data, run = trained
    assert cli.main(["calibrate", "--run-dir", str(run), "--data", str(data), "-n", "8",
                     "--batch-size", "4", "--device", "cpu"]) == 0
    amax = read(run / "swin_act_amax.json")["blocks"]
    assert len(amax) == sum(SwinConfig.micro().depths)
    assert all(v > 0 for row in amax for v in row)

    assert cli.main(["stream", "--run-dir", str(run), "--data", str(data), "-k", "3",
                     "--batch-size", "4", "--device", "cpu"]) == 0
    stats = read(run / "stream_test" / "stream_stats.json")
    rows = (run / "stream_test" / "predictions.jsonl").read_text().splitlines()
    assert stats["pairs"] == len(rows) == len(read(data / "splits" / "test_ids.json")) > 0
    assert all("probs" in json.loads(r) and "retrieval" in json.loads(r) for r in rows)


    from mmrp_tpu_torch.serve import app

    built = {}
    monkeypatch.setattr(app, "serve", lambda build_fn, port: built.update(ctx=build_fn(),
                                                                         port=port))
    assert cli.main(["serve", "--run-dir", str(run), "--port", "8123", "--device", "cpu"]) == 0
    assert built["port"] == 8123 and built["ctx"]["predictor"].device.type == "cpu"


def test_cli_reports_match_jax(trained, tmp_path, monkeypatch):
    """eval-cls, eval-ret --variants --run-dir, kg-probe and mapper of both
    CLIs on the same files write the same reports (timings aside, real
    values within 1e-6)."""
    data, run = trained
    probs, labels = cls_inputs(seed=3, n=40)
    np.save(tmp_path / "probs.npy", probs)
    np.save(tmp_path / "labels.npy", labels)
    recs = {r["id"]: r for r in read(data / "records_cache.json")["records"]}
    test_ids, train_ids = read(run / "test_ids.json"), read(run / "train_ids.json")
    lbl = lambda ids: np.stack([recs[i]["labels"] for i in ids])  # noqa: E731
    build_label_overlap_gt(test_ids, lbl(test_ids), test_ids, lbl(test_ids),
                           out_path=str(tmp_path / "gt_test.json"))
    build_label_overlap_gt(test_ids, lbl(test_ids), train_ids, lbl(train_ids),
                           out_path=str(tmp_path / "gt_train.json"))
    for var in ("BIOPORTAL_API_KEY", "GEMINI_KEYS"):
        monkeypatch.delenv(var, raising=False)
    for name, mod in (("port", cli), ("jax", jcli)):
        out = tmp_path / name
        dev = ["--device", "cpu"] if name == "port" else []
        assert mod.main(["eval-cls", "--probs", str(tmp_path / "probs.npy"), "--labels",
                         str(tmp_path / "labels.npy"), "--out", str(out / "cls")]) == 0
        assert mod.main(["eval-ret", "--test-emb", str(run / "test_embeddings.npy"),
                         "--test-ids", str(run / "test_ids.json"),
                         "--train-emb", str(run / "train_embeddings.npy"),
                         "--train-ids", str(run / "train_ids.json"),
                         "--gt-test", str(tmp_path / "gt_test.json"),
                         "--gt-train", str(tmp_path / "gt_train.json"), "-k", "3",
                         "--variants", "--run-dir", str(run), "--data", str(data),
                         "--out", str(out / "ret"), *dev]) == 0
        assert mod.main(["kg-probe", "--kg-dir", str(run / "kg"),
                         "--out-file", str(out / "kg_probe.json")]) == 0
        assert mod.main(["mapper", "--out", str(out / "onto")]) == 0
    port, jax = tmp_path / "port", tmp_path / "jax"
    files = sorted(p.relative_to(jax) for p in jax.rglob("*") if p.is_file())
    assert sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file()) == files
    assert len(files) > 10
    for f in files:
        if f.suffix == ".json":
            close(strip(read(port / f)), strip(read(jax / f)), str(f))
        elif f.suffix in (".csv", ".txt") and "retrieval" not in f.name:
            assert (port / f).read_text() == (jax / f).read_text(), f


def test_cli_parity_on_the_dls_backend(trained, tmp_path, monkeypatch):
    """A run whose config names retrieval_backend dls: ``cli parity`` builds
    both of its galleries as DLS engines and reports their retrieval."""
    from mmrp_tpu_torch.retrieval import dls

    data, run = trained
    shutil.copytree(run, tmp_path / "run")
    cfg = Config.load(str(run / "config.yaml")).replace(retrieval_backend="dls")
    dump_flat_yaml(cfg.to_dict(), str(tmp_path / "run" / "config.yaml"))
    built = []
    factory = dls.make_retrieval_engine

    def spy(*a, **kw):
        built.append(factory(*a, **kw))
        return built[-1]

    monkeypatch.setattr(dls, "make_retrieval_engine", spy)
    assert cli.main(["parity", "--data", str(data), "--run-dir", str(tmp_path / "run"),
                     "--out", str(tmp_path / "p"), "-k", str(K), "--explain-n", "0",
                     "--device", "cpu"]) == 0
    assert len(built) == 2 and all(isinstance(e, dls.DLSRetrievalEngine) for e in built)
    report = read(tmp_path / "p" / "parity_results.json")["retrieval"]
    for gallery in ("generalization", "historical"):
        for m in (f"P@{K}", "mAP", "MRR", f"nDCG@{K}"):
            assert 0.0 <= report[gallery][m] <= 1.0, (gallery, m)


def test_cli_not_ported_exit_2(parity_run, tmp_path, capsys):
    """The name is kept from when export-serving and bench both exited 2.
    bench still exits 2 and names its ROADMAP item; export-serving is
    ported: ``--platforms cpu --batches 1,4`` on the module's run exits 0 and
    prints JAX's JSON, whose meta equals JAX's ``cli export-serving`` on the
    same run, and the artifact's programs equal the run's live forward."""
    assert cli.main(["bench"]) == 2
    assert "ROADMAP.md Queue 1 item 1)" in capsys.readouterr().err
    run, data = parity_run.run, parity_run.data
    argv = ["export-serving", "--run-dir", str(run), "--data", str(data), "--batches", "1,4"]
    def printed():  # the JSON object, after the lines the run's loading prints
        out = capsys.readouterr().out
        return json.loads(out[out.index("{\n"):])

    assert cli.main([*argv, "--out-path", str(tmp_path / "port.npz"), "--platforms", "cpu"]) == 0
    got = printed()
    assert jcli.main([*argv, "--out-path", str(tmp_path / "jax.npz"), "--platforms", "cpu"]) == 0
    want = printed()
    assert got.pop("artifact") == str(tmp_path / "port.npz")
    assert want.pop("artifact") == str(tmp_path / "jax.npz")
    assert got == want
    pred = ExportedPredictor.load(tmp_path / "port.npz", platform="cpu")
    ctx = build_demo_context(str(run), data_dir=str(data), device="cpu")
    rng = np.random.default_rng(3)
    img = rng.random((3, got["image_size"], got["image_size"], 3), dtype=np.float32)
    ids = rng.integers(0, 64, (3, got["text_len"]))
    mask = np.ones((3, got["text_len"]), np.int64)
    live = ctx["predictor"].embed(img, ids, mask)
    out = pred.call(img, ids, mask)
    for key in ("probs", "joint_emb"):
        np.testing.assert_allclose(out[key], live[key], rtol=0, atol=1e-6, err_msg=key)


def strip(obj):
    """The report without its timings and paths."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if not any(t in k for t in NOT_COMPARED)}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


RANKED = ("P@", "R@", "mAP", "MRR", "nDCG", "hit", "auroc", "recall", "precision", "overlap")


def rank_based(key):
    return key.startswith("n_") or any(r in key for r in RANKED)


def held(got, want, path, tol):
    """Rank-based numbers equal, other real values within ``tol``, NaN as NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            held(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            held(a, b, f"{path}[{i}]", tol)
    elif isinstance(want, float) or isinstance(got, float):
        if math.isnan(want):
            assert math.isnan(got), path
        elif rank_based(path.rsplit(".", 1)[-1]):
            assert got == pytest.approx(want, abs=1e-12), path
        else:
            assert got == pytest.approx(want, abs=tol), path
    else:
        assert got == want, path


def test_run_parity_matches_jax(parity_run, tmp_path):
    """Both packages' run_parity on one run directory, the port's through
    ``cli parity --device cpu``: every section of the protocol in
    PARITY_RESULTS.md, and the port's report held to JAX's, section by
    section."""
    run, data, want = parity_run()
    out = tmp_path / "p"
    assert cli.main(["parity", "--data", str(data), "--run-dir", str(run), "--out", str(out),
                     "-k", str(K), "--explain-n", str(EXPLAIN_N), "--device", "cpu"]) == 0
    md = (out / "PARITY_RESULTS.md").read_text()
    for needle in ("eval_on_test.py", "retrieval_eval.py", "retrieval_explain_eval.py",
                   "Retrieval diversity", "KG health"):
        assert needle in md, needle
    got = strip(read(out / "parity_results.json"))
    want = strip(want)
    assert "significance_vs_baseline" in got["variants"]["full"]
    assert set(got) == set(want) and all(s in got for s in PARITY_SECTIONS)
    assert got["n_test"] == want["n_test"] == 6
    align = got["explain_alignment"]
    assert any(np.isfinite(v) for k, v in align.items() if k.startswith("align_"))
    for section in want:
        tol = 1e-3 if section == "explain_alignment" else 1e-4
        held(got[section], want[section], section, tol)
