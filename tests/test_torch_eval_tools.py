"""The port's evaluation tools and DLS engine against JAX's, on the CPU.

``eval/classification.py`` (per-class report, calibration / ECE, the CSV and
summary it writes) at 1e-6: the same numpy arithmetic over metrics the port
copies; ``eval/kg_probe.py`` and ``kg/ontology.py`` exactly (the same
callables injected into both mappers). ``retrieval/dls.py``: the link graph
of seeded clustered embeddings (N 500, dim 64) on the port's device path
(the CPU here) against JAX's, neighbours equal and similarities within 1e-6
(f32 products summed in other orders), the walks equal, the npz cache and
the factory, with ``Config.retrieval_backend`` checked as JAX checks it,
and the reranker's candidate rows as the exact engine gives them.
"""

import csv
import json

import numpy as np
import pytest

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.eval import classification as jcls
from mmrp_tpu.eval import kg_probe as jprobe
from mmrp_tpu.kg import ontology as jonto
from mmrp_tpu.retrieval import dls as jdls
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.eval import classification, kg_probe
from mmrp_tpu_torch.kg import ontology
from mmrp_tpu_torch.labels import LABEL_COLS
from mmrp_tpu_torch.retrieval import DLSRetrievalEngine, RetrievalEngine, dls, \
    make_retrieval_engine

TOL = dict(rtol=1e-6, atol=1e-6)


def close(got, want, path=""):
    """Nested dicts / lists of numbers within TOL, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            close(a, b, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    else:
        assert got == want, path


def cls_inputs(seed=0, n=60):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, len(LABEL_COLS))) < 0.2).astype(np.float32)
    labels[:, 5] = 0  # a class with no positive
    probs = np.clip(labels * 0.4 + rng.random(labels.shape) * 0.6, 0, 1).astype(np.float32)
    return probs, labels


@pytest.mark.parametrize("fixed", [False, True], ids=["f1_optimal", "given_thresholds"])
def test_classification_matches_jax(tmp_path, fixed):
    """evaluate_classification with F1-optimal and given thresholds: the
    report (per class, macro / micro, calibration bins and ECE) within 1e-6,
    the per-class CSV cell for cell within 1e-6, the summary JSON and the
    text report; both draw the reliability and confusion PNGs."""
    probs, labels = cls_inputs()
    th = np.random.default_rng(1).uniform(0.2, 0.8, len(LABEL_COLS)).astype(np.float32) \
        if fixed else None
    got = classification.evaluate_classification(probs, labels, LABEL_COLS, th,
                                                 str(tmp_path / "p"))
    want = jcls.evaluate_classification(probs, labels, LABEL_COLS, th, str(tmp_path / "j"))
    close({k: v for k, v in got.items() if k != "plots"},
          {k: v for k, v in want.items() if k != "plots"})
    assert [p.replace("/p/", "/j/") for p in got["plots"].values()] == \
        list(want["plots"].values())
    rows = [list(csv.reader((tmp_path / d / "test_per_class.csv").open())) for d in "pj"]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(LABEL_COLS) + 1
    for a, b in zip(rows[0][1:], rows[1][1:]):
        assert a[0] == b[0]
        np.testing.assert_allclose(np.float64(a[1:]), np.float64(b[1:]), **TOL)
    summary = [json.loads((tmp_path / d / "test_summary.json").read_text()) for d in "pj"]
    assert summary[0].pop("plots") == got["plots"] and summary[1].pop("plots") == want["plots"]
    close(*summary)
    assert (tmp_path / "p" / "test_report.txt").read_text() == \
        (tmp_path / "j" / "test_report.txt").read_text()
    close(classification.calibration_report(labels, probs, bins=7),
          jcls.calibration_report(labels, probs, bins=7))


def test_kg_probe_matches_jax(tmp_path):
    """full_probe over a KG directory with a zero row and a NaN row, label
    nodes partly missing, neighbours of probe nodes: equal reports and
    files."""
    rng = np.random.default_rng(2)
    names = [f"label:{n}" for n in LABEL_COLS[:30]] + [f"report:r{i}" for i in range(20)]
    emb = rng.standard_normal((len(names), 8)).astype(np.float32)
    emb[3] = 0.0
    emb[7, 2] = np.nan
    np.save(tmp_path / "node_embeddings.npy", emb)
    (tmp_path / "node2id.json").write_text(json.dumps({n: i for i, n in enumerate(names)}))
    probes = [names[0], names[31], "label:nothing"]
    got = kg_probe.full_probe(str(tmp_path), LABEL_COLS, probes, str(tmp_path / "p.json"))
    want = jprobe.full_probe(str(tmp_path), LABEL_COLS, probes, str(tmp_path / "j.json"))
    close(got, want)  # mean_norm is NaN in both: a row holds a NaN
    assert got["health"]["n_nan"] == 1 and got["health"]["n_zero_norm"] == 1
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


def test_ontology_mapper_matches_jax(tmp_path, monkeypatch, capsys):
    """The cascade (cache, exact, fuzzy, BioPortal, LLM, LOCAL fallback, a
    network stage that raises) with the same injected callables: the same
    ids, stats, coverage, cache file and run_mapper files; the ``*_from_env``
    lookups are None without their keys."""
    known = {"pleural effusion": "DOID:1", "cardiomegaly": "DOID:2", "pneumonia": "DOID:3"}

    def bioportal(term):
        if "fail" in term:
            raise OSError("offline")
        return f"SNOMED:{len(term)}" if term.startswith("a") else None

    def llm(term):
        if term == "boom":
            raise RuntimeError("quota")
        return "pneumonia" if "lung infection" in term else None

    terms = ["Pleural Effusion", "cardiomegally", "atelectasis", "lung infection",
             "fail here", "boom", "unknown thing", "pleural effusion"]
    out = {}
    for name, mod in (("p", ontology), ("j", jonto)):
        m = mod.OntologyMapper(known, cache_path=str(tmp_path / name / "cache.json"),
                               bioportal_lookup=bioportal, llm_normalize=llm)
        ids = [m.map_label(t) for t in terms]
        groups = m.map_groups({"g1": ["cardiomegaly", "new term"], "g2": ["abc"]})
        written = mod.run_mapper(str(tmp_path / name / "run"), mapper=m)
        files = {k: open(v).read() for k, v in written.items()}
        out[name] = (ids, groups, m.coverage_report(), files,
                     (tmp_path / name / "cache.json").read_text(), capsys.readouterr().out)
    assert out["p"] == out["j"]
    assert out["p"][0][:4] == ["DOID:1", "DOID:2", "SNOMED:11", "DOID:3"]
    for var in ("BIOPORTAL_API_KEY", "GEMINI_KEYS"):
        monkeypatch.delenv(var, raising=False)
    assert ontology.bioportal_lookup_from_env() is None
    assert ontology.gemini_normalize_from_env() is None


def clustered(n=500, d=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, d))
    x = centers[rng.integers(0, 12, n)] + 1.2 * rng.standard_normal((n, d))
    return x.astype(np.float32), [f"id{i}" for i in range(n)]


def test_dls_link_graph_matches_jax():
    """The link graph per block size and threshold: neighbours equal (the
    self column dropped, the threshold and max_links applied as JAX's walk
    does), similarities within 1e-6, missing links -1 / 0."""
    emb, _ = clustered()
    short = 0  # rows with fewer than max_links links
    for max_links, thr, block in ((10, 0.3, 1024), (6, 0.55, 128), (40, 0.3, 97)):
        nb, s = dls.build_link_graph(emb, max_links, thr, block, device="cpu")
        jnb, js = jdls.build_link_graph(emb, max_links, thr, block)
        assert nb.dtype == jnb.dtype == np.int32 and s.dtype == js.dtype == np.float32
        np.testing.assert_array_equal(nb, jnb)
        np.testing.assert_allclose(s, js, **TOL)
        assert (nb[:, 0] >= 0).sum() > 300 and not (nb == np.arange(500)[:, None]).any()
        short += int((nb == -1).any(1).sum())
    assert short > 100


def test_dls_walk_cache_and_factory(tmp_path):
    """The walks (seeded by the query id's hash, self excluded) of the port's
    engine equal JAX's; the npz cache is written, read back, and rebuilt on
    a shape mismatch; the factory builds either engine with its options and
    refuses another backend, and Config checks retrieval_backend as JAX's."""
    emb, ids = clustered(seed=1)
    cache = tmp_path / "links.npz"
    eng = make_retrieval_engine("dls", emb, ids, max_links=8, seed_size=4, max_steps=40,
                                cache_path=str(cache), device="cpu", mesh="ignored")
    jeng = jdls.make_retrieval_engine("dls", emb, ids, max_links=8, seed_size=4, max_steps=40)
    assert isinstance(eng, DLSRetrievalEngine) and cache.exists()
    rng = np.random.default_rng(3)
    for qi in list(range(0, 500, 37)) + [None]:
        q = emb[qi] if qi is not None else rng.standard_normal(64).astype(np.float32)
        qid = ids[qi] if qi is not None else None
        got, want = eng.retrieve(q, K=7, query_id=qid), jeng.retrieve(q, K=7, query_id=qid)
        assert [r for r, _ in got] == [r for r, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], **TOL)
        assert qid not in [r for r, _ in got]
    again = dls.DLSRetrievalEngine(emb, ids, max_links=8, cache_path=str(cache), device="meta")
    np.testing.assert_array_equal(again.neighbors, eng.neighbors)  # read, not built
    rebuilt = dls.DLSRetrievalEngine(emb, ids, max_links=5, cache_path=str(cache), device="cpu")
    assert rebuilt.neighbors.shape == (500, 5) and np.load(cache)["neighbors"].shape == (500, 5)
    exact = make_retrieval_engine("exact", emb, ids, device="cpu")
    assert isinstance(exact, RetrievalEngine)
    rows = ["id7", "unknown", "id499"]  # the reranker's candidates, as the exact engine's
    np.testing.assert_array_equal(eng.get_embeddings_for_ids(rows),
                                  exact.get_embeddings_for_ids(rows))
    assert [r for r, _ in exact.retrieve(emb[4], K=3, query_id=ids[4])] == \
        [r for r, _ in jdls.make_retrieval_engine("exact", emb, ids).retrieve(
            emb[4], K=3, query_id=ids[4])]
    with pytest.raises(ValueError, match="unknown retrieval backend"):
        make_retrieval_engine("hnsw", emb, ids)
    assert Config(retrieval_backend="dls").retrieval_backend == "dls"
    for cls in (Config, JConfig):
        with pytest.raises(ValueError, match="invalid retrieval_backend"):
            cls(retrieval_backend="hnsw")
