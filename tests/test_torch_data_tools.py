"""The port's data tooling against JAX's, on the CPU.

The labeler, the OpenI parser, the label verifier, the stratified splits,
the stats / triplet helpers and the EDA reports of ``mmrp_tpu_torch`` are
copies of the JAX package's (numpy and the standard library), so each is
held to its original on the same inputs exactly: the same labels, records,
prompts, verdicts, ids, samples and JSON. Then the native decoder: the
port's copy of the C++ source built with g++ into a temporary directory
(the module's path constant pointed there), held to the checks of
``tests/test_native_io.py`` against the port's Python path (within one
uint8 quantum after normalization: 0.01 for the decoder alone, 0.02 through
``DICOMImagePreprocessor``, as JAX's test states; ``decode_raw`` exact).
"""

import json
import shutil
import sys

import numpy as np
import pytest

from mmrp_tpu.data import dicom as jdicom
from mmrp_tpu.data import labeler as jlabeler
from mmrp_tpu.data import openi as jopeni
from mmrp_tpu.data import splits as jsplits
from mmrp_tpu.data import stats as jstats
from mmrp_tpu.data import triplets as jtriplets
from mmrp_tpu.data import verify as jverify
from mmrp_tpu.eval import eda as jeda
from mmrp_tpu_torch.data import dicom, labeler, native, openi, splits, stats, triplets, verify
from mmrp_tpu_torch.eval import eda
from mmrp_tpu_torch.labels import LABEL_COLS, get_taxonomy
from test_end_to_end import TEXTS

NEGATED = ("no {}", "no evidence of {}", "{} is ruled out", "without {} but {}",
           "there is {}, not seen")


def openi_tree(root, n=24, seed=11, hw=40, mesh=False):
    """The OpenI layout of tests/test_end_to_end.py: one XML report per
    record (eCitation / AbstractText / parentImage), one 16-bit DICOM each,
    plus a report with no image, an image id that does not normalize and an
    XML file that does not parse; with ``mesh``, MeSH terms per report."""
    rng = np.random.default_rng(seed)
    xml_dir, dcm_dir = root / "xml", root / "dcm"
    xml_dir.mkdir(parents=True)
    (dcm_dir / "sub").mkdir(parents=True)
    terms = ["Cardiomegaly/mild", "Pleural Effusion", "Opacity", "normal", "Lung/hypoinflation"]
    for i, base in enumerate((TEXTS * 4)[:n]):
        rid = f"{i + 1}"
        mesh_xml = ("<MeSH>" + "".join(f"<major>{t}</major>" for t in
                                        rng.choice(terms, 2, replace=False)) + "</MeSH>"
                    if mesh else "")
        (xml_dir / f"{rid}.xml").write_text(
            f"""<eCitation><ArticleTitle>r{rid}</ArticleTitle>
<Abstract><AbstractText>{base} Study number {i + 1}.</AbstractText></Abstract>{mesh_xml}
<parentImage id="CXR{rid}_IM-0001-1001"/><parentImage id="bad{rid}"/></eCitation>""")
        arr = (rng.random((hw, hw)) * 2000).astype(np.uint16)
        dicom.write_dicom(dcm_dir / ("sub" if i % 3 else "") / f"{rid}_IM-0001-1001.dcm", arr,
                          window_center=1000, window_width=2000)
    (xml_dir / "999.xml").write_text(
        "<eCitation><ArticleTitle>title only</ArticleTitle>"
        "<parentImage id='CXR999_IM-0001-1001'/></eCitation>")
    (xml_dir / "broken.xml").write_text("<eCitation><unclosed>")
    return str(xml_dir), str(dcm_dir)


def same(got, want):
    """JSON-equal: every key, list and number the same."""
    assert json.loads(json.dumps(got, default=float)) == \
        json.loads(json.dumps(want, default=float))


def test_labeler_matches_jax():
    """Labels and negations on the end-to-end fixture's reports and on every
    taxonomy phrase, plain and under pre- and post-negation triggers, with
    scope terminators: the same matches (group, phrase, span, negated) and
    the same 43-label vectors."""
    lab, jlab = labeler.PhraseLabeler(), jlabeler.PhraseLabeler()
    phrases = [p for ps in get_taxonomy().combined_groups().values() for p in ps]
    texts = list(TEXTS) + phrases + [
        t.format(p, phrases[(i * 7) % len(phrases)]) if t.count("{}") == 2 else t.format(p)
        for i, p in enumerate(phrases) for t in NEGATED[i % len(NEGATED):][:2]]
    negated = 0
    for text in texts:
        got, want = lab.matches(text), jlab.matches(text)
        assert [tuple(vars(m).values()) for m in got] == [tuple(vars(m).values()) for m in want]
        assert lab.label_vector(text) == jlab.label_vector(text)
        assert lab.label_report(text) == jlab.label_report(text)
        negated += sum(m.negated for m in got)
    assert negated > 100  # the negation triggers fire
    assert labeler.tokenize_words("Mild XXXX-opacity, R's base.") == \
        jlabeler.tokenize_words("Mild XXXX-opacity, R's base.")


def test_parse_openi_matches_jax(tmp_path):
    """Records of the same XML + DICOM tree equal to JAX's (ids, paths,
    texts, labels, normal flags), from a fresh parse and from each package's
    cache; the cache files equal but for nothing (the same fingerprint)."""
    xml_dir, dcm_dir = openi_tree(tmp_path)
    got = openi.parse_openi_xml(xml_dir, dcm_dir, cache_path=str(tmp_path / "p.json"))
    want = jopeni.parse_openi_xml(xml_dir, dcm_dir, cache_path=str(tmp_path / "j.json"))
    assert len(got) == 24 and got == want
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    assert openi.parse_openi_xml(xml_dir, dcm_dir, cache_path=str(tmp_path / "p.json")) == want
    assert openi.scan_dicom_dir(dcm_dir) == jopeni.scan_dicom_dir(dcm_dir)
    for raw in ("CXR12_IM-1", "CXR_", "CXR3", "IM-2", ""):
        assert openi.normalize_image_id(raw) == jopeni.normalize_image_id(raw)


@pytest.mark.parametrize("seed", [5, 2709])
def test_splits_match_jax(tmp_path, seed):
    """The multilabel stratified split per seed: the same ids in each split
    and the same artifacts (id JSONs, CSVs, per-label counts) byte for
    byte; the consistency check names the same ids."""
    rng = np.random.default_rng(seed)
    recs = [{"id": f"r{i}", "report_text": f"report {i // 2}",  # pairs share a report
             "labels": (rng.random(len(LABEL_COLS)) < 0.1).astype(int).tolist()}
            for i in range(90)]
    got = splits.train_val_test_split(recs, seed=seed, out_dir=str(tmp_path / "p"))
    want = jsplits.train_val_test_split(recs, seed=seed, out_dir=str(tmp_path / "j"))
    assert got == want and sum(map(len, got.values())) == 90
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "p" / f.name).read_bytes() == f.read_bytes(), f.name
    Y = np.stack([r["labels"] for r in recs])
    for a, b in zip(splits.multilabel_stratified_split(Y, [0.7, 0.2, 0.1], seed=seed),
                    jsplits.multilabel_stratified_split(Y, [0.7, 0.2, 0.1], seed=seed)):
        np.testing.assert_array_equal(a, b)
    table = {r["id"]: r["labels"] for r in recs}
    table["r3"] = [1 - v for v in table["r3"]]
    assert splits.check_label_consistency(recs, table) == \
        jsplits.check_label_consistency(recs, table) == ["r3"]


def test_verify_matches_jax(tmp_path):
    """One scripted ``complete`` for both verifiers: a malformed reply (a
    retry), Unknown verdicts (the second pass), labels outside the label
    space (dropped) and a missing index: the same prompts in the same order,
    the same verdicts, final labels and cache; offline (no client) every
    record passes through unchanged. ``gemini_client_from_env`` is None
    without keys."""
    rng = np.random.default_rng(3)
    recs = [{"id": f"r{i}", "report_text": f"{TEXTS[i % 8]} ({i})",
             "labels": (rng.random(len(LABEL_COLS)) < 0.15).astype(int).tolist()}
            for i in range(11)]

    def run(mod, name):
        prompts = []

        def complete(prompt):
            prompts.append(prompt)
            if len(prompts) == 1:
                return "no list here"
            n = prompt.count("Report ")
            rows = [{"index": i, "llm_status": ("Unknown" if (len(prompts) + i) % 4 == 0
                                                else "Wrong"),
                     "remove": [LABEL_COLS[i]], "add": [LABEL_COLS[-1 - i], "not_a_label"]}
                    for i in range(n) if i != 2]
            return "verdicts: " + json.dumps(rows)
        v = mod.LabelVerifier(complete=complete, batch_size=4, backoff_s=0.0,
                              cache_path=str(tmp_path / f"{name}.json"))
        verdicts = v.verify(recs)
        final = mod.apply_verdicts(recs, verdicts)
        offline = mod.apply_verdicts(recs, mod.LabelVerifier().verify(recs))
        return prompts, {k: vars(x) for k, x in verdicts.items()}, final, offline

    got, want = run(verify, "p"), run(jverify, "j")
    assert got == want
    assert len(got[0]) > 4  # the retry and the second pass ran
    assert [r["labels"] for r in got[3]] == [r["labels"] for r in recs]
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert verify.gemini_client_from_env(env_var="MMRP_NO_SUCH_KEYS") is None


def test_stats_and_triplets_match_jax(tmp_path):
    """RawStatDataset (a file that does not decode gives zeros),
    ReportLookup with its cache, find_dicom, the web sample set, and the
    pseudo-triplets and label-embedding lookup: equal."""
    xml_dir, dcm_dir = openi_tree(tmp_path / "t", n=10, hw=48)
    recs = openi.parse_openi_xml(xml_dir, dcm_dir)
    (tmp_path / "bad.dcm").write_bytes(b"not a dicom" * 30)
    recs_bad = recs + [dict(recs[0], id="bad", dicom_path=str(tmp_path / "bad.dcm"))]
    ds, jds = stats.RawStatDataset(recs_bad, (32, 24)), jstats.RawStatDataset(recs_bad, (32, 24))
    for i in (0, 3, len(recs_bad) - 1):
        np.testing.assert_array_equal(ds[i], jds[i])
    assert ds.intensity_stats() == jds.intensity_stats()
    look = stats.ReportLookup(recs, cache_path=str(tmp_path / "p" / "lookup.json"))
    jlook = jstats.ReportLookup(recs, cache_path=str(tmp_path / "j" / "lookup.json"))
    assert [look(r["id"]) for r in recs] == [jlook(r["id"]) for r in recs]
    assert stats.ReportLookup(cache_path=str(tmp_path / "p" / "lookup.json"))("3_IM-0001-1001") \
        == jlook("3_IM-0001-1001")
    for rid in ("4_IM-0001-1001", "5_IM", "nothing"):
        assert stats.find_dicom(dcm_dir, rid) == jstats.find_dicom(dcm_dir, rid)
    assert stats.build_web_sample_set(recs, str(tmp_path / "p"), seed=1) == \
        jstats.build_web_sample_set(recs, str(tmp_path / "j"), seed=1)
    assert (tmp_path / "p" / "web_samples.json").read_text() == \
        (tmp_path / "j" / "web_samples.json").read_text()

    rng = np.random.default_rng(0)
    labels = rng.random((40, 6)) < 0.3
    ids = [f"i{k}" for k in range(40)]
    t = triplets.PseudoTripletDataset(ids, labels, pos_threshold=0.4, seed=2)
    jt = jtriplets.PseudoTripletDataset(ids, labels, pos_threshold=0.4, seed=2)
    assert list(t) == list(jt) and len(list(triplets.PseudoTripletDataset(ids, labels))) > 0
    table = rng.standard_normal((6, 5)).astype(np.float32)
    by_id = {i: labels[k] for k, i in enumerate(ids)}
    lk, jlk = triplets.LabelEmbeddingLookup(table, by_id), jtriplets.LabelEmbeddingLookup(
        table, by_id)
    for i in ids[:10] + ["none"]:
        assert lk.label_indices(i) == jlk.label_indices(i)
        np.testing.assert_array_equal(lk.embeddings(i), jlk.embeddings(i))


def test_eda_reports_match_jax(tmp_path, capsys, monkeypatch):
    """Before / after split, the verification delta, the MeSH statistics,
    the DICOM debug statistics and the phrase check: the same values and
    JSON files. Without matplotlib the port writes every JSON report, draws
    no PNG and names the PNGs it skipped in one line each."""
    xml_dir, dcm_dir = openi_tree(tmp_path / "t", mesh=True)
    recs = jopeni.parse_openi_xml(xml_dir, dcm_dir)
    recs[0] = dict(recs[0], labels=[0] * len(LABEL_COLS))
    after = [dict(r, labels=[1 - v for v in r["labels"]]) if k % 5 == 0 else r
             for k, r in enumerate(recs)]
    names = LABEL_COLS
    same(eda.eda_before_split(recs, names, str(tmp_path / "p.json")),
         jeda.eda_before_split(recs, names, str(tmp_path / "j.json")))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    kept = eda.drop_zero_label_records(recs)
    assert kept == jeda.drop_zero_label_records(recs) and len(kept) < len(recs)
    by_id = {r["id"]: r for r in recs}
    split = {"train": [r["id"] for r in recs[:16]], "test": [r["id"] for r in recs[16:]]}
    same(eda.eda_after_split(split, by_id, names), jeda.eda_after_split(split, by_id, names))
    assert eda.verification_delta(recs, after, names) == \
        jeda.verification_delta(recs, after, names)
    np.testing.assert_array_equal(eda.label_cooccurrence(np.stack([r["labels"] for r in recs])),
                                  jeda.label_cooccurrence(np.stack([r["labels"] for r in recs])))
    for sub, mod in (("p", eda), ("j", jeda)):
        mod.mesh_label_stats(xml_dir, out_dir=str(tmp_path / sub), min_count_threshold=2)
        mod.dicom_debug_plots(recs[1]["dicom_path"], str(tmp_path / sub))
    for f in ("mesh_label_stats.json", "dicom_debug_stats.json"):
        assert (tmp_path / "p" / f).read_text() == (tmp_path / "j" / f).read_text(), f
    for png in ("mesh_term_counts.png", "dicom_debug.png", "final_norm.png"):
        assert (tmp_path / "p" / png).stat().st_size > 0
    assert eda.phrase_match_check(recs, labeler.PhraseLabeler(), n_samples=7, seed=3) == \
        jeda.phrase_match_check(recs, jlabeler.PhraseLabeler(), n_samples=7, seed=3)

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    capsys.readouterr()
    out = tmp_path / "nomp"
    rep = eda.mesh_label_stats(xml_dir, out_dir=str(out), min_count_threshold=2)
    stats_ = eda.dicom_debug_plots(recs[1]["dicom_path"], str(out))
    assert eda.label_distribution_plot(np.stack([r["labels"] for r in recs]), names,
                                       str(out / "label_distribution.png")) is None
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(line.startswith("[eda] matplotlib not installed: skipped")
                                   for line in lines)
    assert "final_norm.png" in lines[1] and "label_distribution.png" in lines[2]
    assert "plot" not in rep and not list(out.glob("*.png"))
    assert json.loads((out / "mesh_label_stats.json").read_text()) == \
        json.loads((tmp_path / "j" / "mesh_label_stats.json").read_text())
    assert json.loads((out / "dicom_debug_stats.json").read_text()) == stats_


# ---- the native decoder (last in the module: it points the port at a library) --


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library built with g++ into a temporary directory, the
    module's LIB_PATH pointed there; available() before and after."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native decoder is built with g++")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "LIB_PATH", tmp_path_factory.mktemp("native") / "libmmrp_io.so")
    mp.setattr(native, "_lib", None)
    mp.setattr(native, "_load_failed", False)
    before = native.available()
    assert native.build() is True and native.build() is False  # the stamp is current
    yield before
    mp.undo()


def _blob(rng, h=96, w=80, **kw):
    arr = (rng.random((h, w)) * 3000).astype(np.uint16)
    return arr, dicom.write_dicom(None, arr, **kw)


def test_native_is_an_explicit_build(built, tmp_path, monkeypatch):
    """Nothing is found before the build (load never builds), the library
    after it; a stale stamp is not current; a failed build raises."""
    assert built is False and native.available() and native.is_current()
    stamp = native.LIB_PATH.with_name(native.LIB_PATH.name + ".sha256")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DSTALE",))
    assert not native.is_current() and stamp.is_file()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libbad.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not (tmp_path / "libbad.so").exists()


def test_native_matches_python_preprocess(built):
    """tests/test_native_io.py's checks against the port's Python path."""
    rng = np.random.default_rng(0)
    _, blob = _blob(rng, window_center=1500, window_width=2500)
    py = dicom.DICOMImagePreprocessor(output_size=(64, 64), use_native=False).load(blob)[0]
    nat = native.preprocess(blob, out_hw=(64, 64))
    assert np.abs(py - nat).max() < 0.01
    arr, blob = _blob(rng)
    np.testing.assert_array_equal(native.decode_raw(blob), arr.astype(np.float32))
    blob2 = dicom.write_dicom(None, arr, rescale_slope=2.0, rescale_intercept=-100.0)
    np.testing.assert_allclose(native.decode_raw(blob2), arr.astype(np.float32) * 2.0 - 100.0)
    blobs = [dicom.write_dicom(None, (rng.random((48, 48)) * 900).astype(np.uint16))
             for _ in range(16)]
    out, status = native.preprocess_batch(blobs + [b"not a dicom" * 20], out_hw=(32, 32))
    assert out.shape == (17, 32, 32) and (status[:16] == 0).all() and status[16] != 0
    assert np.isfinite(out[:16]).all()
    arr = (rng.random((32, 32)) * 1000).astype(np.uint16)
    a1, a2 = (native.preprocess(dicom.write_dicom(None, arr, photometric=ph, window_center=500,
                                                  window_width=1000), out_hw=(32, 32))
              for ph in ("MONOCHROME1", "MONOCHROME2"))
    assert np.corrcoef(a1.ravel(), a2.ravel())[0, 1] < -0.9
    with pytest.raises(ValueError, match="native DICOM"):
        native.preprocess(b"not a dicom" * 20)


def test_preprocessor_takes_the_native_path(built, tmp_path):
    """The port's DICOMImagePreprocessor on the native path where the library
    is built: within 0.02 of the Python path and of the JAX preprocessor on
    its Python path, from bytes and from a file; per-channel mean / std and
    ``use_native=False`` keep the Python path, bit-equal to JAX's."""
    rng = np.random.default_rng(1)
    _, blob = _blob(rng, window_center=1500, window_width=2500)
    (tmp_path / "a.dcm").write_bytes(blob)
    want = jdicom.DICOMImagePreprocessor(output_size=(64, 64), use_native=False).load(blob)
    pp = dicom.DICOMImagePreprocessor(output_size=(64, 64))
    for src in (blob, str(tmp_path / "a.dcm")):
        got = pp.load(src)
        assert got.shape == (3, 64, 64) and np.abs(got - want).max() < 0.02
        assert not np.array_equal(got, want)  # the native path ran
    np.testing.assert_array_equal(
        dicom.DICOMImagePreprocessor(output_size=(64, 64), use_native=False).load(blob), want)
    kw = dict(mean=(0.4, 0.5, 0.6), std=(0.2, 0.25, 0.3), output_size=(64, 64))
    np.testing.assert_array_equal(dicom.DICOMImagePreprocessor(**kw).load(blob),
                                  jdicom.DICOMImagePreprocessor(use_native=False, **kw).load(blob))
