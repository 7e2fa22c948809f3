"""The port's host modules and on-device preprocessing against JAX's, on the CPU.

Copies held to their JAX originals on the same inputs: the label taxonomy,
the WordPiece tokenizer, the DICOM reader / writer / preprocessor (the JAX
one on its Python path), the dataset and its batching, and the reranker,
each exactly (the same numpy arithmetic in the same order). Then
``ops/preprocess.py``: ``window_normalize`` and ``preprocess_batch`` against
JAX's at 1e-4 (f32, with the resize of another library), and
``augment_with`` against JAX's ``augment_batch`` at 1e-4, given the angles
and flips JAX draws from its key.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.data import dataset as jdataset
from mmrp_tpu.data import dicom as jdicom
from mmrp_tpu.data import native as jnative
from mmrp_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmrp_tpu.labels import taxonomy as jtaxonomy
from mmrp_tpu.ops import preprocess as jpre
from mmrp_tpu.retrieval import rerank as jrerank
from mmrp_tpu_torch.data import dataset, dicom, native
from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmrp_tpu_torch.labels import taxonomy
from mmrp_tpu_torch.ops import preprocess
from mmrp_tpu_torch.retrieval import rerank

PRE_TOL = dict(rtol=0, atol=1e-4)
REPORTS = [
    "The lungs are clear. No pleural effusion or pneumothorax. Heart size is normal.",
    "Mild cardiomegaly. Small left pleural effusion with adjacent atelectasis.",
    "Interval placement of a right IJ catheter, tip at the cavoatrial junction.",
    "Degenerative changes of the thoracic spine; no acute cardiopulmonary process!",
    "XXXX opacity in the right lower lobe, concerning for pneumonia (follow-up advised).",
    "",
]


@pytest.fixture(scope="module", autouse=True)
def no_native_decoder():
    """Both preprocessors on their Python paths, whether or not either
    package's native library is built (they agree only within 0.02 with it,
    tests/test_native_io.py, tests/test_torch_data_tools.py); for the whole
    module, its module-scoped fixtures included. The other modules that hold
    the port's decode against JAX's import it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(native, "available", lambda: False)
        yield


def test_label_columns_are_the_jax_packages():
    assert taxonomy.LABEL_COLS == jtaxonomy.LABEL_COLS and taxonomy.NUM_CLASSES == 43
    tax, jtax = taxonomy.get_taxonomy(), jtaxonomy.get_taxonomy()
    assert tax.combined_groups() == jtax.combined_groups()
    assert tax.categories == jtax.categories


def test_tokenizer_matches_jax(tmp_path):
    """A vocabulary trained by each package on the reports, saved by JAX and
    loaded by both: the same vocabulary, ids and masks (truncation at 16,
    padding at 64)."""
    corpus = REPORTS * 3
    jtok = JTokenizer.train(corpus, vocab_size=120, min_freq=2)
    assert WordPieceTokenizer.train(corpus, vocab_size=120, min_freq=2).vocab == jtok.vocab
    jtok.save_vocab(str(tmp_path / "vocab.txt"))
    tok = WordPieceTokenizer.from_vocab_file(str(tmp_path / "vocab.txt"))
    jtok = JTokenizer.from_vocab_file(str(tmp_path / "vocab.txt"))
    for L in (16, 64):
        for got, want in zip(tok.encode_batch(REPORTS, L), jtok.encode_batch(REPORTS, L)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    assert tok.tokenize(REPORTS[4]) == jtok.tokenize(REPORTS[4])


@pytest.mark.parametrize("dtype,kw", [
    (np.uint16, dict(window_center=1500.0, window_width=2000.0)),
    (np.int16, dict(rescale_slope=2.0, rescale_intercept=-100.0)),
    (np.uint8, dict(photometric="MONOCHROME1")),
])
def test_dicom_round_trips_as_jax(rng, dtype, kw):
    """The port's writer writes JAX's bytes, and each package's reader reads
    the other's file back to the same attributes and pixels."""
    info = np.iinfo(dtype)
    pixels = rng.integers(max(info.min, -1000), min(info.max, 3000), (48, 40)).astype(dtype)
    blob = dicom.write_dicom(None, pixels, **kw)
    assert blob == jdicom.write_dicom(None, pixels, **kw)
    got, want = dicom.read_dicom(blob), jdicom.read_dicom(blob)
    np.testing.assert_array_equal(got.pixel_array, pixels)
    assert got.pixel_array.dtype == want.pixel_array.dtype == dtype
    for field in ("rows", "columns", "photometric", "rescale_slope", "rescale_intercept",
                  "window_center", "window_width", "extra"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(dicom.load_raw_array(blob), jdicom.load_raw_array(blob))


@pytest.mark.parametrize("photometric", ["MONOCHROME1", "MONOCHROME2"])
@pytest.mark.parametrize("window", [dict(window_center=1500.0, window_width=2000.0), {}])
def test_preprocessor_matches_jax(rng, tmp_path, photometric, window):
    """DICOMImagePreprocessor of both packages on one file (JAX with
    ``use_native=False``), down- and upsampled, scalar and per-channel
    mean/std: the same array."""
    pixels = (rng.random((96, 80)) * 3000).astype(np.uint16)
    path = tmp_path / "x.dcm"
    dicom.write_dicom(path, pixels, photometric=photometric, **window)
    for kw in (dict(output_size=(56, 56)), dict(output_size=(128, 112)),
               dict(output_size=(28, 28), mean=(0.4, 0.5, 0.6), std=(0.2, 0.25, 0.3))):
        got = dicom.DICOMImagePreprocessor(**kw).load(str(path))
        want = jdicom.DICOMImagePreprocessor(use_native=False, **kw).load(str(path))
        assert got.shape == (3,) + kw["output_size"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,out", [((64, 56), (28, 28)), ((300, 257), (224, 224)),
                                      ((100, 100), (224, 224))])
def test_resize_numpy_path_matches_cv2(rng, monkeypatch, size, out):
    """A card without cv2 takes _resize_bilinear's numpy fallback: the same
    half-pixel bilinear in another order, measured within 1.2e-7 of cv2's
    on [0, 1] images; held to 5e-7 (4 f32 ulps of 1.0)."""
    pytest.importorskip("cv2")
    img = rng.integers(0, 256, size).astype(np.float32) / 255.0
    with_cv2 = dicom._resize_bilinear(img, out)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    fallback = dicom._resize_bilinear(img, out)
    assert fallback.shape == with_cv2.shape == out and fallback.dtype == np.float32
    np.testing.assert_allclose(fallback, with_cv2, rtol=0, atol=5e-7)


def test_dataset_batches_as_jax(rng, tmp_path):
    """ChestXRDataset + build_dataloader (thread pool and prefetch queue),
    the padded last batch, and the sampling weights of both packages."""
    jtok = JTokenizer.train(REPORTS * 2, vocab_size=100, min_freq=1)
    jtok.save_vocab(str(tmp_path / "vocab.txt"))
    tok = WordPieceTokenizer.from_vocab_file(str(tmp_path / "vocab.txt"))
    records = []
    for i, text in enumerate(REPORTS):
        path = tmp_path / f"{i}.dcm"
        dicom.write_dicom(path, (rng.random((40, 36)) * 2000).astype(np.uint16))
        records.append({"id": f"r{i}", "dicom_path": str(path), "report_text": text,
                        "labels": (rng.random(5) < 0.4).astype(int).tolist()})
    ds = dataset.ChestXRDataset(records, tok, max_length=24, image_size=28)
    jds = jdataset.ChestXRDataset(records, jtok, max_length=24, image_size=28)
    for workers in (0, 2):
        got = list(dataset.build_dataloader(ds, 4, shuffle=True, seed=3, num_workers=workers))
        want = list(jdataset.build_dataloader(jds, 4, shuffle=True, seed=3,
                                              num_workers=workers))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["ids"] == w["ids"]
            for key in ("image", "input_ids", "attention_mask", "labels", "valid"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert list(got[-1]["valid"]) == [1, 1, 0, 0]
    labels = np.array([r["labels"] for r in records], np.float32)
    np.testing.assert_array_equal(dataset.inverse_frequency_weights(labels),
                                  jdataset.inverse_frequency_weights(labels))
    for clamp in (1.0, 3.0):
        np.testing.assert_array_equal(dataset.pos_weight_from_labels(labels, clamp),
                                      jdataset.pos_weight_from_labels(labels, clamp))


def reranker_inputs(rng):
    names = [f"l{i}" for i in range(6)]
    labels = {f"c{i}": (rng.random(6) < 0.5).astype(int) for i in range(8)}
    labels["q"] = np.array([1, 0, 1, 0, 0, 1])
    labels["c7"] = np.zeros(6, int)  # a record with no label
    del labels["c6"]  # a candidate with no labels at all
    nodes = ["report:c0", "report:c1", "report:q2"] + [f"label:{n}" for n in names[:4]]
    kg = dict(kg_node_embeddings=rng.standard_normal((len(nodes), 5)).astype(np.float32),
              kg_node2id={n: i for i, n in enumerate(nodes)})
    return names, labels, kg


@pytest.mark.parametrize("case", ["full", "constant_embeddings", "no_kg", "no_labels",
                                  "kg_vectors"])
def test_reranker_matches_jax(rng, case):
    """The same (id, final, emb_n, lab_n, kg_n) tuples in the same order:
    KG report nodes, label-node means (and labels with no node), a record
    with no label and one with no labels entry, a constant column (identical
    candidate embeddings: zeros), precomputed KG vectors, and a query with
    no labels or KG vector."""
    names, labels, kg = reranker_inputs(rng)
    cands = [f"c{i}" for i in range(8)]
    embs = rng.standard_normal((8, 12)).astype(np.float32)
    query = rng.standard_normal(12).astype(np.float32)
    kw = dict(alpha=0.5, beta=0.3, gamma=0.2, labels_by_id=labels, label_names=names, **kg)
    query_id = "q"
    if case == "constant_embeddings":
        embs[:] = embs[0]
    elif case == "no_kg":
        kw = {k: v for k, v in kw.items() if not k.startswith("kg")}
    elif case == "no_labels":
        query_id = "unknown"
    elif case == "kg_vectors":
        kw["kg_vectors_by_id"] = {c: rng.standard_normal(5) for c in cands[::2] + ["q"]}
    for topk in (None, 5):
        got = rerank.Reranker(**kw).rerank(query_id, cands, embs, query, topk=topk)
        want = jrerank.Reranker(**kw).rerank(query_id, cands, embs, query, topk=topk)
        assert got == want
    assert len(got) == 5
    if case == "constant_embeddings":
        assert all(r[2] == 0.0 for r in got)
    np.testing.assert_array_equal(rerank.minmax_scale(np.array([2.0, 2.0])), [0.0, 0.0])
    assert rerank.Reranker().rerank("q", [], embs[:0], query) == []


@pytest.mark.parametrize("size", [(1024, 1024), (300, 257), (100, 100)])
def test_preprocess_batch_matches_jax(rng, size):
    """Window, resize to 224 (down: JAX's antialiased bilinear; up), mean /
    std, 3 channels; windows that clip at both ends."""
    raw = rng.integers(0, 4096, (2,) + size).astype(np.float32)
    wc = np.array([1800.0, 2100.0], np.float32)
    ww = np.array([1200.0, 900.0], np.float32)
    jargs = [jnp.asarray(a) for a in (raw, wc, ww)]
    args = [torch.from_numpy(a) for a in (raw, wc, ww)]
    np.testing.assert_allclose(preprocess.window_normalize(*args).numpy(),
                               np.asarray(jpre.window_normalize(*jargs)), **PRE_TOL)
    for kw in (dict(), dict(out_hw=(112, 96), mean=0.4, std=0.25)):
        got = preprocess.preprocess_batch(*args, **kw).numpy()
        want = np.asarray(jpre.preprocess_batch(*jargs, **kw))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **PRE_TOL)
    if size[0] > 224:  # the trap: a bilinear resize without antialiasing is far off
        x = preprocess.window_normalize(*args)[:, None]
        plain = torch.nn.functional.interpolate(x, size=(224, 224), mode="bilinear")[:, 0]
        assert np.abs((plain.numpy() - 0.5) / 0.5 - np.asarray(
            jpre.preprocess_batch(*jargs))[..., 0]).max() > 0.1


def test_augment_with_matches_jax(rng):
    """JAX's augment_batch, and augment_with given the angles and flips JAX
    draws from the same key (its split, uniform, bernoulli), at a wide angle
    and a high flip rate so that edges clamp and both flips occur. Then the
    port's augment_batch: its draws from a generator, seeded."""
    images = rng.standard_normal((6, 28, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpre.augment_batch(jnp.asarray(images), key, 30.0, 0.5))
    k_rot, k_flip = jax.random.split(key)
    theta = np.array(jax.random.uniform(k_rot, (6,), minval=-1.0, maxval=1.0)
                     * 30.0 * jnp.pi / 180.0)
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (6,)))
    assert 0 < flip.sum() < 6
    got = preprocess.augment_with(torch.from_numpy(images), torch.from_numpy(theta),
                                  torch.from_numpy(flip))
    np.testing.assert_allclose(got.numpy(), want, **PRE_TOL)

    x = torch.from_numpy(images)
    a = preprocess.augment_batch(x, torch.Generator().manual_seed(1))
    b = preprocess.augment_batch(x, torch.Generator().manual_seed(1))
    c = preprocess.augment_batch(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    none = preprocess.augment_with(x, torch.zeros(6), torch.zeros(6, dtype=torch.bool))
    torch.testing.assert_close(none, x, rtol=0, atol=1e-6)
