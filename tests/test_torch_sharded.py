"""The port's sharded paths on a 2-rank mesh against JAX and against their
single-device results, on the CPU: ``retrieval/gallery.py``'s sharded top-K
and engine, ``kg/sharded_eval.py``, the mesh stream (``serve/stream.py``)
and the data-parallel artifact (``serve/exported.py``).

The two gloo ranks run once for the module (``tests/torch_mesh_ranks.py::
sharded_checks``, fresh interpreters); JAX runs on a ``Mesh`` of
``jax.devices()[:2]``.

- Top-K (raw dot products of about 10) over a 37-row gallery (two shards of 19 and a padding row) with 7
  duplicated rows and queries equal to gallery rows, at k = 5, 25 (more
  than a shard holds) and 37: ids equal to JAX's ``make_sharded_topk`` and
  engines (ties: the lower index first), scores within 1e-6 (relative).
- ``evaluate_sharded`` for TransE, TransH, RotatE and CompGCN on JAX's
  parameters (51 entities: padded): MRR and Hits equal to the port's
  ``evaluate`` and within 1e-12 of JAX's ``evaluate_sharded``.
- The stream and the artifact: the mesh's rows equal the single-device
  rows (probabilities and embeddings within 1e-6: each rank's GEMMs have
  half the rows), ids, label sets and retrieval ids equal; the artifact's
  single-device result is the live ``serving_forward``, which the
  single-device artifact equals (``tests/test_torch_exported.py``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmrp_tpu.kg import trainer as jtrainer
from mmrp_tpu.kg.sharded_eval import evaluate_sharded as jevaluate_sharded
from mmrp_tpu.parallel.mesh import build_mesh
from mmrp_tpu.retrieval.gallery import RetrievalEngine as JRetrievalEngine
from mmrp_tpu.retrieval.gallery import make_sharded_topk as jmake_sharded_topk
from mmrp_tpu_torch.parallel.dryrun import start_ranks

TESTS = str(Path(__file__).resolve().parent)
KG_MODELS = ["TransE", "TransH", "RotatE", "CompGCN"]
KG_CFG = dict(emb_dim=12, epochs=1, batch_size=64, neg_size=4, eval_chunk=10, num_layers=1)
E, R = 51, 5


def topk_inputs():
    rng = np.random.default_rng(11)
    gallery = rng.standard_normal((37, 16)).astype(np.float32)
    gallery[30:] = gallery[[0, 3, 5, 8, 13, 21, 29]]  # 7 duplicated rows
    queries = np.concatenate([gallery[[3, 30]], rng.standard_normal((3, 16))]).astype(np.float32)
    return gallery, queries


def kg_trainers():
    """JAX trainers with their parameters moved off init (every leaf)."""
    rng = np.random.default_rng(2)
    out = {}
    for name in KG_MODELS:
        triples = np.unique(np.stack([rng.integers(0, E, 240), rng.integers(0, R, 240),
                                      rng.integers(0, E, 240)], axis=1).astype(np.int32), axis=0)
        jt = jtrainer.KGTrainer(E, R, jtrainer.KGTrainerConfig(model=name, **KG_CFG))
        jt.load_triples([tuple(int(x) for x in t) for t in triples])
        jt.params = {k: jnp.asarray(np.asarray(v) + rng.standard_normal(np.shape(v)).astype(
            np.float32) * 0.05) for k, v in jt.params.items()}
        out[name] = (jt, triples)
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(the ranks' results, rank 0's arrays, JAX's results on the same
    inputs, computed while the ranks run)."""
    root = tmp_path_factory.mktemp("sharded")
    gallery, queries = topk_inputs()
    np.savez(root / "topk_inputs.npz", gallery=gallery, queries=queries)
    trainers = kg_trainers()
    spec = {}
    for name, (jt, triples) in trainers.items():
        np.savez(root / f"kg_{name}.npz", **{k: np.asarray(v) for k, v in jt.params.items()})
        spec[name] = {"E": E, "R": R, "cfg": dict(model=name, **KG_CFG),
                      "triples": triples.tolist()}
    (root / "kg.json").write_text(json.dumps(spec))
    ranks = start_ranks(2, "torch_mesh_ranks:sharded_checks", {"out": str(root)},
                        sys_path=[TESTS], timeout_s=300, threads=1)
    mesh = jax_mesh()
    want = {}
    padded = np.concatenate([gallery, np.zeros((1, 16), np.float32)])
    g = jax.device_put(padded, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp")))
    for k in (5, 25, 37):
        s, i = jmake_sharded_topk(mesh, "dp", k, n_real=len(gallery))(jnp.asarray(queries), g)
        want[f"topk_s{k}"], want[f"topk_i{k}"] = np.asarray(s), np.asarray(i)
    ids = [f"g{i}" for i in range(len(gallery))]
    engines = {"mesh": JRetrievalEngine(gallery, ids, mesh=mesh),
               "single": JRetrievalEngine(gallery, ids)}
    for k in (5, 37):
        for label, eng in engines.items():
            want[f"eng_{label}_s{k}"], want[f"eng_{label}_i{k}"] = eng.retrieve_batch(queries, k=k)
    want["retrieve"] = engines["mesh"].retrieve(gallery[3], K=5, query_id="g3")
    for name, (jt, _) in trainers.items():
        want[f"kg_{name}"] = jevaluate_sharded(jt, jt.val_arr, mesh)
    res = ranks.wait()
    with np.load(root / "sharded_out.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return res, arrays, want


def jax_mesh():
    return build_mesh(("dp",), (2,), jax.devices()[:2])


@pytest.mark.parametrize("k", [5, 25, 37])
def test_sharded_topk_matches_jax(sharded, k):
    _, arrays, want = sharded
    np.testing.assert_array_equal(arrays[f"topk_i{k}"], want[f"topk_i{k}"])
    np.testing.assert_allclose(arrays[f"topk_s{k}"], want[f"topk_s{k}"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [5, 37])
def test_engines_match_jax_with_ties(sharded, k):
    res, arrays, want = sharded
    for label in ("mesh", "single"):
        np.testing.assert_array_equal(arrays[f"eng_{label}_i{k}"], want[f"eng_{label}_i{k}"],
                                      err_msg=label)
        np.testing.assert_allclose(arrays[f"eng_{label}_s{k}"], want[f"eng_{label}_s{k}"],
                                   rtol=0, atol=1e-6)
    # the duplicated rows tie: the lower index first, on either path
    assert list(arrays[f"eng_mesh_i{k}"][0, :2]) == [3, 31]
    assert [h[0] for h in res[0]["retrieve"]] == [h[0] for h in want["retrieve"]]
    assert res[0]["retrieve"][0][0] == "g31"


@pytest.mark.parametrize("name", KG_MODELS)
def test_evaluate_sharded_matches_jax_and_evaluate(sharded, name):
    res, _, want = sharded
    want = want[f"kg_{name}"]
    for r in res:
        got = r["kg"][name]
        assert got["sharded"] == got["single"] == got["again"], got
        assert set(got["sharded"]) == set(want)
        for key in want:
            np.testing.assert_allclose(got["sharded"][key], want[key], rtol=1e-12, err_msg=key)


@pytest.mark.parametrize("n_pairs", [0, 5, 300])
def test_pad_pairs_matches_jax(n_pairs):
    """Filter pairs deduplicated and padded with col = -1 to JAX's capacity."""
    from mmrp_tpu.kg.sharded_eval import _pad_pairs as jpad
    from mmrp_tpu_torch.kg.sharded_eval import _pad_pairs

    rng = np.random.default_rng(n_pairs)
    rows, cols = rng.integers(0, 10, n_pairs), rng.integers(0, 51, n_pairs)
    rows, cols = np.concatenate([rows, rows[:n_pairs // 2]]), np.concatenate(
        [cols, cols[:n_pairs // 2]])  # duplicated pairs
    for got, want in zip(_pad_pairs(rows, cols), jpad(rows, cols)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_stream_on_a_mesh_matches_single_device(sharded):
    res, arrays, _ = sharded
    for r in res:  # every rank yields the whole rows
        mesh, single = r["stream"]["mesh"], r["stream"]["single"]
        assert mesh["ids"] == single["ids"] and mesh["predicted"] == single["predicted"]
        assert len(mesh["ids"][2]) == 3  # the padded row dropped
        for a, b in zip(mesh["retrieval"], single["retrieval"]):
            for qa, qb in zip(a, b):
                assert [h[0] for h in qa] == [h[0] for h in qb]
                np.testing.assert_allclose([h[1] for h in qa], [h[1] for h in qb], atol=1e-6)
        assert mesh["mesh"] == str(jax_mesh().shape) and single["mesh"] is None
    for key in ("probs", "emb"):
        np.testing.assert_allclose(arrays[f"stream_mesh_{key}"], arrays[f"stream_single_{key}"],
                                   rtol=0, atol=1e-6)


def test_artifact_on_a_mesh_matches_single_device(sharded):
    res, arrays, _ = sharded
    art = res[0]["artifact"]
    assert art["keys"] == ["cpu::4::2"]
    assert "span [2] devices" in art["unmeshed_error"]
    assert art["bucket_error"] == "batch buckets [3] not divisible by mesh size 2"
    for n in (3, 6):
        for key in ("probs", "joint_emb", "img_emb", "txt_emb"):
            got, want = arrays[f"art_mesh_{n}_{key}"], arrays[f"art_single_{n}_{key}"]
            assert got.shape[0] == n
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{n} {key}")
