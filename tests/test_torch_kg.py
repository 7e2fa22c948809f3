"""The knowledge graph: port against JAX on the CPU.

``ops/kg_ops.py``, the four KG models (``kg/models.py``), one
``KGTrainer`` step with JAX's negatives, corrupted sides and CompGCN dropout
masks passed in (``KGTrainer.draw`` replaced), the filtered ranking,
``KGBuilder``'s artifacts, and the LabelAttention trainer (its step, a whole
training run and its npz, read by both packages). Weights go from JAX to the
port as numpy arrays under JAX's names.

Tolerances: scores, tables and losses 2e-5 (f32 sums in other orders:
``torch.cdist`` / ``torch.fft`` against XLA's); parameters after one Adam
step 1e-6 absolute with lr 1e-3: Adam moves each element by ~lr * sign(g),
so an element whose gradient differs by rounding alone may move differently,
held to 2 lr and all but 1 in 1,000 to 1% of lr; filtered MRR / Hits exact
up to score ties (none at these seeds); builder artifacts byte for byte; the
LabelAttention run 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.kg import builder as jbuilder
from mmrp_tpu.kg import label_attention as jla
from mmrp_tpu.kg import models as jmodels
from mmrp_tpu.kg import trainer as jtrainer
from mmrp_tpu.ops import kg_ops as jops
from mmrp_tpu_torch.kg import builder as tbuilder
from mmrp_tpu_torch.kg import label_attention as tla
from mmrp_tpu_torch.kg import models as tmodels
from mmrp_tpu_torch.kg import trainer as ttrainer
from mmrp_tpu_torch.labels import LABEL_COLS
from mmrp_tpu_torch.ops import kg_ops as tops

TOL = dict(rtol=2e-5, atol=2e-5)
E, R, D = 40, 5, 12


def t(a):
    return torch.from_numpy(np.array(a))


def to_torch(params):
    return {k: t(v) for k, v in params.items()}


def test_kg_ops_match_jax(rng):
    a = rng.standard_normal((6, 16)).astype(np.float32)
    b = rng.standard_normal((6, 16)).astype(np.float32)
    np.testing.assert_allclose(tops.ccorr(t(a), t(b)).numpy(),
                               np.asarray(jops.ccorr(jnp.asarray(a), jnp.asarray(b))), **TOL)
    for opn in ("corr", "sub", "mult"):
        np.testing.assert_allclose(
            tops.compose(t(a), t(b), opn).numpy(),
            np.asarray(jops.compose(jnp.asarray(a), jnp.asarray(b), opn)), **TOL)
    with pytest.raises(ValueError, match="unknown composition"):
        tops.compose(t(a), t(b), "nope")
    row = rng.integers(0, 9, 30).astype(np.int32)
    col = rng.integers(0, 9, 30).astype(np.int32)
    np.testing.assert_allclose(tops.compute_norm(t(row), t(col), 10).numpy(),
                               np.asarray(jops.compute_norm(jnp.asarray(row), jnp.asarray(col),
                                                            10)), **TOL)
    np.testing.assert_allclose(tops.degree_norm(t(col), 10).numpy(),
                               np.asarray(jops.degree_norm(jnp.asarray(col), 10)), **TOL)
    msgs = rng.standard_normal((30, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tops.segment_mean_messages(t(msgs), t(col), 10).numpy(),
        np.asarray(jops.segment_mean_messages(jnp.asarray(msgs), jnp.asarray(col), 10)), **TOL)


def model_cfgs(name, rng):
    kw = {}
    if name == "CompGCN":
        edges = rng.integers(0, E, (60, 2))
        kw = dict(edge_src=edges[:, 0].astype(np.int32), edge_dst=edges[:, 1].astype(np.int32),
                  edge_rel=rng.integers(0, R, 60).astype(np.int32), dropout=0.3)
    return (jmodels.KGModelConfig(name=name, num_entities=E, num_relations=R, emb_dim=D, **kw),
            tmodels.KGModelConfig(name=name, num_entities=E, num_relations=R, emb_dim=D, **kw))


def moved(params, seed=0):
    """JAX's init with every leaf moved (CompGCN's zero biases and unit BN
    scales too), as numpy."""
    r = np.random.default_rng(seed)
    return {k: np.asarray(v) + (r.standard_normal(np.shape(v)) * 0.05).astype(np.float32)
            for k, v in params.items()}


@pytest.mark.parametrize("name", ["TransE", "TransH", "RotatE", "CompGCN"])
def test_kg_models_match_jax(rng, name):
    """Tables, score and score_all (tails and heads) on JAX's parameters; the
    port's init has JAX's names and shapes."""
    jcfg, tcfg = model_cfgs(name, rng)
    params = moved(jmodels.init_params(jcfg, jax.random.PRNGKey(0)))
    own = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in params.items()}
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, to_torch(params)
    s, r, o = (rng.integers(0, n, 9) for n in (E, R, E))
    want = jmodels.make_score_fn(jcfg)(jp, jnp.asarray(s), jnp.asarray(r), jnp.asarray(o))
    got = tmodels.make_score_fn(tcfg)(tp, t(s), t(r), t(o))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jt = jmodels.make_tables_fn(jcfg)(jp)
    tt = tmodels.make_tables_fn(tcfg)(tp)
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for tails in (True, False):
        want = jmodels.make_score_all_fn(jcfg, tails)(jp, jnp.asarray(s), jnp.asarray(r))
        got = tmodels.make_score_all_fn(tcfg, tails)(tp, t(s), t(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tmodels.final_entity_table(tcfg, tp),
                               jmodels.final_entity_table(jcfg, jp), **TOL)


def triples(rng, n=120):
    return [(int(a), int(b), int(c)) for a, b, c in
            zip(rng.integers(0, E, n), rng.integers(0, R, n), rng.integers(0, E, n))]


def both_trainers(name, rng, **kw):
    trip = triples(rng)
    conf = rng.random(len(trip)).astype(np.float32).tolist()
    src = [("curated", "extracted", "doid")[i % 3] for i in range(len(trip))]
    cfg = dict(model=name, emb_dim=D, batch_size=32, neg_size=4, epochs=1, eval_chunk=16, **kw)
    jt = jtrainer.KGTrainer(E, R, jtrainer.KGTrainerConfig(**cfg))
    jt.load_triples(trip, conf, src)
    tt = ttrainer.KGTrainer(E, R, ttrainer.KGTrainerConfig(**cfg), device="cpu")
    tt.load_triples(trip, conf, src)
    params = moved(jt.params, 1)
    jt.params = {k: jnp.asarray(v) for k, v in params.items()}
    tt.params = to_torch(params)
    return jt, tt


def test_triple_loading_and_confidences_match_jax(rng):
    jt, tt = both_trainers("TransE", rng)
    np.testing.assert_array_equal(tt.train_arr, jt.train_arr)
    np.testing.assert_array_equal(tt.val_arr, jt.val_arr)
    np.testing.assert_array_equal(tt.train_conf, jt.train_conf)
    for key in ("sr", "or"):
        for a, b in zip(tt._known[key], jt._known[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,bf16", [("TransE", False), ("TransE", True), ("TransH", False),
                                       ("RotatE", False), ("CompGCN", False)])
def test_kg_train_step_matches_jax(rng, name, bf16):
    """One step on the same batch with JAX's draws (negatives, sides, and
    CompGCN's dropout masks from its key) through ``KGTrainer.draw``: the
    loss, the metrics and every parameter after the Adam update. bf16
    scoring: loss within 2e-2 relative (bf16 scores), parameters within 2 lr."""
    jt, tt = both_trainers(name, rng, use_bf16=bf16)
    tx, jstep = jt._make_train_step()
    jp = dict(jt.params)
    idx = np.arange(32)
    key = jax.random.PRNGKey(7)
    k_ent, k_side, k_drop = jax.random.split(key, 3)
    neg = jax.random.randint(k_ent, (32, 4), 0, E)
    side = jax.random.bernoulli(k_side, 0.5, (32, 1))
    masks = None
    if name == "CompGCN":
        keys = jax.random.split(k_drop, 2 * tt.model_cfg.num_layers)
        masks = [t(jax.random.bernoulli(k, 0.7, (E, D))) for k in keys]
    params_before = {k: np.array(v) for k, v in jp.items()}
    jp2, _, jm = jstep(jp, tx.init(jp), jnp.asarray(jt.train_arr[idx]),
                       jnp.asarray(jt.train_conf[idx]), key)
    tt.draw = lambda B, g: (t(neg).long(), t(side), masks)
    ttx, tstep = tt._make_train_step()
    tp, _, tm = tstep(tt.params, ttx.init(tt.params), t(tt.train_arr[idx]).long(),
                      t(tt.train_conf[idx]), tt.draw(32, None))
    rtol = 2e-2 if bf16 else 2e-5
    for k in ("loss", "pos_score", "neg_score"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=rtol, atol=rtol,
                                   err_msg=k)
    lr = tt.cfg.lr
    n_far = 0
    # CompGCN's bias_{layer} feeds a batch norm over the entities, which
    # subtracts it again: its gradient is zero up to rounding, which Adam's
    # first step turns into +-lr either way; only the 2 lr bound holds there
    noise = {k for k in params_before if k.startswith("bias_")}
    for k in params_before:
        d = np.abs(tp[k].detach().numpy() - np.asarray(jp2[k]))
        assert d.max() <= 2 * lr, k
        if k not in noise:
            n_far += int((d > 1e-2 * lr).sum())
    if not bf16:
        assert n_far <= sum(v.size for v in params_before.values()) // 1000


def jax_draws(tt, seed):
    """``KGTrainer.draw`` as JAX's train loop draws: one key split off per
    step, the step's negatives, sides and CompGCN dropout masks from it."""
    state = {"rng": jax.random.PRNGKey(seed)}

    def draw(B, generator):
        state["rng"], sub = jax.random.split(state["rng"])
        k_ent, k_side, k_drop = jax.random.split(sub, 3)
        neg = jax.random.randint(k_ent, (B, tt.cfg.neg_size), 0, E)
        side = jax.random.bernoulli(k_side, 0.5, (B, 1))
        masks = None
        if tt.cfg.model == "CompGCN":
            keys = jax.random.split(k_drop, 2 * tt.model_cfg.num_layers)
            masks = [t(jax.random.bernoulli(k, 1.0 - tt.model_cfg.dropout, (E, D)))
                     for k in keys]
        return t(neg).long(), t(side), masks

    return draw


@pytest.mark.parametrize("name", ["TransE", "CompGCN"])
def test_kg_train_loop_matches_jax(rng, name):
    """Both packages' ``KGTrainer.train`` for 3 epochs from the same weights,
    the port given JAX's draws: each epoch's logged loss and filtered val
    metrics, the best epoch and the kept (best) parameters. Tolerances: the
    losses 1e-4 relative, the val metrics 1e-6, the parameters 1e-5, but
    CompGCN's ``bias_{layer}`` 2 lr per step taken (its gradient is zero up
    to rounding, as for one step above)."""
    import dataclasses

    jt, tt = both_trainers(name, rng)
    jt.cfg = dataclasses.replace(jt.cfg, epochs=3)
    tt.cfg = dataclasses.replace(tt.cfg, epochs=3)
    tt.draw = jax_draws(tt, tt.cfg.seed)

    class Log:
        def __init__(self):
            self.rows = []

        def log(self, metrics, step):
            self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    jlog, tlog = Log(), Log()
    want, got = jt.train(metric_writer=jlog), tt.train(metric_writer=tlog)
    assert [s for s, _ in tlog.rows] == [s for s, _ in jlog.rows] == [0, 1, 2]
    for (_, g), (_, w) in zip(tlog.rows, jlog.rows):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["kg/loss"], w["kg/loss"], rtol=1e-4)
        for k in w:
            if k != "kg/loss":
                np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)
    assert got["epoch"] == want["epoch"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    steps = 3 * -(-len(tt.train_arr) // tt.cfg.batch_size)
    for k, v in jt.params.items():
        d = np.abs(tt.params[k].detach().numpy() - np.asarray(v))
        assert d.max() <= (2 * tt.cfg.lr * steps if k.startswith("bias_") else 1e-5), k


@pytest.mark.parametrize("name", ["TransE", "CompGCN"])
def test_filtered_evaluation_matches_jax(rng, name):
    jt, tt = both_trainers(name, rng)
    want = jt.evaluate(jt.val_arr)
    got = tt.evaluate(tt.val_arr)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    # the train split: every positive filtered but its own
    np.testing.assert_allclose(tt.evaluate(tt.train_arr[:40])["mrr"],
                               jt.evaluate(jt.train_arr[:40])["mrr"], rtol=1e-12)


def test_kg_train_loop_and_artifacts(rng, tmp_path):
    """A seeded run: finite per-step losses, the loss falls over epochs,
    renorm leaves unit rows, the best epoch's parameters are kept, and the
    saved artifacts read back by both packages' loaders."""
    trip = triples(rng, 400)
    tt = ttrainer.KGTrainer(E, R, ttrainer.KGTrainerConfig(emb_dim=D, batch_size=64, epochs=6,
                                                           neg_size=8, lr=1e-2), device="cpu")
    tt.load_triples(trip)
    first = None
    best = tt.train()
    assert np.isfinite(tt.step_losses).all() and best["epoch"] >= 0
    first = ttrainer.KGTrainer(E, R, ttrainer.KGTrainerConfig(emb_dim=D, batch_size=64,
                                                              epochs=1, neg_size=8, lr=1e-2),
                               device="cpu")
    first.load_triples(trip)
    first.train()
    assert np.mean(tt.step_losses) < np.mean(first.step_losses)
    names = [f"n{i}" for i in range(E)]
    tt.save(str(tmp_path), node_names=names)
    emb, meta = ttrainer.KGTrainer.load_embeddings(str(tmp_path), expected_dim=D + 3, seed=1)
    jemb, jmeta = jtrainer.KGTrainer.load_embeddings(str(tmp_path), expected_dim=D + 3, seed=1)
    np.testing.assert_array_equal(emb, jemb)
    assert meta == jmeta and meta["entity_table_dim"] == D
    (tmp_path / "node2id.json").write_text(json.dumps({"label:Cardiomegaly": 3}))
    got = ttrainer.KGTrainer.ensure_label_embeddings(str(tmp_path), LABEL_COLS[:4])
    want = jtrainer.KGTrainer.ensure_label_embeddings(str(tmp_path), LABEL_COLS[:4])
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


OBO = """format-version: 1.2

[Term]
id: DOID:1
name: disease
synonym: "illness" EXACT []

[Term]
id: DOID:2
name: lung disease
is_a: DOID:1 ! disease
xref: MESH:D008171

[Typedef]
id: part_of
"""

OWL = """<?xml version="1.0"?>
<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"
         xmlns:owl="http://www.w3.org/2002/07/owl#"
         xmlns:rdfs="http://www.w3.org/2000/01/rdf-schema#">
  <owl:Class rdf:about="http://radlex.org/RID/RID1">
    <rdfs:label>anatomical entity</rdfs:label>
  </owl:Class>
  <owl:Class rdf:about="http://radlex.org/RID/RID2">
    <rdfs:subClassOf rdf:resource="http://radlex.org/RID/RID1"/>
    <rdfs:label>lung</rdfs:label>
  </owl:Class>
</rdf:RDF>
"""


def test_kg_builder_artifacts_are_byte_equal(rng, tmp_path):
    records = [{"id": f"r{i}", "labels": (rng.random(len(LABEL_COLS)) < 0.2).astype(int).tolist()}
               for i in range(12)]
    (tmp_path / "d.obo").write_text(OBO)
    (tmp_path / "r.owl").write_text(OWL)
    (tmp_path / "c.csv").write_text("s,r,o,confidence\nlabel:Cardiomegaly,ASSOC,doid:DOID:2,0.5\n")
    outs = []
    for mod, name in ((jbuilder, "jax"), (tbuilder, "port")):
        b = mod.KGBuilder(out_dir=str(tmp_path / name))
        b.build_from_records(records, LABEL_COLS)
        assert b.add_doid_obo(str(tmp_path / "d.obo")) == 2
        assert b.add_radlex_owl(str(tmp_path / "r.owl")) == 2
        b.add_label_ontology_mapping({"Cardiomegaly": "doid:DOID:2", "Edema": "LOCAL:"})
        assert b.add_curated_csv(str(tmp_path / "c.csv")) == 1
        b.save()
        outs.append(tmp_path / name)
        loaded = mod.KGBuilder.load(str(tmp_path / name))
        assert loaded.triples == b.triples
    for f in ("triples.csv", "node2id.json", "relation2id.json", "entity_meta.json"):
        assert (outs[0] / f).read_bytes() == (outs[1] / f).read_bytes(), f
    arrays = [mod.KGBuilder.load(str(o)).triple_arrays() for mod, o in
              ((jbuilder, outs[0]), (tbuilder, outs[1]))]
    for a, b in zip(*arrays):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def la_data(rng, n=24, table_rows=30, dim=8):
    table = rng.standard_normal((table_rows, dim)).astype(np.float32)
    sets = [sorted(set(rng.integers(0, table_rows, rng.integers(1, 5)).tolist()))
            for _ in range(n)]
    vecs = (rng.random((n, 6)) < 0.4).astype(np.float32)
    return table, sets, vecs


def port_trainer_from(jt, table, cfg):
    """A port trainer holding the JAX trainer's weights (its npz)."""
    tt = tla.LabelAttentionTrainer(table, tla.LabelAttentionTrainerConfig(**cfg), device="cpu")
    tt.init(torch.Generator().manual_seed(0))
    p = jt.params["params"]
    with torch.no_grad():
        for name in ("Dense_0", "Dense_1"):
            lin = getattr(tt.model, name)
            lin.weight.copy_(t(np.asarray(p[name]["kernel"]).T))
            lin.bias.copy_(t(p[name]["bias"]))
        tt.log_temp.copy_(t(jt.log_temp))
    return tt


def test_label_attention_trainer_step_and_run_match_jax(rng):
    """The loss terms and the gradient step on one batch, then a whole
    3-epoch run from the same weights (numpy-seeded order, no other draw):
    the best loss and epoch, the pooled vectors and recall@K."""
    table, sets, vecs = la_data(rng)
    cfg = dict(hidden_dim=16, batch_size=8, epochs=3, lr=5e-3, pos_jaccard=0.3)
    jt = jla.LabelAttentionTrainer(table, jla.LabelAttentionTrainerConfig(**cfg))
    jt.init(jax.random.PRNGKey(0))
    r = np.random.default_rng(3)
    jt.params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + r.standard_normal(v.shape).astype(np.float32)
                              * 0.1), jt.params)
    tt = port_trainer_from(jt, table, cfg)
    idx = np.arange(8)
    embs, mask = jla._pad_label_embs([sets[i] for i in idx], table, 16)
    pos = jla.jaccard_matrix(vecs)[np.ix_(idx, idx)] >= 0.3
    tx, jstep = jt._make_step()
    variables = (jt.params, jt.log_temp)
    variables, _, aux = jstep(variables, tx.init(variables), jnp.asarray(embs),
                              jnp.asarray(mask), jnp.asarray(pos), jax.random.PRNGKey(1))
    ttx, tstep = tt._make_step()
    _, taux = tstep(ttx.init(tt.params()), t(embs), t(mask), t(pos))
    for k in ("loss", "ice", "tpl", "bce"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tt.model.Dense_0.weight.detach().numpy().T,
                               np.asarray(variables[0]["params"]["Dense_0"]["kernel"]),
                               atol=1e-6)
    np.testing.assert_allclose(float(tt.log_temp), float(variables[1]), atol=1e-6)

    jt2 = jla.LabelAttentionTrainer(table, jla.LabelAttentionTrainerConfig(**cfg))
    jt2.init(jax.random.PRNGKey(0))
    tt2 = port_trainer_from(jt2, table, cfg)
    want, got = jt2.train(sets, vecs), tt2.train(sets, vecs)
    assert got["epoch"] == want["epoch"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(tt2.pool(sets), jt2.pool(sets), rtol=1e-5, atol=1e-5)
    assert tt2.eval_retrieval(sets, vecs) == jt2.eval_retrieval(sets, vecs)
    np.testing.assert_array_equal(tla.jaccard_matrix(vecs), jla.jaccard_matrix(vecs))


def test_label_attention_npz_is_read_by_both_packages(rng, tmp_path):
    table, sets, vecs = la_data(rng)
    tt = tla.LabelAttentionTrainer(table, tla.LabelAttentionTrainerConfig(hidden_dim=16,
                                                                          epochs=1),
                                   device="cpu")
    tt.train(sets, vecs)
    tt.save(str(tmp_path / "port.npz"))
    jt = jla.LabelAttentionTrainer.from_checkpoint(str(tmp_path / "port.npz"), table)
    np.testing.assert_allclose(jt.pool(sets), tt.pool(sets), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(jt.log_temp), float(tt.log_temp), rtol=0)
    jt.save(str(tmp_path / "jax.npz"))
    back = tla.LabelAttentionTrainer.from_checkpoint(str(tmp_path / "jax.npz"), table,
                                                     device="cpu")
    np.testing.assert_array_equal(back.pool(sets), tt.pool(sets))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
