"""The serving slice end to end: port against JAX on the CPU.

``serving_forward`` (probs, joint_emb, img_emb, txt_emb) of a tiny
multimodal model is held against the JAX ``serving_forward`` on its XLA
path and on its kernel routes (``MMRP_FORCE_PALLAS=1``: patches padded
49 -> 56 and the fusion sequence 51 -> 56 inside the JAX model, unpadded in
the port): the K1 + K2 Swin route (``MMRP_SWIN_WHOLE=0``), and the
whole-block routes of the default environment with the width gate lowered
to the tiny model's (``MMRP_SWIN_WHOLE_MINC=16``: the pair at stage 0, the
chain — or with ``MMRP_SWIN_CHAIN=0`` the windows flavor — at stage 1).
Then the routing of Swin-B, predict's thresholds, exact top-K retrieval
against the JAX ``RetrievalEngine``, the npz weight bridge, the default
device, and the port's freedom from JAX.

Tolerance 5e-4: the whole stack (2 Swin stages, a BERT layer, 2 fusion
layers, the head) in f32, with sums in other orders and Flax's one-pass LN
variance against the port's two-pass.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.api import serving_forward as jax_serving_forward
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.retrieval.gallery import RetrievalEngine as JRetrievalEngine
from mmrp_tpu_torch.api import MMRPredictor, serving_forward
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig, stage_routes, swin_plan
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine, topk_single
from mmrp_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=5e-4, atol=5e-4)
SWIN = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2))
TEXT = dict(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64)
HEAD = dict(joint_dim=64, num_fusion_layers=2, num_heads=4, num_classes=7, max_text_len=16)
KEYS = ("probs", "joint_emb", "img_emb", "txt_emb")


def randomize(params, seed=0):
    """Every leaf + N(0, 0.02^2); ``alpha`` (zero at init) -> 0.5 + N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.02
        if getattr(path[-1], "key", None) == "alpha":
            return jnp.asarray(0.5 + noise)
        return jnp.asarray(np.asarray(leaf) + noise)

    return jax.tree_util.tree_map_with_path(move, params)


def inputs(B=2, L=16, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((B, 56, 56, 3), dtype=np.float32)
    ids = rng.integers(0, 8192, (B, L)).astype(np.int32)
    lengths = np.array([L, 9, 1, 5][:B])
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return img, ids, mask


def build(mode="multimodal", seed=0):
    """(JAX model, randomized JAX params, port model with the same weights)."""
    jcfg = jmm.MultiModalConfig(
        swin=JSwinConfig(**SWIN), text=JTextConfig.small(dropout=0.0, **TEXT), mode=mode,
        dropout=0.0, drop_path=0.0, **HEAD)
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    img, ids, mask = inputs()
    params = randomize(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(img),
                                   jnp.asarray(ids), jnp.asarray(mask))["params"], seed)
    tcfg = MultiModalConfig(swin=SwinConfig(**SWIN), text=TextConfig.small(**TEXT), mode=mode,
                            **HEAD)
    tmodel = MultiModalRetrievalModel(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel.eval()


def run_port(tmodel, img, ids, mask):
    out = serving_forward(tmodel)(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask))
    return {k: v.numpy() for k, v in out.items()}


def run_jax(jmodel, params, img, ids, mask):
    out = jax_serving_forward(jmodel)(params, jnp.asarray(img), jnp.asarray(ids),
                                      jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def multimodal():
    return build("multimodal")


# JAX environment and port SwinConfig fields of each route; the port's
# default SwinConfig (whole_min_c=256) runs the tiny model's stages on K1 + K2
ROUTES = {
    "xla": ({}, {}),
    "slice": ({"MMRP_FORCE_PALLAS": "1", "MMRP_SWIN_WHOLE": "0"}, {"whole_block": False}),
    "whole": ({"MMRP_FORCE_PALLAS": "1", "MMRP_SWIN_WHOLE_MINC": "16"}, {"whole_min_c": 16}),
    "whole_nochain": ({"MMRP_FORCE_PALLAS": "1", "MMRP_SWIN_WHOLE_MINC": "16",
                       "MMRP_SWIN_CHAIN": "0"}, {"whole_min_c": 16, "chain": False}),
}


def on_route(tmodel, swin_fields):
    """A port model on another Swin route, loaded with the same Flax
    parameters through the bridge: the routes share one parameter tree."""
    if not swin_fields:
        return tmodel
    cfg = tmodel.config
    model = MultiModalRetrievalModel(
        dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, **swin_fields)),
        device="cpu")
    assert model.state_dict().keys() == tmodel.state_dict().keys()
    return model.eval()


@pytest.mark.parametrize("route", list(ROUTES))
def test_serving_forward_matches_jax(multimodal, monkeypatch, route):
    jmodel, params, tmodel = multimodal
    env, swin_fields = ROUTES[route]
    for key in ("MMRP_FORCE_PALLAS", "MMRP_SWIN_WHOLE", "MMRP_SWIN_WHOLE_MINC",
                "MMRP_SWIN_CHAIN"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    tmodel = on_route(tmodel, swin_fields)
    if tmodel is not multimodal[2]:
        load_flax_params(tmodel, params)
    img, ids, mask = inputs()
    want = run_jax(jmodel, params, img, ids, mask)
    got = run_port(tmodel, img, ids, mask)
    for key in KEYS:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_swin_routes_follow_the_jax_gates():
    """Swin-B at 224 px: K1 + K2 at stage 1 (C = 128 < 256), the pair at
    stage 2, the chain at stage 3 (18 blocks, rolls -3 / +3 alternating, the
    last back to the unshifted frame), the windows flavor at stage 4, where
    the chain's gate fails; and the tiny test model on the routes above."""
    base = SwinConfig.base()
    assert stage_routes(base) == ["k1k2", "pair", "chain", "windows"]
    plan = swin_plan(base)
    assert [len(steps) for steps in plan] == [2, 1, 18, 2]
    assert [s.roll_after for s in plan[2]] == [-3, 3] * 9
    assert stage_routes(dataclasses.replace(base, whole_block=False)) == ["k1k2"] * 4
    assert stage_routes(dataclasses.replace(base, chain=False)) == \
        ["k1k2", "pair", "windows", "windows"]
    assert stage_routes(dataclasses.replace(base, pair=False)) == \
        ["k1k2", "chain", "chain", "windows"]
    tiny = SwinConfig(**SWIN)
    assert stage_routes(tiny) == ["k1k2", "k1k2"]
    assert stage_routes(dataclasses.replace(tiny, whole_min_c=16)) == ["pair", "chain"]
    assert stage_routes(dataclasses.replace(tiny, whole_min_c=16, chain=False)) == \
        ["pair", "windows"]
    # odd depth: the pair's tail block is a chain step with no roll
    odd = swin_plan(dataclasses.replace(base, depths=(2, 3, 18, 2)))[1]
    assert [(s.route, s.block, s.roll_after) for s in odd] == [("pair", 0, 0), ("chain", 2, 0)]


@pytest.mark.parametrize("mode", ["image", "text"])
def test_unimodal_modes_match_jax(monkeypatch, mode):
    monkeypatch.delenv("MMRP_FORCE_PALLAS", raising=False)
    jmodel, params, tmodel = build(mode, seed=1)
    img, ids, mask = inputs()
    want = run_jax(jmodel, params, img, ids, mask)
    got = run_port(tmodel, img, ids, mask)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_predict_thresholds_and_retrieval(multimodal):
    _, _, tmodel = multimodal
    img, ids, mask = inputs()
    labels = [f"label{i}" for i in range(7)]
    probs = run_port(tmodel, img, ids, mask)["probs"]

    # scalar threshold midway in the widest gap of the sorted probabilities
    srt = np.sort(probs.ravel())
    gap = int(np.argmax(np.diff(srt)))
    thr = float((srt[gap] + srt[gap + 1]) / 2)
    pred = MMRPredictor(tmodel, labels, threshold=thr).predict(img, ids, mask, top_k_labels=3)
    np.testing.assert_array_equal(pred["probs"], probs)
    for b in range(2):
        assert [n for n, _ in pred["predicted"][b]] == \
            [labels[i] for i in np.where(probs[b] > thr)[0]]
        assert [n for n, _ in pred["top_labels"][b]] == \
            [labels[i] for i in np.argsort(-probs[b])[:3]]
    assert "retrieval" not in pred

    # per-class thresholds: class i passes iff its threshold sits below p
    per_class = np.where(np.arange(7) % 2 == 0, 0.0, 1.1)
    pred = MMRPredictor(tmodel, labels, threshold=per_class).predict(img, ids, mask)
    assert [n for n, _ in pred["predicted"][0]] == labels[0::2]

    # retrieval: the queries' own rows are found at rank 1
    rng = np.random.default_rng(5)
    gal = np.concatenate([rng.standard_normal((30, 64)).astype(np.float32),
                          pred["joint_emb"]])
    gids = [f"g{i}" for i in range(30)] + ["q0", "q1"]
    pred = MMRPredictor(tmodel, labels, retriever=RetrievalEngine(gal, gids, device="cpu")).predict(
        img, ids, mask, K=3)
    assert [hits[0][0] for hits in pred["retrieval"]] == ["q0", "q1"]
    assert all(len(hits) == 3 for hits in pred["retrieval"])


def test_predict_applies_query_id_only_for_a_single_request(multimodal):
    _, _, tmodel = multimodal
    img, ids, mask = inputs()
    emb = run_port(tmodel, img, ids, mask)["joint_emb"]
    engine = RetrievalEngine(emb, ["q0", "q1"], device="cpu")
    pred = MMRPredictor(tmodel, ["a"] * 7, retriever=engine).predict(
        img, ids, mask, K=2, query_id="q0")
    assert pred["retrieval"][0][0][0] == "q0"  # B == 2: query_id ignored
    pred = MMRPredictor(tmodel, ["a"] * 7, retriever=engine).predict(
        img[:1], ids[:1], mask[:1], K=2, query_id="q0")
    assert [h[0] for h in pred["retrieval"][0]] == ["q1"]


@pytest.mark.parametrize("K,query_id", [(5, None), (50, None), (5, "g3"), (30, "g7")])
def test_retrieval_matches_jax_engine(K, query_id):
    rng = np.random.default_rng(11)
    gal = rng.standard_normal((20, 16)).astype(np.float32)
    gal[4] = 0.0  # a zero row: normalization eps
    ids = [f"g{i}" for i in range(20)]
    q = gal[3] + 0.3 * rng.standard_normal(16).astype(np.float32)
    want = JRetrievalEngine(gal, ids).retrieve(q, K=K, query_id=query_id)
    got = RetrievalEngine(gal, ids, device="cpu").retrieve(q, K=K, query_id=query_id)
    assert [r for r, _ in got] == [r for r, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-6)
    assert len(got) == min(K, 20 - (query_id is not None))
    emb = RetrievalEngine(gal, ids, device="cpu").get_embeddings_for_ids(["g1", "nope"])
    np.testing.assert_array_equal(emb, JRetrievalEngine(gal, ids).get_embeddings_for_ids(
        ["g1", "nope"]))


def test_topk_single_scores_pad_rows_minus_inf():
    gal = torch.tensor([[-1.0, 0.0], [0.0, -1.0], [0.0, 0.0], [0.0, 0.0]])
    s, i = topk_single(torch.tensor([[1.0, 0.0]]), gal, k=2, n_real=2)
    assert i.tolist() == [[1, 0]]
    assert s.tolist() == [[0.0, -1.0]]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bridge_round_trips_a_save_param_tree_npz(multimodal, tmp_path, direction):
    """JAX's save_param_tree npz into a port model, bit for bit; and the
    inverse, as a run directory's joint/params.npz is written: a port model's
    seeded weights through state_dict_to_flax_flat and the port's
    save_param_tree, read by JAX's load_param_tree into the JAX model, whose
    serving forward then matches the port's."""
    from mmrp_tpu.utils.checkpoint import load_param_tree, save_param_tree
    from mmrp_tpu_torch.utils import convert

    jmodel, params, tmodel = multimodal
    path = tmp_path / "params.npz"
    if direction == "port_to_jax":
        model = MultiModalRetrievalModel(tmodel.config, device="cpu").eval()
        convert.init_params(model, seed=5)
        flat = convert.state_dict_to_flax_flat(model)
        want = {"/".join(str(k.key) for k in kp) for kp, _ in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        assert set(flat) == want
        convert.save_param_tree(path, {f"model/{k}": v for k, v in flat.items()})
        tree = load_param_tree(str(path))
        assert set(tree) == {"model"}
        for key, val in flax_to_state_dict(tree).items():
            np.testing.assert_array_equal(val.numpy(), model.state_dict()[key].numpy(),
                                          err_msg=key)
        img, ids, mask = inputs()
        got, want = run_port(model, img, ids, mask), run_jax(jmodel, tree, img, ids, mask)
        for key in KEYS:
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
        return
    save_param_tree(str(path), {"params": params})
    fresh = MultiModalRetrievalModel(tmodel.config, device="cpu")
    load_flax_params(fresh, str(path))
    want = flax_to_state_dict(params)
    for key, val in fresh.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), want[key].numpy(), err_msg=key)
    # the static Swin biases are rebuilt from the loaded tables
    torch.testing.assert_close(fresh.backbones.swin.stage0_block1.attn.bias_full,
                               tmodel.backbones.swin.stage0_block1.attn.bias_full)


def test_init_params_is_seeded_and_leaves_no_parameter_zero():
    from mmrp_tpu_torch.ops.fused_window_attention import build_bias_full
    from mmrp_tpu_torch.utils.convert import init_params

    cfg = MultiModalConfig(swin=SwinConfig(**SWIN), text=TextConfig.small(**TEXT), **HEAD)
    a, b = (MultiModalRetrievalModel(cfg, device="cpu") for _ in range(2))
    init_params(a, seed=3)
    init_params(b, seed=3)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert bool((pa != 0).any()), name
    alphas = [p.item() for n, p in a.named_parameters() if n.endswith("alpha")]
    assert len(alphas) == 4 and all(0.25 <= v <= 0.75 for v in alphas)
    attn = a.backbones.swin.stage0_block1.attn
    torch.testing.assert_close(attn.bias_full, build_bias_full(
        attn.rel_bias_table.detach(), attn.window_size, 14, 14, attn.shift))


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument the entry points build on CUDA, and say so
    clearly where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from mmrp_tpu_torch.models.multimodal import Backbones
    from mmrp_tpu_torch.models.swin import SwinEncoder
    from mmrp_tpu_torch.models.text_encoder import TextEncoder

    cfg = MultiModalConfig(swin=SwinConfig(**SWIN), text=TextConfig.small(**TEXT), **HEAD)
    for build_it in (lambda: MultiModalRetrievalModel(cfg), lambda: Backbones(cfg),
                     lambda: SwinEncoder(cfg.swin), lambda: TextEncoder(cfg.text),
                     lambda: RetrievalEngine(np.eye(2, dtype=np.float32), ["a", "b"])):
        with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
            build_it()


def test_port_imports_no_jax():
    """Every module of the package, and chip_smoke.py (imported, not run),
    in a fresh interpreter: none of them brings in JAX, Flax, optax, PyYAML or the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mmrp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mmrp_tpu_torch.__path__, "
        "'mmrp_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert len(names) >= 20 and 'mmrp_tpu_torch.ops.wattn_core' in names, names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'mmrp_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
