"""The port's explain path against JAX's on the CPU.

The micro model of ``tests/test_explain_api.py`` (Swin 28 px with one stage,
a one-layer 16-wide text tower, one fusion layer at 16) with the same
randomized weights in both packages (``utils/convert.py``), in f32: the
model's explain hooks (attention weights, the features path, gradients
through ``patch_delta`` / ``txt_delta``), every ``ExplanationEngine`` method,
``explain`` with scalar and per-sample targets, ``predict(explain=True)``,
``compare_maps``, the upsampling of ``patch_vector_to_map``, the kernels'
gradient route (``ops/_build.py::KernelRecompute``) with a planted kernel,
and the consumers: ``retrieval_explain_eval``, the diversity report and
``utils/viz.py``.

Tolerances, stated per test: maps and weights rtol 1e-4 / atol 1e-5 (the
same f32 math, sums in other orders); ``compare_maps`` exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.api import MMRPredictor as JPredictor
from mmrp_tpu.eval.diversity import embedding_diversity as j_embedding_diversity
from mmrp_tpu.eval.diversity import full_diversity_report as j_full_diversity_report
from mmrp_tpu.eval.diversity import label_diversity as j_label_diversity
from mmrp_tpu.eval.explain_eval import retrieval_explain_eval as j_retrieval_explain_eval
from mmrp_tpu.models import explain as jexplain
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.retrieval.gallery import RetrievalEngine as JRetrievalEngine
from mmrp_tpu.utils import viz as jviz
from mmrp_tpu_torch.api import MMRPredictor
from mmrp_tpu_torch.eval.diversity import (
    embedding_diversity,
    full_diversity_report,
    label_diversity,
)
from mmrp_tpu_torch.eval.explain_eval import retrieval_explain_eval
from mmrp_tpu_torch.models import explain
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.utils import viz
from mmrp_tpu_torch.utils.convert import load_flax_params
from test_torch_slice import randomize

MAPS = dict(rtol=1e-4, atol=1e-5)
SWIN = dict(img_size=28, embed_dim=16, depths=(1,), num_heads=(2,), window_size=7)
TEXT = dict(vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2, intermediate_dim=32,
            max_positions=16)
HEAD = dict(joint_dim=16, num_fusion_layers=1, num_heads=2, num_classes=8, max_text_len=8)
LABELS = [f"c{i}" for i in range(8)]


@pytest.fixture(scope="module")
def micro():
    """(JAX model, JAX params, port model, image, ids, mask): batch 2, the
    second report 5 tokens long."""
    rng = np.random.default_rng(2709)
    jcfg = jmm.MultiModalConfig(swin=JSwinConfig(**SWIN, use_pallas=False),
                                text=JTextConfig.small(**TEXT), **HEAD)
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    img = rng.random((2, 28, 28, 3), dtype=np.float32)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = (np.arange(8)[None, :] < np.array([8, 5])[:, None]).astype(np.int32)
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), img, ids, mask)["params"])
    tcfg = MultiModalConfig(swin=SwinConfig(**SWIN), text=TextConfig.small(**TEXT), **HEAD)
    tmodel = MultiModalRetrievalModel(tcfg, device="cpu").eval()
    load_flax_params(tmodel, params)
    return jmodel, {"model": params}, tmodel, img, ids, mask


@pytest.fixture(scope="module")
def jax_side(micro):
    """One JAX predictor and its engine for the module: their jitted
    programs compile once."""
    jmodel, params = micro[:2]
    jpred = JPredictor(jmodel, params, LABELS)
    jpred._explainer = jexplain.ExplanationEngine(jmodel, params)
    return jpred


def engines(micro, jax_side):
    return jax_side.explainer, explain.ExplanationEngine(micro[2])


def jax_apply(micro, *args, **kw):
    """The JAX model's deterministic forward, jitted with ``kw`` static."""
    jmodel, params = micro[:2]
    fn = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, deterministic=True, **kw))
    return fn(params["model"], *args)


def test_attention_hooks_match_jax(micro):
    """return_attention: one {txt2img (B, h, Lt, Np), img2txt (B, h, Np, Lt)}
    per fusion layer, the projected patches and tokens, and the outputs
    themselves, as JAX's (rtol 1e-4 / atol 1e-5)."""
    _, _, tmodel, img, ids, mask = micro
    want = jax_apply(micro, img, ids, mask, return_attention=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img), torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long(), return_attention=True)
    assert len(got["attention"]) == len(want["attention"]) == 1
    for g, w in zip(got["attention"], want["attention"]):
        assert g.keys() == w.keys() == {"txt2img", "img2txt"}
        for key in g:
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), err_msg=key, **MAPS)
    assert tuple(got["attention"][0]["txt2img"].shape) == (2, 2, 8, 49)
    for key in ("logits", "joint_emb", "img_patches_proj", "txt_tokens_proj"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **MAPS)


def test_features_path_matches_full_forward(micro):
    """The features path (no backbones) gives the full forward's outputs,
    and the raw features are JAX's (rtol 1e-4 / atol 1e-5)."""
    _, _, tmodel, img, ids, mask = micro
    args = (torch.from_numpy(img), torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    want = jax_apply(micro, img, ids, mask, return_features=True)
    with torch.no_grad():
        full = tmodel(*args, return_features=True)
        head = tmodel(None, *args[1:], features=full["features"])
    for key in ("logits", "joint_emb"):
        torch.testing.assert_close(head[key], full[key], rtol=0, atol=0)
    for key, value in full["features"].items():
        np.testing.assert_allclose(value.numpy(), np.asarray(want["features"][key]),
                                   err_msg=key, **MAPS)


@pytest.mark.parametrize("hook", ["patch_delta", "txt_delta"])
def test_delta_gradients_match_jax(micro, hook):
    """The gradient of a target logit through each zero-valued hook against
    jax.grad (rtol 1e-4 / atol 1e-5); the hook of the missing tower raises."""
    jmodel, params, tmodel, img, ids, mask = micro
    probe = jax_apply(micro, img, ids, mask, return_features=True)
    shape = probe["img_patches_proj" if hook == "patch_delta" else "txt_tokens_proj"].shape

    def logit(delta):
        out = jmodel.apply({"params": params["model"]}, None, ids, mask, deterministic=True,
                           features=probe["features"], **{hook: delta})
        return out["logits"][:, 3].sum()

    want = np.asarray(jax.jit(jax.grad(logit))(jnp.zeros(shape)))
    feats = {k: torch.from_numpy(np.array(v)) for k, v in probe["features"].items()}
    delta = torch.zeros(shape, requires_grad=True)
    out = tmodel(None, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                 features=feats, **{hook: delta})
    (got,) = torch.autograd.grad(out["logits"][:, 3].sum(), delta)
    np.testing.assert_allclose(got.numpy(), want, **MAPS)
    assert np.abs(want).max() > 1e-3
    mode = "text" if hook == "patch_delta" else "image"
    cfg = MultiModalConfig(swin=SwinConfig(**SWIN), text=TextConfig.small(**TEXT), mode=mode,
                           **HEAD)
    with pytest.raises(ValueError, match=f"{hook} requires"):
        MultiModalRetrievalModel(cfg, device="cpu")(
            None, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
            features=feats, **{hook: delta})


METHODS = {
    "attention_maps": lambda e, img, ids, mask: e.attention_maps(img, ids, mask),
    "integrated_gradients": lambda e, img, ids, mask: e.integrated_gradients(
        img, ids, mask, 3, n_steps=4, chunk=2),
    "integrated_gradients_pixels": lambda e, img, ids, mask: e.integrated_gradients_pixels(
        img, ids, mask, 3, n_steps=2),
    "grad_cam": lambda e, img, ids, mask: e.grad_cam(img, ids, mask, 3),
    "token_attribution": lambda e, img, ids, mask: e.token_attribution(
        img, ids, mask, 3, n_steps=3),
    "explain_batch": lambda e, img, ids, mask: e.explain_batch(img, ids, mask, n_steps=4,
                                                               chunk=2),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_engine_method_matches_jax(micro, jax_side, method):
    """Each ExplanationEngine method against JAX's on the same inputs with
    small n_steps (rtol 1e-4 / atol 1e-5); every map non-constant."""
    img, ids, mask = micro[3:]
    jeng, teng = engines(micro, jax_side)
    want = METHODS[method](jeng, img, ids, mask)
    got = METHODS[method](teng, img, ids, mask)
    if not isinstance(want, dict):
        want, got = {"map": want}, {"map": got}
    assert got.keys() == want.keys()
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        if key == "targets":
            np.testing.assert_array_equal(got[key], w)
        else:
            np.testing.assert_allclose(got[key], w, err_msg=key, **MAPS)
        if w.ndim == 3:
            assert (np.ptp(w.reshape(len(w), -1), axis=1) > 0.5).all(), key


def test_explain_scalar_and_vector_targets(micro, jax_side):
    """A scalar target keys its class id; (B,) vectors key "rank{j}", each
    sample attributed for its own class (rtol 1e-4 / atol 1e-5)."""
    img, ids, mask = micro[3:]
    jeng, teng = engines(micro, jax_side)
    targets = [2, np.array([5, 1]), np.array([0, 7])]
    want = jeng.explain(img, ids, mask, targets, ig_steps=4)
    got = teng.explain(img, ids, mask, targets, ig_steps=4)
    assert list(got["per_target"]) == list(want["per_target"]) == [2, "rank1", "rank2"]
    for t, maps in want["per_target"].items():
        for key, w in maps.items():
            np.testing.assert_allclose(got["per_target"][t][key], w, err_msg=f"{t} {key}",
                                       **MAPS)
    for key, w in want["attention"].items():
        np.testing.assert_allclose(got["attention"][key], w, err_msg=key, **MAPS)


@pytest.mark.parametrize("batch", [1, 2])
def test_predict_explain_matches_jax(micro, jax_side, batch):
    """predict(explain=True) with its auto targets: the top-5 classes of a
    single request, or per-rank vectors over a batch (rtol 1e-4 / atol
    1e-5); the explain() shortcut is the engine's."""
    _, _, tmodel, img, ids, mask = micro
    args = (img[:batch], ids[:batch], mask[:batch])
    jpred, pred = jax_side, MMRPredictor(tmodel, LABELS)
    want = jpred.predict(*args, explain=True)
    got = pred.predict(*args, explain=True)
    assert [[n for n, _ in r] for r in got["top_labels"]] == \
        [[n for n, _ in r] for r in want["top_labels"]]
    gp, wp = got["explanation"]["per_target"], want["explanation"]["per_target"]
    assert list(gp) == list(wp) and len(gp) == 5
    for t in wp:
        for key in wp[t]:
            np.testing.assert_allclose(gp[t][key], wp[t][key], err_msg=f"{t} {key}", **MAPS)
    assert pred.explainer is pred.explainer
    np.testing.assert_allclose(pred.explain(*args, [4], ig_steps=4)["per_target"][4]["ig"],
                               jpred.explain(*args, [4], ig_steps=4)["per_target"][4]["ig"],
                               **MAPS)


def test_compare_maps_is_jax(micro):
    """compare_maps and _rankdata: the same numbers, exactly, with ties and
    a constant map."""
    rng = np.random.default_rng(3)
    a = rng.random((28, 28)).astype(np.float32)
    b = np.round(a + rng.normal(0, 0.2, a.shape), 1).astype(np.float32)
    for x, y in ((a, b), (b, b), (a, np.zeros_like(a))):
        got, want = explain.compare_maps(x, y), jexplain.compare_maps(x, y)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == want[key] or (np.isnan(got[key]) and np.isnan(want[key])), key
    np.testing.assert_array_equal(explain._rankdata(b.ravel()), jexplain._rankdata(b.ravel()))


@pytest.mark.parametrize("grid,out_hw", [(7, (28, 28)), (7, (224, 224)), (4, (30, 18))])
def test_patch_map_upsampling_is_jax_resize(grid, out_hw):
    """patch_vector_to_map's upsampling is jax.image.resize's bilinear
    (half-pixel centres, no antialias on upsampling): F.interpolate with
    align_corners=False, within 1e-6; align_corners=True is not."""
    v = np.random.default_rng(grid).random((2, grid * grid)).astype(np.float32)
    want = np.asarray(jexplain.patch_vector_to_map(jnp.asarray(v), grid, out_hw))
    got = explain.patch_vector_to_map(torch.from_numpy(v), grid, out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    corners = torch.nn.functional.interpolate(
        torch.from_numpy(v).reshape(2, 1, grid, grid), size=out_hw, mode="bilinear",
        align_corners=True)
    assert np.abs(explain._normalize01(corners[:, 0]).numpy() - want).max() > 1e-2


def test_kernel_recompute_forward_is_the_kernel_backward_the_plain_version():
    """KernelRecompute with a planted "kernel" (the plain version plus an
    offset): the forward shows the offset, the gradients of x and w are
    plain autograd's, a frozen input and a mask get none, and no plain call
    is counted."""
    torch.manual_seed(0)
    x = torch.randn(3, 5, requires_grad=True)
    w = torch.randn(5, 4, requires_grad=True)
    frozen = torch.randn(4)
    mask = torch.tensor([0.0, -1e9, 0.0, 0.0])

    def plain(x, w, frozen, mask, none):
        assert none is None
        return torch.softmax(torch.tanh(x @ w) * frozen + mask, -1)

    def kernel(*t):
        assert not any(a.requires_grad for a in t if a is not None)
        return plain(*t) + 0.25

    cot = torch.randn(3, 4)
    out = _build.grad_route(kernel, plain, (x, w, frozen, mask, None))
    torch.testing.assert_close(out, plain(x, w, frozen, mask, None).detach() + 0.25)
    gx, gw = torch.autograd.grad(out, (x, w), cot)
    wx, ww = torch.autograd.grad(plain(x, w, frozen, mask, None), (x, w), cot)
    assert torch.equal(gx, wx) and torch.equal(gw, ww)
    with torch.no_grad():  # no autograd: the kernel alone, on the inputs as given
        with pytest.raises(AssertionError):
            _build.grad_route(kernel, plain, (x, w, frozen, mask, None))
        out = _build.grad_route(kernel, plain, (x.detach(), w.detach(), frozen, mask, None))
    torch.testing.assert_close(out, plain(x, w, frozen, mask, None).detach() + 0.25)


def test_engine_refuses_int8_mixes(micro):
    """The name is kept from when the engine refused every int8 mix. Now an
    engine over each int8 serving mix is built and explains (Grad-CAM here;
    ``tests/test_torch_explain_int8.py`` holds every method to JAX's), and
    only pixel IG over the static W8A8 Swin raises, as ``jax.grad`` through
    JAX's static blocks does."""
    _, params, _, img, ids, mask = micro
    for swin_quant in ("none", "int8_static"):
        tcfg = MultiModalConfig(swin=SwinConfig(**SWIN, whole_min_c=16, quant=swin_quant),
                                text=TextConfig.small(**TEXT, quant="int8_kernel"),
                                quant="int8", **HEAD)
        model = MultiModalRetrievalModel(tcfg, device="cpu").eval()
        load_flax_params(model, params["model"])
        eng = explain.ExplanationEngine(model)
        cam = eng.grad_cam(img, ids, mask, 3)
        assert cam.shape == (2, 28, 28) and np.isfinite(cam).all()
    with pytest.raises(RuntimeError, match="static W8A8 block has no gradient"):
        eng.integrated_gradients_pixels(img, ids, mask, 3, n_steps=2)


@pytest.fixture(scope="module")
def world(micro, jax_side):
    """Both predictors over one 8-item gallery of JAX embeddings (the JAX
    predictor shares the module's engine), and the samples by id."""
    jmodel, params, tmodel = micro[:3]
    rng = np.random.default_rng(11)
    samples, embs = {}, []
    for i in range(8):
        s = {"image": rng.random((1, 28, 28, 3), dtype=np.float32),
             "input_ids": rng.integers(0, 64, (1, 8)).astype(np.int32),
             "attention_mask": np.ones((1, 8), np.int32)}
        samples[f"s{i}"] = s
        embs.append(jax_side.embed(s["image"], s["input_ids"], s["attention_mask"])
                    ["joint_emb"][0])
    ids = list(samples)
    jpred = JPredictor(jmodel, params, LABELS, retriever=JRetrievalEngine(np.stack(embs), ids))
    jpred._explainer = jax_side.explainer
    pred = MMRPredictor(tmodel, LABELS,
                        retriever=RetrievalEngine(np.stack(embs), ids, device="cpu"))
    return jpred, pred, samples, ids


def test_retrieval_explain_eval_matches_jax(world, tmp_path):
    """retrieval_explain_eval of both packages on 3 queries at k=3: the same
    P@3, mAP and MRR, the attention-map alignments within 1e-4, the same
    JSON keys."""
    jpred, pred, samples, ids = world
    gt = {i: [j for j in ids if j != i][:3] for i in ids[:3]}
    got = retrieval_explain_eval(pred, samples.__getitem__, ids[:3], gt, k=3,
                                 out_path=str(tmp_path / "port.json"))
    want = j_retrieval_explain_eval(jpred, samples.__getitem__, ids[:3], gt, k=3)
    assert got.keys() == want.keys() == json.loads((tmp_path / "port.json").read_text()).keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-4, err_msg=key)


def test_diversity_and_viz_match_jax(world, tmp_path):
    """full_diversity_report of both packages on 2 queries (the same
    results, cross-map metrics within 1e-4, the same overlay files), the
    diversity scores and viz's overlays (the same PNG bytes for the same
    maps, a heatmap of another size resized)."""
    jpred, pred, samples, ids = world
    got = full_diversity_report(pred, samples.__getitem__, ids[:2], str(tmp_path / "p"), k=3)
    want = j_full_diversity_report(jpred, samples.__getitem__, ids[:2], str(tmp_path / "j"),
                                   k=3)
    assert got["n_queries"] == want["n_queries"] == 2
    g = json.loads((tmp_path / "p" / "diversity_report.json").read_text())
    w = json.loads((tmp_path / "j" / "diversity_report.json").read_text())
    for gq, wq in zip(g, w):
        assert [r["id"] for r in gq["results"]] == [r["id"] for r in wq["results"]]
        for gr, wr in zip(gq["results"], wq["results"]):
            for key in ("score", "pearson", "spearman"):
                np.testing.assert_allclose(gr[key], wr[key], rtol=0, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(gq["emb_diversity"], wq["emb_diversity"], atol=1e-5)
    assert sorted(p.name for p in (tmp_path / "p" / "overlays").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j" / "overlays").iterdir())
    rng = np.random.default_rng(12)
    embs, labels = rng.standard_normal((5, 16)), rng.random((5, 8)) < 0.3
    assert embedding_diversity(embs) == j_embedding_diversity(embs)
    assert label_diversity(labels) == j_label_diversity(labels)
    gray, heat, small = rng.random((28, 28)), rng.random((28, 28)), rng.random((7, 7))
    for h in (heat, small):
        np.testing.assert_allclose(viz.overlay_rgb(gray, h), jviz.overlay_rgb(gray, h),
                                   rtol=0, atol=1e-6)
    viz.save_query_overlays(str(tmp_path / "vp"), "q", gray, {"a": heat}, result_id="r")
    jviz.save_query_overlays(str(tmp_path / "vj"), "q", gray, {"a": heat}, result_id="r")
    assert (tmp_path / "vp" / "q_r_a.png").read_bytes() == \
        (tmp_path / "vj" / "q_r_a.png").read_bytes()
