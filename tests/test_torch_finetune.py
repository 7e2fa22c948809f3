"""The Swin finetune: port against JAX on the CPU.

``models/finetune_head.py`` (``SwinForFinetune`` on ``SwinConfig.micro`` and
on a two-stage micro Swin whose stage 1 takes the attention core), every
``classification_loss`` kind, the freeze masks, the two-rate AdamW, one
finetune step at dropout 0, the whole ``finetune`` loop, and the host functions (``lr_range_test``,
``calibrate_temperature``, ``build_finetune_subset``, ``pos_weight_ramp``).
Weights go from JAX to the port through ``utils/convert.py`` (the Flax MHA's
DenseGeneral kernels included).

Tolerances: the model 2e-4 (f32 through every layer, Flax's one-pass
LayerNorm variance against two passes); losses 1e-6 relative; the optimizer
1e-6; after one finetune step each parameter within 2 lr of JAX's (Adam's
first step moves an element by ~lr * sign(g), and a gradient that is zero
up to rounding may take either sign), all but 1 in 1,000 within 1% of lr;
the temperature 1e-5 relative; subsets and ramps exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmrp_tpu.models import finetune_head as jhead
from mmrp_tpu.models import swin as jswin
from mmrp_tpu.train import swin_finetune as jft
from mmrp_tpu_torch.labels import LABEL_COLS
from mmrp_tpu_torch.models.finetune_head import SwinForFinetune
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.train import swin_finetune as tft
from mmrp_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=2e-4, atol=2e-4)
TWO_STAGE = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2))
NC = 7


def t(a):
    return torch.from_numpy(np.array(a))


def randomize(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) + rng.standard_normal(np.shape(v)).astype(np.float32)
                              * 0.02), params)


def both_models(swin_kw, seed=0):
    """(JAX model, its randomized params, port model with the same weights),
    drop path 0."""
    jmodel = jhead.SwinForFinetune(swin=jswin.SwinConfig(**swin_kw, drop_path_rate=0.0,
                                                         use_pallas=False),
                                   num_classes=NC, num_heads=2)
    size = swin_kw["img_size"]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    params = randomize(params["params"], seed)
    model = SwinForFinetune(SwinConfig(**swin_kw, drop_path_rate=0.0), num_classes=NC,
                            num_heads=2, device="cpu")
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("swin_kw", [dict(img_size=28, embed_dim=16, depths=(1,),
                                          num_heads=(2,)), TWO_STAGE], ids=["micro", "two_stage"])
def test_swin_for_finetune_matches_jax(rng, swin_kw, monkeypatch):
    """Deterministic outputs, and the training route's logits and every
    parameter gradient at drop path 0 (two_stage: its stage 1 through the
    attention core, JAX's with MMRP_SWIN_CORE=1)."""
    monkeypatch.setenv("MMRP_SWIN_CORE", "1")
    jmodel, params, model = both_models(swin_kw)
    size = swin_kw["img_size"]
    x = rng.random((2, size, size, 3), dtype=np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(t(x))
    for k in ("logits", "patches", "global"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    w = rng.standard_normal((2, NC)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["logits"] * w)

    jgrads = flax_to_state_dict(jax.jit(jax.grad(jloss))(params))
    out = model(t(x), deterministic=False, generator=torch.Generator().manual_seed(0))
    (out["logits"] * t(w)).sum().backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(), err_msg=name,
                                   rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("kind", ["hybrid", "focal", "bce", "asl"])
def test_classification_loss_matches_jax(rng, kind):
    logits = (rng.standard_normal((6, NC)) * 2).astype(np.float32)
    labels = (rng.random((6, NC)) < 0.3).astype(np.float32)
    pw = (rng.random(NC) * 3 + 0.5).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 0, 1], np.float32)
    want = jft.classification_loss(jft.SwinFinetuneConfig(loss=kind), jnp.asarray(logits),
                                   jnp.asarray(labels), jnp.asarray(pw), jnp.asarray(valid))
    got = tft.classification_loss(tft.SwinFinetuneConfig(loss=kind), t(logits), t(labels),
                                  t(pw), t(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tft.smooth_labels(t(labels), 0.05).numpy(),
                               np.asarray(jft.smooth_labels(jnp.asarray(labels), 0.05)))


def mask_by_name(jmask, params):
    """A JAX mask tree as {port parameter name: 0.0 / 1.0}, through the
    bridge's key map (each mask value spread over its parameter's shape)."""
    spread = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                    jmask, params)
    return {k: float(v.flatten()[0]) for k, v in flax_to_state_dict(spread).items()}


@pytest.mark.parametrize("epoch", [0, 1, 5, 10])
def test_freeze_masks_match_jax(epoch):
    _, params, model = both_models(TWO_STAGE)
    names = dict(model.named_parameters())
    want = mask_by_name(jft.freeze_mask_for_epoch(jft.SwinFinetuneConfig(), params, epoch),
                        params)
    got = tft.freeze_mask_for_epoch(tft.SwinFinetuneConfig(), names, epoch)
    assert got == want
    assert all(v == 1.0 for k, v in got.items() if not k.startswith("swin."))


def test_two_rate_adamw_matches_optax(rng):
    """Head at lr, backbone at lr * backbone_lr_scale, optax.adamw's weight
    decay 1e-4 and eps 1e-8; a frozen parameter (mask 0) keeps its value and
    zero moments: neither decayed nor moved."""
    shapes = {"swin": {"a": (4, 3), "b": (5,)}, "label_head": {"c": (3, 2)}}
    params = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    cfg = dict(lr=1e-2, backbone_lr_scale=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jtx = jft.make_finetune_optimizer(jft.SwinFinetuneConfig(**cfg), jp)
    jstate = jtx.init(jp)
    flat = {f"{m}.{k}": t(v.copy()) for m, d in params.items() for k, v in d.items()}
    ttx = tft.make_finetune_optimizer(tft.SwinFinetuneConfig(**cfg), flat)
    tstate = ttx.init(flat)
    frozen = {"swin": {"a": 0.0, "b": 1.0}, "label_head": {"c": 1.0}}
    tmask = {f"{m}.{k}": v for m, d in frozen.items() for k, v in d.items()}
    for _ in range(3):
        g = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()}
             for m, d in shapes.items()}
        jg = jax.tree_util.tree_map(lambda a, m: jnp.asarray(a) * m, g, frozen)
        upd, jstate = jtx.update(jg, jstate, jp)
        upd = jax.tree_util.tree_map(lambda u, m: u * m, upd, frozen)
        jp = optax.apply_updates(jp, upd)
        ttx.step(flat, {f"{m}.{k}": t(v) for m, d in g.items() for k, v in d.items()}, tstate,
                 tmask)
    for m, d in shapes.items():
        for k in d:
            np.testing.assert_allclose(flat[f"{m}.{k}"].numpy(), np.asarray(jp[m][k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{m}.{k}")
    np.testing.assert_array_equal(flat["swin.a"].numpy(), params["swin"]["a"])
    assert float(tstate["backbone"].mu["swin.a"].abs().max()) == 0.0


def test_finetune_step_matches_jax(rng, monkeypatch):
    """One make_finetune_step at dropout and drop path 0 on the two-stage
    model, epoch-0 freeze masks and a ramped pos_weight: the loss and every
    parameter after the update."""
    monkeypatch.setenv("MMRP_SWIN_CORE", "1")
    jmodel, params, model = both_models(TWO_STAGE, seed=1)
    cfg = dict(lr=1e-3, backbone_lr_scale=0.5, unfreeze_epochs=(0, 1))
    jcfg, tcfg = jft.SwinFinetuneConfig(**cfg), tft.SwinFinetuneConfig(**cfg)
    batch = {"image": rng.random((3, 56, 56, 3), dtype=np.float32),
             "labels": (rng.random((3, NC)) < 0.3).astype(np.float32),
             "valid": np.array([1, 1, 0], np.float32)}
    pw = jft.pos_weight_ramp((rng.random(NC) * 4 + 1).astype(np.float32), 0, 5, 5.0)
    jtx = jft.make_finetune_optimizer(jcfg, params)
    jfreeze = jft.freeze_mask_for_epoch(jcfg, params, 0)
    jp, _, jloss = jft.make_finetune_step(jmodel, jcfg, jtx)(
        params, jtx.init(params), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(pw), jfreeze, jax.random.PRNGKey(0))

    from mmrp_tpu_torch.train.state import master_params

    masters = master_params(model)
    ttx = tft.make_finetune_optimizer(tcfg, masters)
    freeze = tft.freeze_mask_for_epoch(tcfg, masters, 0)
    assert freeze == mask_by_name(jfreeze, params) and 0.0 in freeze.values()
    step = tft.make_finetune_step(model, tcfg, ttx)
    masters, _, loss = step(masters, ttx.init(masters), batch, pw, freeze, torch.Generator())
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-4)
    want = flax_to_state_dict(jp)
    before = flax_to_state_dict(params)
    n_far, total = 0, 0
    for name, m in masters.items():
        d = np.abs(m.numpy() - want[name].numpy())
        lr = cfg["lr"] * (cfg["backbone_lr_scale"] if name.startswith("swin.") else 1.0)
        assert d.max() <= 2 * lr, name
        # a key projection's bias adds q.b to every score of a row, which the
        # softmax takes out again: its gradient is zero up to rounding, which
        # Adam's first step turns into +-lr either way (only 2 lr holds there)
        if name.endswith("key.bias"):
            d = d * 0
        elif name.endswith("qkv.bias"):
            d = np.concatenate([d[: len(d) // 3], d[2 * len(d) // 3:]])
        n_far += int((d > 1e-2 * lr).sum())
        total += d.size
        if freeze[name] == 0.0:
            np.testing.assert_array_equal(m.numpy(), before[name].numpy())
    assert n_far <= total // 1000
    for name, p in model.named_parameters():  # the f32 model shares its masters
        assert torch.equal(p.detach(), masters[name])


def test_finetune_loop_trains_and_keeps_the_best(rng):
    """The loop on a micro model: finite results, thresholds per class, a
    positive temperature, the best epoch's masters in the model."""
    model = SwinForFinetune(SwinConfig.micro(drop_path_rate=0.0), num_classes=NC,
                            num_heads=2, device="cpu")
    batches = [{"image": rng.random((4, 28, 28, 3), dtype=np.float32),
                "labels": (rng.random((4, NC)) < 0.4).astype(np.float32),
                "valid": np.ones(4, np.float32)} for _ in range(3)]
    res = tft.finetune(model, tft.SwinFinetuneConfig(epochs=3, lr=1e-3, seed=3),
                       lambda: iter(batches[:2]), lambda: iter(batches[2:]),
                       np.full(NC, 2.0, np.float32))
    assert res["thresholds"].shape == (NC,) and res["temperature"] > 0
    assert 0 <= res["best_epoch"] < 3 and np.isfinite(res["report"]["macro_auroc"])
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), res["params"][name])


def test_finetune_loop_matches_jax(rng, monkeypatch):
    """Both packages' ``finetune`` loop for 3 epochs on the micro model from
    JAX's init (the port's seeded init swapped for it), drop path 0, the
    backbone unfrozen after epoch 0: each epoch's logged loss and validation
    metrics, the best epoch, its thresholds, report and temperature, and the
    returned best weights. In both packages the last epoch's composite is
    lowered by 1 (the same seam in each), so an earlier epoch is the best and
    both return its weights. Tolerances: losses 1e-4 relative; metrics,
    thresholds and the report 2e-4; the temperature 1e-4 relative; weights
    1e-5, but a key projection's bias 2 lr per step taken (its gradient is
    zero up to rounding, as for one step above)."""
    import mmrp_tpu_torch.utils.convert as convert

    swin_kw = dict(img_size=28, embed_dim=16, depths=(1,), num_heads=(2,))
    jmodel = jhead.SwinForFinetune(swin=jswin.SwinConfig(**swin_kw, drop_path_rate=0.0,
                                                         use_pallas=False),
                                   num_classes=NC, num_heads=2)
    model = SwinForFinetune(SwinConfig(**swin_kw, drop_path_rate=0.0), num_classes=NC,
                            num_heads=2, device="cpu")
    sample = np.zeros((1, 28, 28, 3), np.float32)
    cfg = dict(epochs=3, lr=1e-3, seed=3, unfreeze_epochs=(1,))
    jinit = jmodel.init(jax.random.PRNGKey(cfg["seed"]), jnp.asarray(sample))["params"]
    monkeypatch.setattr(convert, "init_params", lambda m, seed: m.load_state_dict(
        flax_to_state_dict(jinit), strict=True))
    for mod in (jft, tft):
        def lowered(rep, _real=mod.composite_score, _seen=[]):
            _seen.append(1)
            return _real(rep) - (1.0 if len(_seen) == 3 else 0.0)
        monkeypatch.setattr(mod, "composite_score", lowered)

    def batch(n):
        return {"image": rng.random((n, 28, 28, 3), dtype=np.float32),
                "labels": (rng.random((n, NC)) < 0.4).astype(np.float32),
                "valid": np.ones(n, np.float32)}

    train, val = [batch(4) for _ in range(3)], [batch(8) for _ in range(2)]
    pw = (rng.random(NC) * 3 + 0.5).astype(np.float32)

    class Log:
        def __init__(self):
            self.rows = []

        def log(self, metrics, step):
            self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    jlog, tlog = Log(), Log()
    jres = jft.finetune(jmodel, jft.SwinFinetuneConfig(**cfg), lambda: iter(train),
                        lambda: iter(val), pw, sample, metric_writer=jlog)
    res = tft.finetune(model, tft.SwinFinetuneConfig(**cfg), lambda: iter(train),
                       lambda: iter(val), pw, metric_writer=tlog)
    assert [s for s, _ in tlog.rows] == [s for s, _ in jlog.rows] == [0, 1, 2]
    for (_, got), (_, want) in zip(tlog.rows, jlog.rows):
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["swin/loss"], want["swin/loss"], rtol=1e-4)
        for k in ("swin/macro_f1", "swin/macro_auroc", "swin/composite"):
            np.testing.assert_allclose(got[k], want[k], atol=2e-4, err_msg=k)
    assert res["best_epoch"] == jres["best_epoch"] < 2
    np.testing.assert_allclose(res["thresholds"], jres["thresholds"], atol=2e-4)
    np.testing.assert_allclose(res["temperature"], jres["temperature"], rtol=1e-4)
    for k in ("macro_f1", "macro_auroc", "micro_f1"):
        np.testing.assert_allclose(res["report"][k], jres["report"][k], atol=2e-4, err_msg=k)
    steps = 3 * (res["best_epoch"] + 1)
    want = flax_to_state_dict(jres["params"])
    assert set(res["params"]) == set(want)
    for name, m in res["params"].items():
        lr = cfg["lr"] * (tft.SwinFinetuneConfig().backbone_lr_scale
                          if name.startswith("swin.") else 1.0)
        bound = 2 * lr * steps if name.endswith("key.bias") else 1e-5
        assert np.abs(m.numpy() - want[name].numpy()).max() <= bound, name
    for name, p in model.named_parameters():  # the model holds the best masters
        assert torch.equal(p.detach(), res["params"][name])


def test_lr_range_test_matches_jax():
    def bowl(lr):
        return (np.log10(lr) + 3.0) ** 2 + 1.0

    def blows(lr):
        return float("nan") if lr > 1e-2 else 1.0 / (1.0 + lr * 100)

    for fn in (bowl, blows, lambda lr: float("nan"), lambda lr: 5.0 if lr < 1e-5 else 50.0):
        assert tft.lr_range_test(fn) == jft.lr_range_test(fn)


def test_calibrate_temperature_matches_jax(rng):
    logits = (rng.standard_normal((40, NC)) * 3).astype(np.float32)
    labels = (rng.random((40, NC)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(tft.calibrate_temperature(logits, labels),
                               jft.calibrate_temperature(logits, labels), rtol=1e-5)


def test_build_finetune_subset_and_ramp_match_jax(rng):
    records = [{"id": f"r{i}", "labels": (rng.random(len(LABEL_COLS)) < 0.1).astype(int).tolist()}
               for i in range(300)]
    for kw in (dict(), dict(max_per_label=5, min_per_label=3, seed=4)):
        got = [r["id"] for r in tft.build_finetune_subset(records, **kw)]
        assert got == [r["id"] for r in jft.build_finetune_subset(records, **kw)]
    base = (rng.random(NC) * 8).astype(np.float32)
    for epoch in (0, 2, 9):
        np.testing.assert_array_equal(tft.pos_weight_ramp(base, epoch, 5, 5.0),
                                      jft.pos_weight_ramp(base, epoch, 5, 5.0))


def test_port_weights_load_into_jax(rng):
    """The bridge's other direction: a port SwinForFinetune's weights as the
    Flax tree (``state_dict_to_flax_flat``: the MHA projections back to
    DenseGeneral kernels) drive JAX's model to the port's logits; the runner
    saves the backbone this way (``swin/swin_backbone.npz``)."""
    from mmrp_tpu.utils.checkpoint import load_param_tree
    from mmrp_tpu_torch.utils.checkpoint import save_param_tree
    from mmrp_tpu_torch.utils.convert import init_params, state_dict_to_flax_flat

    jmodel, _, model = both_models(dict(img_size=28, embed_dim=16, depths=(1,), num_heads=(2,)))
    init_params(model, seed=5)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        save_param_tree(f"{tmp}/p.npz", state_dict_to_flax_flat(model))
        tree = load_param_tree(f"{tmp}/p.npz")
    x = rng.random((2, 28, 28, 3), dtype=np.float32)
    want = jmodel.apply({"params": tree}, jnp.asarray(x))["logits"]
    with torch.no_grad():
        got = model(t(x))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_auto_select_asl_picks_a_candidate(rng):
    """The ASL search trains each (gamma_neg, clip) candidate for its quick
    epochs and returns the best composite's settings."""
    model = SwinForFinetune(SwinConfig.micro(drop_path_rate=0.0), num_classes=NC,
                            num_heads=2, device="cpu")
    batches = [{"image": rng.random((4, 28, 28, 3), dtype=np.float32),
                "labels": (rng.random((4, NC)) < 0.4).astype(np.float32),
                "valid": np.ones(4, np.float32)} for _ in range(2)]
    cands = ((2.0, 0.0), (6.0, 0.1))
    g, c, best = tft.auto_select_asl(
        model, tft.SwinFinetuneConfig(lr=1e-3), lambda: iter(batches[:1]),
        lambda: iter(batches[1:]), np.full(NC, 2.0, np.float32), None, candidates=cands,
        quick_epochs=1)
    assert (g, c) in cands and 0.0 <= best["composite"] <= 1.0
