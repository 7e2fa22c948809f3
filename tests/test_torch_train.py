"""The training slice: port against JAX on the CPU.

Inputs come from numpy seeds and go through the JAX function and its port
counterpart in f32. The JAX side runs its Pallas kernels in interpret mode
(``window_attention_core``, ``window_attention_pallas``); the port runs the
plain versions its wrappers take for CPU tensors.

Model widths are micro: Swin at 56 px with embed 16, depths (2, 2), heads
(2, 2), so stage 1 (14 x 14, four windows) takes the attention core and stage
2 (7 x 7, one window) ``window_attention_xla_direct``; text and head sizes as in
``test_torch_slice.py``.

Tolerances:
- the core and the attention functions: those of ``tests/test_wattn_core.py``
  (2e-5 forward, 3e-5 gradients at d = 8, 5e-5 at d = 32), sums in other orders;
- losses 1e-6 relative: the same f32 formulas;
- the optimizer 1e-6 relative: the same operations in the same order, on
  identical gradients;
- the Swin encoder and the whole step 2e-4 relative (5e-4 on gradients): f32
  through every layer, Flax's one-pass LayerNorm variance against two passes;
- parameters after 3 steps: Adam divides each gradient by its own root mean
  square, so an element whose gradient is ~0 moves by up to lr per step in a
  direction set by rounding noise. Every element is held to 2 lr per step;
  all but 1 in 1,000 to 1% of lr;
- a bf16 model's masters against an f32 model's after 2 steps: the same bound
  of 2 lr, all but 1 in 50 to 1% of lr (the test's docstring says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models import swin as jswin
from mmrp_tpu.models.layers import Mlp as JMlp
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.ops import window_attention as jwa
from mmrp_tpu.ops.fused_window_attention import build_bias_full as jbuild_bias_full
from mmrp_tpu.ops.wattn_core import window_attention_core as jcore
from mmrp_tpu.train import joint as jjoint
from mmrp_tpu.train import losses as JL
from mmrp_tpu.train.state import TrainState as JTrainState
from mmrp_tpu.train.state import make_optimizer as jmake_optimizer
from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.layers import DropPath, Mlp, dropout
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.ops import window_attention as twa
from mmrp_tpu_torch.ops.fused_window_attention import build_bias_full
from mmrp_tpu_torch.ops.wattn_core import window_attention_core
from mmrp_tpu_torch.train import losses as TL
from mmrp_tpu_torch.train.joint import compute_losses, init_train_state, make_train_step
from mmrp_tpu_torch.train.state import make_optimizer
from mmrp_tpu_torch.utils.convert import flax_to_state_dict, load_flax_params

SWIN = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2))
TEXT = dict(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64)
HEAD = dict(joint_dim=64, num_fusion_layers=2, num_heads=4, num_classes=7, max_text_len=16)
KG_DIM = 12
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def core_inputs(rng, B, heads, d, shift, ws=7, H=14):
    C = heads * d
    qkv = rng.standard_normal((B, H, H, 3 * C)).astype(np.float32)
    table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((B, H, H, C)).astype(np.float32)
    bias = np.asarray(jbuild_bias_full(jnp.asarray(table), ws, H, H, shift))
    return qkv, bias, cot, dict(ws=ws, shift=shift, num_heads=heads, scale=d ** -0.5)


# (shift, B, heads, d, atol of the gradients): the JAX core tests' geometries,
# the last two at Swin-T stage-1 head counts (3 x 32, 3C = 288 lanes unaligned)
@pytest.mark.parametrize("shift,B,heads,d,gtol", [
    (0, 1, 2, 8, 3e-5), (3, 1, 2, 8, 3e-5), (0, 2, 2, 8, 3e-5), (3, 2, 2, 8, 3e-5),
    (0, 2, 3, 32, 5e-5), (3, 2, 3, 32, 5e-5)])
def test_core_plain_matches_jax_forward_and_gradients(rng, shift, B, heads, d, gtol):
    qkv, bias, cot, kw = core_inputs(rng, B, heads, d, shift)

    def jloss(q, b):
        return jnp.sum(jcore(q, b, interpret=True, **kw) * cot)

    want = np.asarray(jcore(jnp.asarray(qkv), jnp.asarray(bias), interpret=True, **kw))
    jdq, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))

    tq, tb = t(qkv).requires_grad_(True), t(bias).requires_grad_(True)
    got = window_attention_core(tq, tb, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=0)
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jdq), atol=gtol, rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), atol=gtol, rtol=0)


@pytest.mark.parametrize("shift", [0, 3])
def test_head_major_attention_matches_window_attention_pallas(rng, shift):
    """build_combined_bias and window_attention_heads (its CPU form,
    window_attention_xla) against the JAX bias and the Pallas kernel."""
    ws, H, heads, d, B = 7, 14, 2, 8, 2
    table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.1).astype(np.float32)
    want_bias = np.asarray(jwa.build_combined_bias(jnp.asarray(table), ws, H, H, shift, 64))
    bias2 = twa.build_combined_bias(t(table), ws, H, H, shift, 64)
    np.testing.assert_array_equal(bias2.numpy(), want_bias)
    G = heads * (H // ws) ** 2
    q, k, v = (rng.standard_normal((B, G, 64, d)).astype(np.float32) for _ in range(3))
    want = jwa.window_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, want_bias)),
                                       d ** -0.5, interpret=True)
    got = twa.window_attention_heads(t(q), t(k), t(v), bias2, d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("shift", [0, 3])
def test_window_attention_xla_direct_matches_jax(rng, shift):
    ws, H, heads, d, B = 7, 14, 2, 8, 2
    nW, N = (H // ws) ** 2, ws * ws
    qkv_win = rng.standard_normal((B, nW, N, 3, heads, d)).astype(np.float32)
    table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.1).astype(np.float32)
    smask = jwa.shift_attn_mask(H, H, ws, shift) if shift else None
    want = jwa.window_attention_xla_direct(
        jnp.asarray(qkv_win), jwa.build_rel_bias(jnp.asarray(table), ws),
        None if smask is None else jnp.asarray(smask), d ** -0.5)
    got = twa.window_attention_xla_direct(
        t(qkv_win), twa.build_rel_bias(t(table), ws), None if smask is None else t(smask),
        d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# name -> the call, on a losses module L and the inputs
# x = (logits, labels, a, b, kg_proj, kg_target, kg_target_valid, valid, pos_weight)
LOSSES = {
    "bce": lambda L, x: L.bce_with_logits(x[0], x[1], x[8], x[7]),
    "focal": lambda L, x: L.focal_loss(x[0], x[1], 2.0, x[7]),
    "hybrid": lambda L, x: L.hybrid_bce_focal(x[0], x[1], 0.3, 1.0, x[8], x[7]),
    "asymmetric": lambda L, x: L.asymmetric_loss(x[0], x[1], 0.0, 4.0, 0.05, x[7]),
    "info_nce": lambda L, x: L.info_nce(x[2], x[3], 0.125, x[7]),
    "kg_cosine": lambda L, x: L.kg_alignment_loss(x[2], x[4], x[5], x[6], "cosine", x[7]),
    "kg_mse": lambda L, x: L.kg_alignment_loss(x[2], x[4], x[5], x[6], "mse", x[7]),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(rng, name):
    B, K, D, Dk = 6, 7, 16, 5
    arrays = (rng.standard_normal((B, K)) * 2, (rng.random((B, K)) < 0.3),
              rng.standard_normal((B, D)), rng.standard_normal((B, D)),
              rng.standard_normal((D, Dk)), rng.standard_normal((B, Dk)),
              np.array([1, 1, 0, 1, 1, 1]), np.array([1, 1, 1, 1, 0, 0]),
              rng.random(K) * 3 + 0.5)
    arrays = [np.asarray(a, np.float32) for a in arrays]
    fn = LOSSES[name]
    want = float(fn(JL, [jnp.asarray(a) for a in arrays]))
    got = float(fn(TL, [t(a) for a in arrays]))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mu_bf16", [False, True])
def test_optimizer_matches_optax(rng, mu_bf16):
    """4 updates on identical gradients: the lr-0 first update, a clipped one
    (global norm 30), warmup and cosine steps."""
    shapes = {"w": (8, 5), "b": (5,), "s": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.1, 5.0, 0.05, 0.2)]
    tx = jmake_optimizer(1e-2, total_steps=20, mu_dtype=jnp.bfloat16 if mu_bf16 else None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)

    ours = make_optimizer(1e-2, total_steps=20, mu_bf16=mu_bf16)
    from mmrp_tpu_torch.train.state import TrainState

    tp = {k: t(v.copy()) for k, v in params.items()}
    state = TrainState(tp, *ours.init(tp), count=0, seed=0, tx=ours)
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = ours.apply(state, {k: t(v) for k, v in g.items()})
        np.testing.assert_allclose(norm, float(optax.global_norm(jg)), rtol=1e-6)
        adam = jstate[1][0]
        for k in shapes:
            np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
            assert state.mu[k].dtype == (torch.bfloat16 if mu_bf16 else torch.float32)
            np.testing.assert_allclose(state.mu[k].float().numpy(),
                                       np.asarray(adam.mu[k]).astype(np.float32),
                                       rtol=1e-6, atol=1e-9, err_msg=f"step {i} mu {k}")
            np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(adam.nu[k]),
                                       rtol=1e-6, atol=1e-12, err_msg=f"step {i} nu {k}")
        if i == 0:  # the schedule reads the count before the increment: lr 0
            for k in shapes:
                np.testing.assert_array_equal(state.params[k].numpy(), params[k])
    assert state.count == 4


def randomize(params, seed=0):
    """Every leaf + N(0, 0.02^2); ``alpha`` (zero at init) -> 0.5 + N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.02
        if getattr(path[-1], "key", None) == "alpha":
            return jnp.asarray(0.5 + noise)
        return jnp.asarray(np.asarray(leaf) + noise)

    return jax.tree_util.tree_map_with_path(move, params)


def test_swin_training_route_matches_jax(rng, monkeypatch):
    """Outputs and every parameter gradient (rel_bias_table included) of the
    encoder's training route, dropout and drop path 0, against JAX's XLA
    branch with its core kernel (MMRP_SWIN_CORE=1)."""
    monkeypatch.setenv("MMRP_SWIN_CORE", "1")
    jmodel = jswin.SwinEncoder(jswin.SwinConfig(**SWIN, use_pallas=False, drop_path_rate=0.0))
    x = rng.random((2, 56, 56, 3), dtype=np.float32)
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    w_p = rng.standard_normal((2, 49, 32)).astype(np.float32)
    w_g = rng.standard_normal((2, 32)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out["patches"] * w_p) + jnp.sum(out["global"] * w_g), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    model = SwinEncoder(SwinConfig(**SWIN, drop_path_rate=0.0), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    out = model(t(x), deterministic=False, generator=torch.Generator().manual_seed(0))
    loss = (out["patches"] * t(w_p)).sum() + (out["global"] * t(w_g)).sum()
    loss.backward()
    np.testing.assert_allclose(out["patches"].detach().numpy(), np.asarray(jout["patches"]),
                               **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    want = flax_to_state_dict(jgrads)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
    assert float(named["stage0_block1.attn.rel_bias_table"].grad.abs().sum()) > 0


def step_batch(seed=3, B=4, L=16):
    rng = np.random.default_rng(seed)
    lengths = np.array([L, 9, 1, 5])
    return {
        "image": rng.random((B, 56, 56, 3), dtype=np.float32),
        "input_ids": rng.integers(0, 8192, (B, L)).astype(np.int32),
        "attention_mask": (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32),
        "labels": (rng.random((B, 7)) < 0.3).astype(np.float32),
        "valid": np.array([1, 1, 1, 0], np.float32),
        "kg_target": rng.standard_normal((B, KG_DIM)).astype(np.float32),
        "kg_target_valid": np.array([1, 0, 1, 1], np.float32),
    }


def tiny_models(seed=0):
    """(JAX model, JAX train params {model, kg_proj}, port model with the
    same weights and its kg_proj), dropout and drop path 0."""
    jcfg = jmm.MultiModalConfig(
        swin=jswin.SwinConfig(**SWIN, use_pallas=False, drop_path_rate=0.0),
        text=JTextConfig.small(dropout=0.0, **TEXT), dropout=0.0, drop_path=0.0, **HEAD)
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    b = step_batch()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.asarray(b["image"]),
                                  jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]))
    rng = np.random.default_rng(seed)
    kg = (rng.standard_normal((HEAD["joint_dim"], KG_DIM)) / 8).astype(np.float32)
    jparams = {"model": randomize(params["params"], seed), "kg_proj": jnp.asarray(kg)}
    tcfg = MultiModalConfig(swin=SwinConfig(**SWIN, drop_path_rate=0.0),
                            text=TextConfig.small(dropout=0.0, **TEXT), dropout=0.0,
                            drop_path=0.0, **HEAD)
    model = MultiModalRetrievalModel(tcfg, device="cpu")
    extra = load_flax_params(model, jparams)
    return jmodel, jparams, model, extra["kg_proj"]


def test_train_step_matches_jax(monkeypatch):
    """Gradients, each step's metrics, and the parameters after 3 steps of
    the port's make_train_step against JAX compute_losses + make_train_step,
    with kg_proj, dropout and drop path 0, at lr 1e-3 over 10 steps (warmup
    1: the first update has lr 0)."""
    monkeypatch.setenv("MMRP_SWIN_CORE", "1")
    jmodel, jparams, model, kg_proj = tiny_models()
    batch = step_batch()
    pos_weight = np.linspace(0.5, 2.0, 7).astype(np.float32)
    lr = 1e-3
    jcfg = JConfig(lr=lr, adam_mu_bf16=True)
    cfg = Config(lr=lr, adam_mu_bf16=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: t(v) for k, v in batch.items()}
    tbatch["input_ids"] = tbatch["input_ids"].long()

    # gradients at the initial weights
    jgrads = jax.jit(jax.grad(lambda p: jjoint.compute_losses(
        jmodel, p, jbatch, jax.random.PRNGKey(0), jcfg, jnp.asarray(pos_weight))[0]))(jparams)
    kg = kg_proj.clone().requires_grad_(True)
    total, _ = compute_losses(model, kg, tbatch, torch.Generator(), cfg, t(pos_weight))
    total.backward()
    want = flax_to_state_dict(jgrads)
    np.testing.assert_allclose(kg.grad.numpy(), want.pop("kg_proj").numpy(), **GRAD_TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
    model.zero_grad(set_to_none=True)

    # three steps
    # jjoint.init_train_state with the weights above in place of model.init's
    jstate = JTrainState.create(
        apply_fn=jmodel.apply, params=jparams, base_rng=jax.random.PRNGKey(jcfg.seed),
        tx=jmake_optimizer(lr, 10, mu_dtype=jnp.bfloat16))
    jstep = jjoint.make_train_step(jmodel, jcfg, pos_weight, donate=False)
    state = init_train_state(model, cfg, total_steps=10, kg_dim=KG_DIM)
    state.params["kg_proj"].copy_(kg_proj)
    step = make_train_step(model, cfg, pos_weight)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        assert set(m) == set(jm)
        for key in jm:
            np.testing.assert_allclose(m[key], float(jm[key]), rtol=2e-4, err_msg=f"{i} {key}")

    want = flax_to_state_dict(jstate.params)
    moved = 0
    for name, master in state.params.items():
        d = np.abs(master.numpy() - want[name].numpy())
        assert d.max() <= 2 * lr * 2, name  # two updates with lr > 0
        moved += int((d > 1e-2 * lr).sum())
    assert moved <= sum(p.numel() for p in state.params.values()) // 1000
    # the f32 model shares its masters: the stepped weights are the model's
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), state.params[name])


def test_bf16_model_steps_its_f32_masters_and_reads_them_back():
    """A model in bf16 (its LayerNorms, bias tables, alpha, cls_out f32) keeps
    f32 masters in the state: after each step every parameter is its master
    cast to the parameter's dtype, and the bf16 weights did move. The masters
    match an f32 model's on the same weights: the first update has lr 0 and
    the second, on the same batch, is lr * sign(mu) + decay, so the runs part
    only where bf16 rounding flips a near-zero gradient's sign (2 lr apart):
    about 1 element in 110 at this seed, held to 1 in 50. The losses, bf16
    against f32 through every layer, agree within 5e-3 relative."""
    _, _, model32, kg_proj = tiny_models(seed=2)
    model16 = MultiModalRetrievalModel(model32.config, dtype=torch.bfloat16, device="cpu")
    model16.load_state_dict(model32.state_dict())
    batch = {k: t(v) for k, v in step_batch().items()}
    batch["input_ids"] = batch["input_ids"].long()
    lr = 1e-3
    cfg = Config(lr=lr, adam_mu_bf16=True)
    runs = []
    for model in (model32, model16):
        state = init_train_state(model, cfg, total_steps=10, kg_dim=KG_DIM)
        state.params["kg_proj"].copy_(kg_proj)
        for name, p in model32.named_parameters():  # the f32 weights, not their bf16 casts
            state.params[name].copy_(p.detach())
        runs.append((model, state, make_train_step(model, cfg)))
    named16 = dict(model16.named_parameters())
    low = {n for n, p in named16.items() if p.dtype == torch.bfloat16}
    assert low and len(low) < len(named16)  # both kinds of parameter are there
    before = {n: named16[n].detach().clone() for n in low}
    metrics = []
    for i in range(2):
        metrics.append([step(state, batch)[1] for _, state, step in runs])
        _, state16, _ = runs[1]
        for name, p in named16.items():
            assert torch.equal(p.detach(), state16.params[name].to(p.dtype)), f"{i} {name}"
    for n in low:
        assert not torch.equal(named16[n].detach(), before[n]), n
    for m32, m16 in metrics:
        np.testing.assert_allclose(m16["loss/total"], m32["loss/total"], rtol=5e-3)
    masters32, masters16 = runs[0][1].params, runs[1][1].params
    flipped = 0
    for name, m32 in masters32.items():
        d = (masters16[name] - m32).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), name
        flipped += int((d > 1e-2 * lr).sum())
    assert flipped <= sum(m.numel() for m in masters32.values()) // 50


def test_dropout_is_seeded_keeps_its_rate_and_scales():
    x = torch.rand(200_000) + 1.0
    a = dropout(x, 0.25, torch.Generator().manual_seed(7))
    b = dropout(x, 0.25, torch.Generator().manual_seed(7))
    c = dropout(x, 0.25, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    # binomial: 4 sigma of the kept fraction at n = 200,000 is 0.004
    assert abs(kept.float().mean().item() - 0.75) < 4e-3
    torch.testing.assert_close(a[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert dropout(x, 0.0, torch.Generator()) is x


def test_drop_path_drops_whole_samples():
    x = torch.rand(4000, 3, 5) + 1.0
    dp = DropPath(0.2)
    a = dp(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, dp(x, torch.Generator().manual_seed(1)))
    kept = (a != 0).flatten(1)
    assert bool((kept.all(1) | ~kept.any(1)).all())  # one draw per sample
    assert abs(kept.all(1).float().mean().item() - 0.8) < 4 * (0.16 / 4000) ** 0.5
    torch.testing.assert_close(a[kept.all(1)], x[kept.all(1)] / 0.8, rtol=0, atol=0)
    assert DropPath(0.0)(x, torch.Generator()) is x


def test_serving_after_a_training_step_reads_the_stepped_weights():
    """Two steps (the first has lr 0) change every Swin relative-bias table;
    serving then matches a fresh model loaded with the stepped weights, and
    each block's cached serving bias is rebuilt from its table."""
    _, _, model, _ = tiny_models(seed=1)
    batch = {k: t(v) for k, v in step_batch().items()}
    batch["input_ids"] = batch["input_ids"].long()
    tables = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.endswith("rel_bias_table")}
    state = init_train_state(model, Config(lr=1e-2, adam_mu_bf16=False), total_steps=4)
    step = make_train_step(model, Config(lr=1e-2, adam_mu_bf16=False))
    for _ in range(2):
        state, metrics = step(state, batch)
        assert np.isfinite(metrics["loss/total"]) and np.isfinite(metrics["grad_norm"])
    named = dict(model.named_parameters())
    for n, before in tables.items():
        assert not torch.equal(named[n].detach(), before), n
    attn = model.backbones.swin.stage0_block1.attn
    torch.testing.assert_close(attn.bias_full, build_bias_full(
        attn.rel_bias_table.detach(), 7, 14, 14, attn.shift), rtol=0, atol=0)

    fresh = MultiModalRetrievalModel(model.config, device="cpu")
    fresh.load_state_dict(model.state_dict())
    args = (batch["image"], batch["input_ids"], batch["attention_mask"])
    got, want = serving_forward(model)(*args), serving_forward(fresh)(*args)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("out_dim", [0, 24])
def test_mlp_matches_jax(rng, out_dim):
    """Mlp deterministic (no generator) and in training at dropout 0."""
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    jmlp = JMlp(hidden_dim=32, out_dim=out_dim or None)
    params = randomize(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jmlp.apply({"params": params}, jnp.asarray(x)))
    mlp = Mlp(16, 32, out_dim)
    mlp.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        np.testing.assert_allclose(mlp(t(x)).numpy(), want, **TOL)
        np.testing.assert_allclose(mlp(t(x), torch.Generator()).numpy(), want, **TOL)


def jax_augment_draws(key, B):
    """The angles and flips JAX's augmented step draws from its step key:
    compute_losses splits off the augmentation key, augment_batch splits it
    into a rotation and a flip key (mmrp_tpu/ops/preprocess.py)."""
    _, aug = jax.random.split(key)
    k_rot, k_flip = jax.random.split(aug)
    theta = jax.random.uniform(k_rot, (B,), minval=-1.0, maxval=1.0) * 5.0 * jnp.pi / 180.0
    return t(np.array(theta)), t(np.array(jax.random.bernoulli(k_flip, 0.1, (B,))))


def test_config_refuses_augment(monkeypatch):
    """``Config(augment=True)``, refused by the train step until the port had
    ``augment_batch``, now trains on augmented images where JAX does: the
    loss of compute_losses and the metrics of a make_train_step step, with
    the angles and flips JAX draws from its keys (the port draws its own from
    the step's generator), against JAX's at dropout and drop path 0; the
    augmentation moves the loss; deterministic losses do not augment."""
    from mmrp_tpu_torch.ops import preprocess

    jmodel, jparams, model, kg_proj = tiny_models()
    batch = step_batch()
    B = batch["image"].shape[0]
    pos_weight = np.linspace(0.5, 2.0, 7).astype(np.float32)
    jcfg, cfg = JConfig(augment=True), Config(augment=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: t(v) for k, v in batch.items()}
    tbatch["input_ids"] = tbatch["input_ids"].long()
    draws = []

    def jax_drawn(images, generator):
        theta, flip = draws.pop(0)
        return preprocess.augment_with(images, theta, flip)

    monkeypatch.setattr(preprocess, "augment_batch", jax_drawn)

    def jax_metrics(key):
        fn = jax.jit(lambda p: jjoint.compute_losses(jmodel, p, jbatch, key, jcfg,
                                                     jnp.asarray(pos_weight))[1])
        return {k: float(v) for k, v in fn(jparams).items()}

    want = jax_metrics(jax.random.PRNGKey(0))
    draws.append(jax_augment_draws(jax.random.PRNGKey(0), B))
    with torch.no_grad():
        total, metrics = compute_losses(model, kg_proj, tbatch, torch.Generator(), cfg,
                                        t(pos_weight))
        plain, _ = compute_losses(model, kg_proj, tbatch, None, Config(), t(pos_weight),
                                  deterministic=True)
        held, _ = compute_losses(model, kg_proj, tbatch, None, cfg, t(pos_weight),
                                 deterministic=True)
    assert not draws and abs(float(total) - float(plain)) > 1e-4
    assert float(held) == float(plain)
    for key in want:
        np.testing.assert_allclose(float(metrics[key]), want[key], rtol=2e-4, err_msg=key)

    step_key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), 0)
    want = jax_metrics(step_key)
    draws.append(jax_augment_draws(step_key, B))
    state = init_train_state(model, cfg, total_steps=10, kg_dim=KG_DIM)
    state.params["kg_proj"].copy_(kg_proj)
    _, metrics = make_train_step(model, cfg, pos_weight)(state, tbatch)
    assert not draws
    for key in want:
        np.testing.assert_allclose(metrics[key], want[key], rtol=2e-4, err_msg=key)
