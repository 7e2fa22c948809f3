"""Gradients of the int8 serving mixes, and the explain engine over them,
against the JAX package on the CPU.

JAX gives its dynamic W8A8 kernels (K3 ``quant=True``, the whole block's
dynamic windows and raw flavors) a ``custom_vjp`` whose backward
differentiates the unquantized XLA function: a straight-through gradient.
Its static W8A8 forms (windows, chain, pair) carry no VJP, so ``jax.grad``
through them raises. ``quant_dot`` / ``quant_dot_multi`` are differentiated
by JAX itself: the rounded int8 product is constant, the per-row activation
scale is not. The port's routes (``ops/_build.py``) are held to each, on the
same seeded numpy inputs: the dynamic forms' gradients against ``jax.vjp``
of the Pallas kernels in interpret mode, the static forms' backward raising,
``quant_dot``'s gradient against ``jax.vjp`` of JAX's. Then
``ExplanationEngine`` on a micro model at ``serve_quant`` "int8" and
"int8_static" (with a calibrated ``act_amax``) against JAX's engine on its
kernel route (``MMRP_FORCE_PALLAS=1`` and the whole-block width gates at 16,
``tests/test_torch_quant.py::kernel_route``): every method JAX completes
gives JAX's maps, and pixel IG over the static Swin raises in both.

Tolerances, stated per test: the backward of both sides is the same f32
function (differentiated by XLA and by autograd, sums in other orders),
rtol 1e-4 and atol 1e-6 of max(1, the gradient's largest magnitude): a weight's
gradient sums hundreds of rows of O(1) products (the ``quant_dot`` gradient
1e-6); the engine's maps, each normalized to [0, 1], within 5e-3 and with a
Pearson correlation of at least 0.9999 with JAX's: the W8A8 GEMMs quantize
f32 inputs that the two packages compute with sums in other orders, so an
input within rounding of an int8 step lands one step apart now and then
(measured: 4.3e-3 on an attention map at "int8", 1.1e-3 on patch IG at
"int8_static", below 1e-4 elsewhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.models import explain as jexplain
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models import quant_calib as jqc
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.ops import fused_attention as jfa
from mmrp_tpu.ops import fused_swin_block as jsb
from mmrp_tpu.ops import fused_swin_pair as jsp
from mmrp_tpu.ops import quant as jq
from mmrp_tpu.ops import window_attention as jwa
from mmrp_tpu_torch.models import explain
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.ops import fused_attention as tfa
from mmrp_tpu_torch.ops import fused_swin_block as tsb
from mmrp_tpu_torch.ops import fused_swin_pair as tsp
from mmrp_tpu_torch.ops import quant as tq
from mmrp_tpu_torch.utils.convert import load_flax_params
from test_torch_quant import WS, _block, _case, _port, _static, _t, kernel_route  # noqa: F401
from test_torch_slice import randomize

GRADS_RTOL, GRADS_ATOL = 1e-4, 1e-6  # atol relative to max(1, the gradient's largest |value|)


def _grads_match(port_fn, jax_fn, arrays, weights):
    """Port gradients of sum(port_fn(*leaves) * g) against jax.vjp of
    jax_fn on the same arrays and cotangent g, input by input; the arrays
    at the indices ``weights`` are Flax kernels, transposed to the
    nn.Linear layout for the port and their gradients back. Returns the
    number of inputs compared."""
    rng = np.random.default_rng(7)
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    want_out, vjp = jax.vjp(jax_fn, *jargs)
    g = rng.standard_normal(np.shape(want_out)).astype(np.float32)
    want = vjp(jnp.asarray(g))
    leaves = [None if a is None else (_t(a.T) if i in weights else _t(a)).requires_grad_(True)
              for i, a in enumerate(arrays)]
    port_fn(*leaves).backward(_t(g))
    compared = 0
    for i, (t, w) in enumerate(zip(leaves, want)):
        if t is None:
            continue
        # an input the function does not use: None here, zeros in JAX
        got = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        w = np.asarray(w)
        np.testing.assert_allclose(got.T if i in weights else got, w, err_msg=f"input {i}",
                                   rtol=GRADS_RTOL,
                                   atol=GRADS_ATOL * max(1.0, float(np.abs(w).max())))
        compared += 1
    return compared


# -- the dynamic W8A8 forms: JAX's custom_vjp --------------------------------------


@pytest.mark.parametrize("ln_mode,cross", [("post", False), ("pre", False), ("none", True)])
def test_k3_int8_gradient_is_jax_vjp(rng, ln_mode, cross):
    """3q: every input's gradient (x, kv, the LN parameters, the four
    projections, pos, alpha) against JAX's ``fused_attention(quant=True)``
    VJP; C 64, 2 heads, 16 / 8 tokens with a key mask (not differentiated,
    as JAX's zero cotangent)."""
    B, Nq, Nk, C = 2, 16, 8, 64
    x = rng.standard_normal((B, Nq, C)).astype(np.float32)
    kv = rng.standard_normal((B, Nk, C)).astype(np.float32) if cross else None
    nk = Nk if cross else Nq
    mask = np.where(rng.random((B, nk)) < 0.3, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    ln = [(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
          (0.1 * rng.standard_normal(C)).astype(np.float32)]
    w = []
    for _ in range(4):
        w += [(rng.standard_normal((C, C)) * C ** -0.5).astype(np.float32),
              (0.1 * rng.standard_normal(C)).astype(np.float32)]
    pos = (0.5 * rng.standard_normal((Nq, C))).astype(np.float32) if ln_mode == "pre" else None
    alpha = np.float32(0.37) if ln_mode == "pre" else None
    kw = dict(num_heads=2, ln_mode=ln_mode, include_residual=not cross,
              residual_from_raw=ln_mode == "pre")

    def jax_fn(x, ln_s, ln_b, *rest):
        *ws, kv_, pos_, alpha_ = rest
        return jfa.fused_attention(x, ln_s, ln_b, *ws, kv=kv_, key_mask=jnp.asarray(mask),
                                   pos=pos_, alpha=alpha_, interpret=True, quant=True, **kw)

    def port_fn(x, ln_s, ln_b, *rest):
        *ws, kv_, pos_, alpha_ = rest
        launches = tfa.fused_attention.launches_int8
        out = tfa.fused_attention(x, ln_s, ln_b, *ws, kv=kv_, key_mask=_t(mask), pos=pos_,
                                  alpha=alpha_, quant=True, **kw)
        assert tfa.fused_attention.launches_int8 == launches  # CPU: the plain version
        assert out.grad_fn is not None and "KernelRecompute" in type(out.grad_fn).__name__
        return out

    arrays = [x, *ln, *w, kv, pos, None if alpha is None else np.asarray(alpha)]
    assert _grads_match(port_fn, jax_fn, arrays, {3, 5, 7, 9}) == \
        len([a for a in arrays if a is not None])


@pytest.mark.parametrize("flavor", ["windows", "raw"])
def test_dynamic_block_gradient_is_jax_vjp(rng, flavor):
    """4d / 5d: the gradients of x and the 12 block parameters against
    JAX's dynamic ``fused_swin_block_windows`` / ``_raw`` VJP (C 64, 2
    heads, a 14 x 14 map in 7 x 7 windows, shifted for raw); the bias
    table's layouts differ (JAX's padded), so its gradient is not compared."""
    x, blk, jbias, tbias = _case(rng, 64, 2, H=14, shift=3 if flavor == "raw" else 0)
    if flavor == "windows":
        x = np.asarray(jwa.window_partition(jnp.asarray(x), WS))

        def jax_fn(x, *b):
            return jsb.fused_swin_block_windows(x, *b, jbias, 2, pad_gemm=True, quant=True,
                                                interpret=True)

        def port_fn(x, *b):
            return tsb.fused_swin_block_windows(x, *b, tbias, 2, quant=True)
    else:
        x = np.roll(x, (-3, -3), (1, 2))

        def jax_fn(x, *b):
            return jsb.fused_swin_block_raw(x, *b, jbias, 2, WS, quant=True, interpret=True)

        def port_fn(x, *b):
            return tsb.fused_swin_block_raw(x, *b, tbias, 2, WS, quant=True)
    assert _grads_match(port_fn, jax_fn, [x, *blk], {3, 5, 9, 11}) == 13


def test_dynamic_gradient_route_needs_the_float_weights(rng):
    """A dynamic form given the int8 copies cannot recompute the unquantized
    block for its backward: a recorded call raises, naming the fix; without
    autograd the same call runs."""
    x, blk, _, tbias = _case(rng, 64, 2, H=14)
    _, _, tblk, ts = _static(blk)
    xw = tsb.window_partition(_t(x), WS).contiguous()
    with torch.no_grad():
        tsb.fused_swin_block_windows(xw, *tblk, tbias, 2, quant=True, wscales=ts)
    with pytest.raises(ValueError, match="float weights"):
        tsb.fused_swin_block_windows(xw.requires_grad_(), *tblk, tbias, 2, quant=True,
                                     wscales=ts)


def test_plain_routes_keep_the_kernel_routes_gradients(rng):
    """A plain route of the plan (``_build.run_plain``, a shape the kernel
    refuses) runs the int8 plain version forward and keeps its kernel
    route's gradient: the dynamic windows block the unquantized block's
    (bit-equal to autograd through it), the static one a raising backward;
    each call counted as plain."""
    from mmrp_tpu_torch.ops import _build

    x, blk, _, tbias = _case(rng, 64, 2, H=14)
    xw = tsb.window_partition(_t(x), WS).contiguous()
    fn = tsb.fused_swin_block_windows
    calls = fn.plain_calls
    a = xw.clone().requires_grad_(True)
    out = _build.run_plain(fn, tsb.swin_block_plain, a, *_port(blk), tbias, 2, quant=True)
    with torch.no_grad():
        np.testing.assert_array_equal(out.detach().numpy(), tsb.swin_block_plain(
            xw, *_port(blk), tbias, 2, quant=True).numpy())
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (got,) = torch.autograd.grad(out, a, g)
    b = xw.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tsb.swin_block_plain(b, *_port(blk), tbias, 2), b, g)
    assert torch.equal(got, want)
    _, _, tblk, ts = _static(blk)
    out = _build.run_plain(fn, tsb.swin_block_plain, xw.clone().requires_grad_(True), *tblk,
                           tbias, 2, quant="static", wscales=ts)
    with pytest.raises(RuntimeError, match="static W8A8 block has no gradient"):
        out.sum().backward()
    assert fn.plain_calls == calls + 2


# -- the static W8A8 forms: no VJP in JAX, a backward that raises here ----------------


@pytest.mark.parametrize("flavor", ["windows", "chain", "pair"])
def test_static_forms_have_no_gradient(rng, flavor):
    """``jax.grad`` through JAX's static windows / chain / pair raises; the
    port's forward is the no-autograd one and its backward raises, naming
    the static block."""
    x, blk, jbias, tbias = _case(rng, 64, 2, H=14)
    jblk, js, tblk, ts = _static(blk)
    acts = (4.0 / 127, 4.0 / 127, 5.0 / 127, 3.0 / 127)
    if flavor == "windows":
        x = np.asarray(jwa.window_partition(jnp.asarray(x), WS))

        def jax_fn(x):
            return jsb.fused_swin_block_windows(x, *jblk, jbias, 2, quant="static", wscales=js,
                                                act_scales=acts, interpret=True)

        def port_fn(x):
            return tsb.fused_swin_block_windows(x, *tblk, tbias, 2, quant="static",
                                                wscales=ts, act_scales=acts)
    elif flavor == "chain":
        def jax_fn(x):
            return jsp.fused_swin_block_chain(x, jblk, jbias, 2, WS, -3, quant="static",
                                              wscales=js, act_scales=acts, interpret=True)

        def port_fn(x):
            return tsp.fused_swin_block_chain(x, tblk, tbias, 2, WS, -3, quant="static",
                                              wscales=ts, act_scales=acts)
    else:
        def jax_fn(x):
            return jsp.fused_swin_block_pair(x, jblk, jbias, jblk, jbias, 2, WS, 3,
                                             quant="static", wscales0=js, wscales1=js,
                                             interpret=True)

        def port_fn(x):
            return tsp.fused_swin_block_pair(x, tblk, tbias, tblk, tbias, 2, WS, 3,
                                             quant="static", wscales0=ts, wscales1=ts)
    with pytest.raises(Exception):
        jax.grad(lambda a: jax_fn(a).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = port_fn(xt)
    with torch.no_grad():
        np.testing.assert_array_equal(out.detach().numpy(), port_fn(_t(x)).numpy())
    with pytest.raises(RuntimeError, match="static W8A8 block has no gradient"):
        out.sum().backward()


# -- quant_dot: the gradient through the activation scale --------------------------


def test_quant_dot_gradient_is_jax(rng):
    """d/dx of quant_dot and quant_dot_multi (float weights quantized inside,
    and int8 copies with their scales) against ``jax.vjp`` of JAX's: the
    per-row scale's gradient, nothing through the rounding (1e-6); a row of
    zeros (the eps clamp) gets none in both."""
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    x[1, 3] = 0.0
    w1, w2 = (rng.standard_normal((96, 32)).astype(np.float32) * 0.1 for _ in range(2))
    b = rng.standard_normal(32).astype(np.float32)
    g1, g2 = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(2))

    def jfn(x):
        y1, y2 = jq.quant_dot_multi(x, [(jnp.asarray(w1), jnp.asarray(b)),
                                        (jnp.asarray(w2), None)])
        return (y1 * g1).sum() + (y2 * g2).sum() + (jq.quant_dot(x, jnp.asarray(w2)) * g1).sum()

    want = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    (wq1, s1), (wq2, s2) = (tq.quantize_weight(_t(w.T)) for w in (w1, w2))
    for cached in (False, True):
        xt = _t(x).requires_grad_(True)
        if cached:
            y1, y2 = tq.quant_dot_multi(xt, [(wq1, _t(b)), (wq2, None)], wscales=[s1, s2])
            y3 = tq.quant_dot(xt, wq2, wscale=s2)
        else:
            y1, y2 = tq.quant_dot_multi(xt, [(_t(w1.T), _t(b)), (_t(w2.T), None)])
            y3 = tq.quant_dot(xt, _t(w2.T))
        ((y1 * _t(g1)).sum() + (y2 * _t(g2)).sum() + (y3 * _t(g1)).sum()).backward()
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).max() > 0 and not want[1, 3].any()


# -- the engine over the int8 mixes, against JAX's on its kernel route ----------------

ESWIN = dict(img_size=28, embed_dim=16, depths=(1,), num_heads=(2,), window_size=7)
ETEXT = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64,
             max_positions=16)
EHEAD = dict(joint_dim=32, num_fusion_layers=1, num_heads=2, num_classes=8, max_text_len=8)
MAPS_ATOL, MAPS_PEARSON = 5e-3, 0.9999


@pytest.fixture(scope="module")
def float_params():
    """JAX params of the float micro model, the calibrated act_amax of its
    Swin, and a batch of 2 (the second report 5 tokens long)."""
    rng = np.random.default_rng(2709)
    img = rng.random((2, 28, 28, 3), dtype=np.float32)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = (np.arange(8)[None, :] < np.array([8, 5])[:, None]).astype(np.int32)
    jcfg = jmm.MultiModalConfig(swin=JSwinConfig(**ESWIN), text=JTextConfig.small(**ETEXT),
                                **EHEAD)
    params = randomize(jax.jit(jmm.MultiModalRetrievalModel(jcfg).init)(
        jax.random.PRNGKey(0), img, ids, mask)["params"])
    amax = jqc.calibrate_swin_act_amax(JSwinConfig(**ESWIN), params["backbones"]["swin"], img,
                                       batch_size=2)
    return params, amax, (img, ids, mask)


def _engines(mix, params, amax):
    """(JAX engine, port engine) at serve_quant ``mix``: Swin static int8
    with act_amax for int8_static, BERT int8_kernel, the fusion stack int8."""
    swin_q = {"quant": "int8_static", "act_amax": amax} if mix == "int8_static" else {}
    jcfg = jmm.MultiModalConfig(
        swin=JSwinConfig(**ESWIN, **swin_q),
        text=JTextConfig.small(**ETEXT, quant="int8_kernel"), quant="int8", **EHEAD)
    tcfg = MultiModalConfig(swin=SwinConfig(**ESWIN, whole_min_c=16, **swin_q),
                            text=TextConfig.small(**ETEXT, quant="int8_kernel"), quant="int8",
                            **EHEAD)
    model = MultiModalRetrievalModel(tcfg, device="cpu").eval()
    load_flax_params(model, params)
    return (jexplain.ExplanationEngine(jmm.MultiModalRetrievalModel(jcfg), {"model": params}),
            explain.ExplanationEngine(model))


@pytest.mark.parametrize("mix", ["int8", "int8_static"])
def test_engine_over_int8_mixes_is_jax(float_params, kernel_route, mix):  # noqa: F811
    """Attention maps, patch IG, Grad-CAM and token IG (4 steps) at batch 2
    against JAX's engine (5e-3, Pearson 0.9999); pixel IG against JAX's at
    "int8" (its Swin bf16), raising in both packages at "int8_static"."""
    params, amax, (img, ids, mask) = float_params
    jeng, teng = _engines(mix, params, amax)
    calls = {
        "attention": lambda e: e.attention_maps(img, ids, mask),
        "ig": lambda e: e.integrated_gradients(img, ids, mask, 3, n_steps=4, chunk=2),
        "grad_cam": lambda e: e.grad_cam(img, ids, mask, np.array([1, 6])),
        "tokens": lambda e: e.token_attribution(img, ids, mask, 3, n_steps=4),
    }
    for name, call in calls.items():
        want, got = call(jeng), call(teng)
        if not isinstance(want, dict):
            want, got = {name: want}, {name: got}
        assert got.keys() == want.keys(), name
        for key in want:
            w = np.asarray(want[key])
            np.testing.assert_allclose(got[key], w, rtol=0, atol=MAPS_ATOL, err_msg=key)
            assert explain.compare_maps(got[key], w)["pearson"] >= MAPS_PEARSON, key
            assert np.ptp(w) > 0, key
    if mix == "int8_static":
        with pytest.raises(Exception):
            jeng.integrated_gradients_pixels(img, ids, mask, 3, n_steps=2)
        with pytest.raises(RuntimeError, match="static W8A8 block has no gradient"):
            teng.integrated_gradients_pixels(img, ids, mask, 3, n_steps=2)
    else:
        np.testing.assert_allclose(teng.integrated_gradients_pixels(img, ids, mask, 3, n_steps=2),
                                   jeng.integrated_gradients_pixels(img, ids, mask, 3, n_steps=2),
                                   rtol=0, atol=MAPS_ATOL)
