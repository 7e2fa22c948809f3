"""The port's W8A8 serving mix against the JAX package, on the CPU.

``mmrp_tpu_torch.ops.quant`` and the int8 plain versions of the kernels
(K3's ``quant=True``; the whole-block windows flavor static and dynamic, raw
dynamic, pair and chain static), which every wrapper runs for a CPU tensor,
are held against ``mmrp_tpu.ops.quant`` and the Pallas kernels in interpret
mode on the same seeded numpy inputs; then Swin routing under each
precision, the calibration, the text encoder's quant modes and the serving
forward of a tiny multimodal model at ``int8_static`` and ``int8``.

Tolerances. Quantization and the int32 sums are exact on both sides, so
``quantize_weight`` / ``quantize_acts`` are bit-equal and ``quant_dot`` is
equal up to f32 rounding. Past that, both sides compute their f32 GEMM
inputs (LayerNorm, attention, GELU) with sums in other orders; where such a
value lies within ~1e-7 of a rounding boundary of the int8 grid it lands one
step apart, which moves an output by up to one activation quantization step
(the row's amax / 127) times the weights it meets. The bound of each test is
a few such steps, stated beside it; the int8 kernels' tests also bound the
share of outputs that differ at all, and show that a wrong int8 form (the
float version, the other kind of activation scale) exceeds it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models import quant_calib as jqc
from mmrp_tpu.models import swin as jswin
from mmrp_tpu.models import text_encoder as jtext
from mmrp_tpu.ops import fused_attention as jfa
from mmrp_tpu.ops import fused_swin_block as jsb
from mmrp_tpu.ops import fused_swin_pair as jsp
from mmrp_tpu.ops import quant as jq
from mmrp_tpu.ops import window_attention as jwa
from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models import quant_calib as tqc
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder, swin_plan
from mmrp_tpu_torch.models.text_encoder import TextConfig, TextEncoder
from mmrp_tpu_torch.ops import fused_attention as tfa
from mmrp_tpu_torch.ops import fused_swin_block as tsb
from mmrp_tpu_torch.ops import fused_swin_pair as tsp
from mmrp_tpu_torch.ops import quant as tq
from mmrp_tpu_torch.ops.fused_window_attention import build_bias_full
from mmrp_tpu_torch.utils.convert import load_flax_params

WS = 7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# -- ops/quant.py ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 24), (64, 3 * 64), (3, 5)])
def test_quantize_weight_bit_equal(rng, shape):
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero output channel: the eps clamp
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(_t(w.T))  # nn.Linear layout (N, K)
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(-1))


def test_quantize_acts_bit_equal(rng):
    x = rng.standard_normal((2, 7, 40)).astype(np.float32) * 3
    x[0, 2] = 0.0
    jx, js = jq.quantize_acts(jnp.asarray(x))
    tx, ts = tq.quantize_acts(_t(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_dot_and_multi_match_jax(rng):
    """Exact int32 sums on both sides (f64 here: |acc| < 2^53), then the same
    f32 dequantization: equal to f32 rounding, at a width (K 3072) where an
    f32 product of the int8 values would not be exact."""
    x = rng.standard_normal((2, 5, 3072)).astype(np.float32)
    w1, w2 = (rng.standard_normal((3072, 16)).astype(np.float32) * 0.02 for _ in range(2))
    b = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jq.quant_dot(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b)))
    got = tq.quant_dot(_t(x), _t(w1.T), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jm = jq.quant_dot_multi(jnp.asarray(x), [(jnp.asarray(w1), jnp.asarray(b)),
                                             (jnp.asarray(w2), None)])
    (wq1, sw1), (wq2, sw2) = (tq.quantize_weight(_t(w.T)) for w in (w1, w2))
    tm = tq.quant_dot_multi(_t(x), [(wq1, _t(b)), (wq2, None)], wscales=[sw1, sw2])
    for g, w in zip(tm, jm):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# -- K3 with quant=True -----------------------------------------------------------


@pytest.mark.parametrize("ln_mode,cross", [("post", False), ("pre", False), ("none", True)])
def test_k3_int8_matches_jax(rng, ln_mode, cross):
    """Against ``fused_attention(quant=True)`` in interpret mode; f32, C 64,
    2 heads, 16 / 8 tokens with a key mask. Bound 2e-2: the outputs are
    O(1) (post-LN) to O(3), one quantization step of a GEMM input is 1/127
    of its row amax, and the weights are N(0, 1/C)."""
    B, Nq, Nk, C, h = 2, 16, 8, 64, 2
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
    kw = dict(num_heads=h, ln_mode=ln_mode, include_residual=not cross,
              residual_from_raw=ln_mode == "pre")
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(jfa.fused_attention(
        jnp.asarray(x), *map(jnp.asarray, ln + w), kv=j(kv), key_mask=jnp.asarray(mask),
        pos=j(pos), alpha=j(alpha), interpret=True, quant=True, **kw))
    tw = [_t(a.T) if a.ndim == 2 else _t(a) for a in w]
    got = tfa.fused_attention(_t(x), *map(_t, ln), *tw, kv=None if kv is None else _t(kv),
                              key_mask=_t(mask), pos=None if pos is None else _t(pos),
                              alpha=None if alpha is None else torch.tensor(alpha),
                              quant=True, **kw).numpy()
    flt = tfa.attention_plain(_t(x), *map(_t, ln), *tw, kv=None if kv is None else _t(kv),
                              key_mask=_t(mask), pos=None if pos is None else _t(pos),
                              alpha=None if alpha is None else torch.tensor(alpha), **kw)
    _held(got, want, 2e-2, {"float": flt.numpy()})


# -- whole-block Swin, int8 -------------------------------------------------------


def _block(rng, C, hidden):
    """12 Flax-layout arrays in the JAX argument order (fused_swin_block)."""
    mk = lambda *s: (rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return [1.0 + 0.1 * mk(C), 0.1 * mk(C), mk(C, 3 * C) * C ** -0.5, 0.1 * mk(3 * C),
            mk(C, C) * C ** -0.5, 0.1 * mk(C), 1.0 + 0.1 * mk(C), 0.1 * mk(C),
            mk(C, hidden) * C ** -0.5, 0.1 * mk(hidden), mk(hidden, C) * hidden ** -0.5,
            0.1 * mk(C)]


def _port(blk):
    return [_t(a.T) if a.ndim == 2 else _t(a) for a in blk]


def _static(blk):
    """(JAX blk with int8 (K, N) weights, JAX scales, port blk with int8 (N, K)
    weights, port scales), quantized from the f32 weights."""
    jblk, tblk, js, ts = [jnp.asarray(a) for a in blk], _port(blk), [], []
    for i in tsb.GEMM_WEIGHTS:
        wq, s = jq.quantize_weight(jnp.asarray(blk[i]))
        jblk[i] = wq
        js.append(s.reshape(-1))
        tblk[i], sc = tq.quantize_weight(_t(blk[i].T))
        ts.append(sc)
    return jblk, tuple(js), tblk, tuple(ts)


def _case(rng, C=32, heads=2, H=14, shift=0, B=2):
    blk = _block(rng, C, 4 * C)
    table = (0.5 * rng.standard_normal(((2 * WS - 1) ** 2, heads))).astype(np.float32)
    jbias = jsb.build_bias_padded(jnp.asarray(table), WS, H, H, shift)
    tbias = build_bias_full(_t(table), WS, H, H, shift)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    return x, blk, jbias, tbias


# a whole block's outputs are O(4); a row's amax is O(4), so one step of a
# GEMM input is ~0.03 and meets weights of norm ~1: one such flip moved an
# output by up to 0.055 over three other seeds
BLOCK_TOL = 5e-2
# The port's int8 plain versions equal JAX's int8 kernels but for rare
# one-step flips, each of which moves a few outputs; a wrong int8 form moves
# nearly every output by the quantization noise, which is about as large as
# one flip. So besides the largest difference, hold the share of outputs more
# than SHARP apart to at most SHARE_MAX. At this file's seed the sound
# versions differ by at most 5e-7 (K3), 3.0e-3 with a share of 8e-4 (the
# blocks) and 2.6e-2 with a share of 0.037 (the pair, where a flip in the
# first block reaches a window of the second); three other seeds gave shares
# up to 0.066. The planted faults (the float plain version; the other kind of
# activation scale) gave shares of 0.66 to 0.98, and every one must fail.
SHARP = 1e-3
SHARE_MAX = 0.2


def _held(got, want, atol, faults):
    """``got`` within ``atol`` of ``want`` with at most SHARE_MAX of its
    elements more than SHARP away, where each of ``faults`` is not."""
    want = np.asarray(want)
    d = np.abs(got - want)
    share = float(np.mean(d > SHARP))
    assert d.max() <= atol and share <= SHARE_MAX, (d.max(), share)
    for name, f in faults.items():
        e = np.abs(f - want)
        assert e.max() > atol or np.mean(e > SHARP) > SHARE_MAX, (name, e.max())


@pytest.mark.parametrize("flavor", ["static_acts", "static_per_row", "dynamic"])
def test_windows_int8_matches_jax(rng, flavor):
    x, blk, jbias, tbias = _case(rng, 64, 2, H=14)
    xw = np.asarray(jwa.window_partition(jnp.asarray(x), WS))
    ref, amax = jsb.xla_equivalent(jnp.asarray(xw), *map(jnp.asarray, blk), jbias,
                                   num_heads=2, return_act_amax=True)
    faults = {"float": tsb.fused_swin_block_windows(_t(xw), *_port(blk), tbias, 2).numpy()}
    if flavor == "dynamic":
        want = jsb.fused_swin_block_windows(jnp.asarray(xw), *map(jnp.asarray, blk), jbias, 2,
                                            pad_gemm=True, quant=True, interpret=True)
        counter = "launches_dynamic"
        got = tsb.fused_swin_block_windows(_t(xw), *_port(blk), tbias, 2, quant=True)
    else:
        calibrated = tuple(float(a) / 127.0 for a in np.asarray(amax))
        acts = calibrated if flavor == "static_acts" else None
        jblk, js, tblk, ts = _static(blk)
        want = jsb.fused_swin_block_windows(jnp.asarray(xw), *jblk, jbias, 2, quant="static",
                                            wscales=js, act_scales=acts, interpret=True)
        counter = "launches_static" if acts else "launches_per_row"
        got = tsb.fused_swin_block_windows(_t(xw), *tblk, tbias, 2, quant="static",
                                           wscales=ts, act_scales=acts)
        faults["other scales"] = tsb.fused_swin_block_windows(
            _t(xw), *tblk, tbias, 2, quant="static", wscales=ts,
            act_scales=None if acts else calibrated).numpy()
    assert getattr(tsb.fused_swin_block_windows, counter) == 0  # CPU: the plain version
    _held(got.numpy(), want, BLOCK_TOL, faults)
    assert _cos(got.numpy().ravel(), np.asarray(ref).ravel()) > 0.999


def test_raw_dynamic_matches_jax(rng):
    x, blk, jbias, tbias = _case(rng, 64, 2, H=14, shift=3)
    xs = np.roll(x, (-3, -3), (1, 2))
    want = jsb.fused_swin_block_raw(jnp.asarray(xs), *map(jnp.asarray, blk), jbias, 2, WS,
                                    quant=True, interpret=True)
    got = tsb.fused_swin_block_raw(_t(xs), *_port(blk), tbias, 2, WS, quant=True)
    flt = tsb.fused_swin_block_raw(_t(xs), *_port(blk), tbias, 2, WS)
    _held(got.numpy(), want, BLOCK_TOL, {"float": flt.numpy()})


CHAIN_ACTS = (4.0 / 127, 4.0 / 127, 5.0 / 127, 3.0 / 127)


@pytest.mark.parametrize("roll_after", [-3, 3])
def test_chain_static_matches_jax(rng, roll_after):
    x, blk, jbias, tbias = _case(rng, 64, 2, shift=3 if roll_after > 0 else 0)
    jblk, js, tblk, ts = _static(blk)
    want = jsp.fused_swin_block_chain(jnp.asarray(x), jblk, jbias, 2, WS, roll_after,
                                      quant="static", wscales=js, act_scales=CHAIN_ACTS,
                                      interpret=True)

    def port(b, **q):
        return tsp.fused_swin_block_chain(_t(x), b, tbias, 2, WS, roll_after, **q).numpy()

    _held(port(tblk, quant="static", wscales=ts, act_scales=CHAIN_ACTS), want, BLOCK_TOL,
          {"float": port(_port(blk)), "per-row scales": port(tblk, quant="static", wscales=ts)})


def test_pair_static_matches_jax(rng):
    """Two blocks deep: the second block's inputs carry the first one's
    int8 rounding, so the bound is twice a block's."""
    x, blk0, jbias0, tbias0 = _case(rng, 64, 2, shift=0)
    _, blk1, jbias1, tbias1 = _case(rng, 64, 2, shift=3)
    j0, js0, t0, ts0 = _static(blk0)
    j1, js1, t1, ts1 = _static(blk1)
    want = jsp.fused_swin_block_pair(jnp.asarray(x), j0, jbias0, j1, jbias1, 2, WS, 3,
                                     quant="static", wscales0=js0, wscales1=js1,
                                     interpret=True)

    def port(b0, b1, **q):
        return tsp.fused_swin_block_pair(_t(x), b0, tbias0, b1, tbias1, 2, WS, 3, **q).numpy()

    _held(port(t0, t1, quant="static", wscales0=ts0, wscales1=ts1), want, 2 * BLOCK_TOL,
          {"float": port(_port(blk0), _port(blk1)),
           "static scales": port(t0, t1, quant="static", wscales0=ts0, wscales1=ts1,
                                 act_scales0=CHAIN_ACTS, act_scales1=CHAIN_ACTS)})


# -- routing under each precision -------------------------------------------------


def _flavors(cfg):
    return [[(s.route, s.quant) for s in steps] for steps in swin_plan(cfg)]


def test_swin_plan_under_each_precision():
    """Swin-B at 224 px. int8_static: the bf16 route's steps, each whole-block
    one static: the 1-byte gates let the pair fit at C 512, but pair_max_c
    256 keeps it off stage 3, and the chain's still fails at C 1024. int8:
    pair and chain off, every whole-block stage on windows, dynamic."""
    base = SwinConfig.base()
    stat = _flavors(dataclasses.replace(base, quant="int8_static"))
    assert stat == [[("k1k2", False)] * 2, [("pair", "static")], [("chain", "static")] * 18,
                    [("windows", "static")] * 2]
    dyn = _flavors(dataclasses.replace(base, quant="int8"))
    assert dyn == [[("k1k2", False)] * 2, [("windows", True)] * 2, [("windows", True)] * 18,
                   [("windows", True)] * 2]
    assert _flavors(base) == [[(r, False) for r, _ in st] for st in stat]
    # the gates at 1-byte weights, against JAX's
    stages = ((256, 28, 8), (512, 14, 16), (1024, 7, 32))
    for fn_t, fn_j in ((tsp.pair_vmem_ok, jsp.pair_vmem_ok), (tsp.chain_vmem_ok,
                                                              jsp.chain_vmem_ok)):
        assert [fn_t(C, r, r, h, 7, weight_bytes=1) for C, r, h in stages] == \
            [fn_j(C, r, r, h, 7, weight_bytes=1) for C, r, h in stages]
    assert tsp.pair_vmem_ok(512, 14, 14, 16, 7, weight_bytes=1)
    assert not tsp.chain_vmem_ok(1024, 7, 7, 32, 7, weight_bytes=1)
    with pytest.raises(ValueError, match="quant"):
        swin_plan(dataclasses.replace(base, quant="int4"))


# -- calibration ------------------------------------------------------------------

SWIN = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2))


def randomize(params, seed=0):
    """Every leaf + N(0, 0.02^2); ``alpha`` (zero at init) -> 0.5 + N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.02
        if getattr(path[-1], "key", None) == "alpha":
            return jnp.asarray(0.5 + noise)
        return jnp.asarray(np.asarray(leaf) + noise)

    return jax.tree_util.tree_map_with_path(move, params)


@pytest.fixture(scope="module")
def swin_params():
    img = np.random.default_rng(3).random((4, 56, 56, 3), dtype=np.float32)
    jmodel = jswin.SwinEncoder(jswin.SwinConfig(**SWIN))
    return randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(img))["params"]), \
        img


def test_calibration_matches_jax(swin_params, tmp_path):
    """The port's plain f32 forward against the JAX calibration (its XLA
    formulation under ``force_core(False)``) on the same weights and images,
    rtol 2e-3 as the JAX package's own check (``test_quant_static.py``);
    then the swin_act_amax_v1 file in both directions."""
    params, img = swin_params
    want = jqc.calibrate_swin_act_amax(jswin.SwinConfig(**SWIN), params, img, batch_size=2)
    enc = SwinEncoder(SwinConfig(**SWIN), device="cpu")
    load_flax_params(enc, params)
    got = tqc.calibrate_swin_act_amax(enc, img, batch_size=2)
    assert len(got) == 4 and all(len(row) == 4 for row in got)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-3)
    tqc.save_act_amax(str(tmp_path / "t.json"), got)
    assert jqc.load_act_amax(str(tmp_path / "t.json")) == got
    jqc.save_act_amax(str(tmp_path / "j.json"), want)
    assert tqc.load_act_amax(str(tmp_path / "j.json")) == want
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "other", "blocks": []}))
    with pytest.raises(ValueError, match="swin_act_amax_v1"):
        tqc.load_act_amax(str(bad))
    with pytest.raises(ValueError, match="recalibrate"):
        SwinEncoder(SwinConfig(**SWIN, quant="int8_static", act_amax=got[:3]), device="cpu")


# -- the text encoder's quant modes ----------------------------------------------


@pytest.fixture()
def kernel_route(monkeypatch):
    """The JAX kernel routes (interpret mode), with the whole-block width
    gates lowered to the tiny Swin's 16 (the port's ``whole_min_c=16``)."""
    for key, val in (("MMRP_FORCE_PALLAS", "1"), ("MMRP_SWIN_WHOLE_MINC", "16"),
                     ("MMRP_SWIN_PAD_MINC", "16")):
        monkeypatch.setenv(key, val)
    for key in ("MMRP_SWIN_WHOLE", "MMRP_SWIN_CHAIN", "MMRP_SWIN_PAIR", "MMRP_SWIN_RAW"):
        monkeypatch.delenv(key, raising=False)


TEXT = dict(hidden_dim=32, num_layers=2, num_heads=2, intermediate_dim=64)


@pytest.mark.parametrize("quant", ["none", "int8", "int8_ffn", "int8_kernel"])
def test_text_quant_modes_match_jax(rng, kernel_route, quant):
    """Two post-LN layers; bound 3e-2 on outputs of O(1) (post-LN): a few
    activation steps through two layers."""
    ids = rng.integers(0, 8192, (2, 16)).astype(np.int32)
    mask = (np.arange(16)[None, :] < np.array([16, 9])[:, None]).astype(np.int32)
    jmodel = jtext.TextEncoder(jtext.TextConfig.small(dropout=0.0, quant=quant, **TEXT))
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                            jnp.asarray(mask))["params"], seed=1)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    tmodel = TextEncoder(TextConfig.small(quant=quant, **TEXT), device="cpu")
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got["tokens"].numpy(), np.asarray(want["tokens"]), rtol=0,
                               atol=3e-2 if quant != "none" else 1e-4)


# -- the serving forward at int8_static and int8 -----------------------------------

HEAD = dict(joint_dim=64, num_fusion_layers=2, num_heads=4, num_classes=7, max_text_len=16)
KEYS = ("probs", "joint_emb", "img_emb", "txt_emb")


def _inputs(B=2, L=16, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((B, 56, 56, 3), dtype=np.float32)
    ids = rng.integers(0, 8192, (B, L)).astype(np.int32)
    mask = (np.arange(L)[None, :] < np.array([L, 9])[:, None]).astype(np.int32)
    return img, ids, mask


@pytest.fixture(scope="module")
def mm_params(swin_params):
    """JAX multimodal params (float) and the calibrated act_amax of its Swin."""
    jcfg = jmm.MultiModalConfig(swin=jswin.SwinConfig(**SWIN),
                                text=jtext.TextConfig.small(dropout=0.0, **TEXT),
                                dropout=0.0, drop_path=0.0, **HEAD)
    img, ids, mask = _inputs()
    params = randomize(jax.jit(jmm.MultiModalRetrievalModel(jcfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(ids), jnp.asarray(mask))["params"])
    amax = jqc.calibrate_swin_act_amax(jswin.SwinConfig(**SWIN), params["backbones"]["swin"],
                                       swin_params[1], batch_size=2)
    return params, amax


# the Swin tower's config of each serving mix: "int8_static" with the
# calibrated act_amax, "int8_static_per_row" without a calibration file
# (per-row activation scales), "int8" and "none" in bf16
def _swin_quant(mix, amax):
    return {"int8_static": {"quant": "int8_static", "act_amax": amax},
            "int8_static_per_row": {"quant": "int8_static", "act_amax": None}}.get(mix, {})


def _port_model(mix, amax, whole_min_c=16):
    swin = SwinConfig(**SWIN, whole_min_c=whole_min_c, **_swin_quant(mix, amax))
    tq_ = "int8_kernel" if mix != "none" else "none"
    return MultiModalRetrievalModel(MultiModalConfig(
        swin=swin, text=TextConfig.small(quant=tq_, **TEXT),
        quant="int8" if mix != "none" else "none", **HEAD), device="cpu").eval()


def _run_port(model, img, ids, mask):
    out = serving_forward(model)(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("mix", ["int8_static", "int8", "int8_static_per_row"])
def test_serving_forward_int8_matches_jax(mm_params, kernel_route, mix):
    """The JAX serve_quant mixes (Swin static int8 on pair and chain, with the
    calibrated act_amax or, without a calibration file, per-row activation
    scales, or bf16; BERT int8_kernel; the fusion stack int8) against the
    port with the same params and act_amax. Bounds: 2e-3 on probs and 1e-2
    on embeddings of O(1), a few activation steps through the stack; cosine
    > 0.9999."""
    params, amax = mm_params
    jswin_cfg = jswin.SwinConfig(**SWIN, **_swin_quant(mix, amax))
    jcfg = jmm.MultiModalConfig(
        swin=jswin_cfg, text=jtext.TextConfig.small(dropout=0.0, quant="int8_kernel", **TEXT),
        dropout=0.0, drop_path=0.0, quant="int8", **HEAD)
    img, ids, mask = _inputs()
    from mmrp_tpu.api import serving_forward as jax_serving_forward

    want = jax.jit(jax_serving_forward(jmm.MultiModalRetrievalModel(jcfg)))(
        params, jnp.asarray(img), jnp.asarray(ids), jnp.asarray(mask))
    model = _port_model(mix, amax)
    load_flax_params(model, params)
    pair = tsp.fused_swin_block_pair
    before = (pair.launches_static, pair.launches_per_row, tfa.fused_attention.launches_int8)
    got = _run_port(model, img, ids, mask)
    assert (pair.launches_static, pair.launches_per_row,
            tfa.fused_attention.launches_int8) == before  # CPU: plain versions
    for key in KEYS:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=0, atol=2e-3 if key == "probs" else 1e-2,
                                   err_msg=key)
        assert _cos(got[key], w).min() > 0.9999, key


def test_int8_embedding_close_to_float(mm_params):
    """The JAX gate (``tests/test_quant_model.py``): int8 joint embeddings
    keep cosine > 0.995 against the f32 unquantized path, on every mix."""
    params, amax = mm_params
    img, ids, mask = _inputs()
    ref = _port_model("none", amax)
    load_flax_params(ref, params)
    want = _run_port(ref, img, ids, mask)["joint_emb"]
    for mix in ("int8_static", "int8", "int8_static_per_row"):
        model = _port_model(mix, amax)
        load_flax_params(model, params)
        assert _cos(_run_port(model, img, ids, mask)["joint_emb"], want).min() > 0.995, mix


def test_from_config_maps_serve_quant(tmp_path):
    amax = tuple((4.0, 3.0, 6.0, 5.0) for _ in range(24))
    path = tmp_path / "amax.json"
    tqc.save_act_amax(str(path), amax)
    mm = MultiModalConfig.from_config(Config(serve_quant="int8_static",
                                             swin_act_amax_path=str(path)), flagship=True)
    assert (mm.swin.quant, mm.swin.act_amax, mm.text.quant, mm.quant) == \
        ("int8_static", amax, "int8_kernel", "int8")
    assert mm.swin == SwinConfig.base(quant="int8_static", act_amax=amax)
    assert mm.text == TextConfig.clinicalbert(quant="int8_kernel")
    mm = MultiModalConfig.from_config(Config(serve_quant="int8_static",
                                             image_backbone="swin_micro", image_size=28),
                                      num_classes=7)
    assert mm.swin == SwinConfig.micro(quant="int8_static") and mm.num_classes == 7
    assert (mm.text.quant, mm.text.hidden_dim) == ("int8_kernel", 32)
    mm = MultiModalConfig.from_config(Config(serve_quant="int8"))  # Swin-B, TextConfig.small
    assert (mm.swin, mm.text.quant, mm.quant, mm.text.hidden_dim) == \
        (SwinConfig.base(), "int8_kernel", "int8", 256)
    assert MultiModalConfig.from_config(Config(), flagship=True) == MultiModalConfig.flagship()
    with pytest.raises(ValueError, match="serve_quant"):
        MultiModalConfig.from_config(Config(serve_quant="int4"))


def test_int8_caches_follow_the_jax_sources(mm_params):
    """Loaded from a JAX tree into a bf16 model: the static Swin and
    quant_dot caches are quantized from the tree's f32 arrays (the JAX
    ``build_quant_cache`` / ``quant_dot``), K3's from the bf16 weights the
    kernel receives (``_qdot``); init_params and MMRPredictor keep them."""
    from mmrp_tpu_torch.api import MMRPredictor
    from mmrp_tpu_torch.utils.convert import init_params

    params, amax = mm_params
    swin = SwinConfig(**SWIN, whole_min_c=16, quant="int8_static", act_amax=amax)
    model = MultiModalRetrievalModel(MultiModalConfig(
        swin=swin, text=TextConfig.small(quant="int8_kernel", **TEXT), quant="int8", **HEAD),
        dtype=torch.bfloat16, device="cpu")
    load_flax_params(model, params)
    qkv = params["backbones"]["swin"]["stage0_block0"]["attn"]["qkv"]["kernel"]
    lin = model.backbones.swin.stage0_block0.attn.qkv
    np.testing.assert_array_equal(lin.weight_q.numpy(),
                                  np.asarray(jq.quantize_weight(qkv)[0]).T)
    w1 = params["fusion_layer0"]["ffn"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(model.fusion_layer0.ffn.Dense_0.weight_q.numpy(),
                                  np.asarray(jq.quantize_weight(w1)[0]).T)
    wq = params["backbones"]["text"]["layer0"]["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(
        model.backbones.text.layer0.attention.query.weight_q.numpy(),
        np.asarray(jq.quantize_weight(jnp.asarray(wq, jnp.bfloat16))[0]).T)
    cached = lin.weight_q.clone()
    MMRPredictor(model, ["a"] * 7)  # current caches are kept
    assert torch.equal(lin.weight_q, cached)
    init_params(model, seed=1)  # new weights: every cache follows
    assert not torch.equal(lin.weight_q, cached)
    torch.testing.assert_close(lin.weight_q, tq.quantize_weight(lin.weight)[0], rtol=0, atol=0)
