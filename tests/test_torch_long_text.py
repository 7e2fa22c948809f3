"""Text past 64 tokens: K3's plain version and the slice against JAX, on the CPU.

The CUDA K3 takes 1 to 512 tokens per sequence (the model's positions), in
64-wide attention tiles. Here, at 136 tokens (a multiple of 8, as the JAX
kernel needs, and two full tiles plus a ragged one) and in cross shapes with
the 49 image tokens, the plain version the wrapper runs on the CPU is held
to the JAX ``xla_equivalent`` and to the Pallas kernel in interpret mode,
with one sequence's keys masked entirely; and :func:`tile_walk_plain`, the
CUDA tile's walk over key tiles with its rounding points, is held to the
plain softmax, with two planted faults that a wrong tile could hide. Then
the text encoder and ``serving_forward`` of the tiny model at text length
128 against JAX with ``MMRP_FORCE_PALLAS=1``.

Tolerances: f32 1e-5 (the same arithmetic, sums in other orders); bf16 and
W8A8 below, each with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.models import text_encoder as jtext
from mmrp_tpu.ops import fused_attention as jfa
from mmrp_tpu_torch.models import text_encoder as ttext
from mmrp_tpu_torch.ops import fused_attention as tfa

from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.utils.convert import load_flax_params

from test_torch_models import load, randomize
from test_torch_quant import _held
from test_torch_slice import HEAD, ROUTES, TEXT, inputs, run_jax, run_port

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs and weights on both sides: the same rounding points, but an f32
# sum in another order can round a bf16 intermediate (q/k/v, p, the context)
# one ulp apart, which moves an O(1..4) output by an ulp or two (2^-7 each)
BF16_ATOL = 2.0 ** -5
# W8A8 against the Pallas kernel: the same int8 products, but a GEMM input a
# rounding apart lands one int8 step (1/127 of its row's amax) away; held as
# tests/test_torch_quant.py holds K3's W8A8 form (largest difference and the
# share of outputs more than 1e-3 apart), and the float form must break it
INT8_ATOL = 2e-2
C, H = 32, 2  # width and heads: head dim 16


def _inputs(rng, B, Nq, Nk, cross, ln_mode, dtype=np.float32):
    """x, kv, a key mask with sequence 0 masked entirely (others 30%, key 0
    kept), pos / alpha for the pre form, LN params and four Flax (in, out)
    dense layers."""
    x = rng.standard_normal((B, Nq, C)).astype(np.float32)
    kv = rng.standard_normal((B, Nk, C)).astype(np.float32) if cross else None
    mask = np.where(rng.random((B, Nk)) < 0.3, -1e9, 0.0).astype(np.float32)
    mask[:, 0] = 0.0
    mask[0] = -1e9
    pos = (0.5 * rng.standard_normal((Nq, C))).astype(np.float32) if ln_mode == "pre" else None
    alpha = np.float32(0.37) if ln_mode == "pre" else None
    ln = [(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
          (0.1 * rng.standard_normal(C)).astype(np.float32)]
    w = []
    for _ in range(4):
        w += [(rng.standard_normal((C, C)) * C ** -0.5).astype(np.float32),
              (0.1 * rng.standard_normal(C)).astype(np.float32)]
    flags = dict(num_heads=H, ln_mode=ln_mode, include_residual=not cross,
                 residual_from_raw=ln_mode == "pre")
    return x, kv, mask, pos, alpha, ln, w, flags


def _port(x, kv, mask, pos, alpha, ln, w, flags, dtype=torch.float32, **kw):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    tw = [t(a.T.copy()) if a.ndim == 2 else t(a) for a in w]
    return tfa.fused_attention(
        t(x), *(torch.from_numpy(a) for a in ln), *tw, kv=t(kv),
        key_mask=torch.from_numpy(mask), pos=t(pos),
        alpha=None if alpha is None else torch.tensor(alpha), **flags, **kw).float().numpy()


def _jax(x, kv, mask, pos, alpha, ln, w, flags, dtype=jnp.float32, kernel=False, **kw):
    j = lambda a: None if a is None else jnp.asarray(a, dtype)  # noqa: E731
    jw = [j(a) for a in w]
    if kernel:
        out = jfa.fused_attention(j(x), *map(jnp.asarray, ln), *jw, kv=j(kv),
                                  key_mask=jnp.asarray(mask), pos=j(pos),
                                  alpha=None if alpha is None else jnp.asarray(alpha),
                                  img_block=2, interpret=True, **flags, **kw)
    else:
        out = jfa.xla_equivalent(j(x), j(kv), jnp.asarray(mask), *map(jnp.asarray, ln), *jw,
                                 pos=j(pos), alpha=None if alpha is None else jnp.asarray(alpha),
                                 **flags)
    return np.asarray(out.astype(jnp.float32))


def test_seq_attention_at_136_tokens_matches_the_pallas_kernel(rng):
    """Self-attention, post-LN (the BERT form), 136 tokens: the plain version
    against the Pallas kernel in interpret mode and its XLA oracle."""
    case = _inputs(rng, 2, 136, 136, False, "post")
    got = _port(*case)
    np.testing.assert_allclose(got, _jax(*case), **F32_TOL)
    np.testing.assert_allclose(got, _jax(*case, kernel=True), **F32_TOL)
    # the fully masked sequence averages its values: finite, and not its neighbour's
    assert np.isfinite(got).all() and not np.allclose(got[0], got[1], atol=1e-2)


# (ln_mode, cross, Nq, Nk): the text enhancer, then the cross shapes of the
# fusion stack at 136 text tokens (text <- image, image <- text), each form
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ln_mode,cross,Nq,Nk", [
    ("pre", False, 136, 136), ("post", True, 136, 49), ("post", True, 49, 136),
    ("none", True, 136, 49), ("none", True, 49, 136)])
def test_seq_attention_long_and_cross_match_jax(rng, dtype, ln_mode, cross, Nq, Nk):
    case = _inputs(rng, 2, Nq, Nk, cross, ln_mode)
    if dtype == "f32":
        np.testing.assert_allclose(_port(*case), _jax(*case), **F32_TOL)
    else:
        got, want = _port(*case, dtype=torch.bfloat16), _jax(*case, dtype=jnp.bfloat16)
        np.testing.assert_allclose(got, want, rtol=BF16_ATOL, atol=BF16_ATOL)


# The JAX kernel takes token counts in multiples of 8: the JAX model pads the
# 49 image tokens to 56, so the W8A8 cross shapes run at 56
@pytest.mark.parametrize("ln_mode,cross,Nq,Nk", [
    ("post", False, 136, 136), ("post", True, 136, 56), ("none", True, 56, 136)])
def test_seq_attention_int8_long_matches_the_pallas_kernel(rng, ln_mode, cross, Nq, Nk):
    case = _inputs(rng, 2, Nq, Nk, cross, ln_mode)
    _held(_port(*case, quant=True), _jax(*case, kernel=True, quant=True), INT8_ATOL,
          {"float": _port(*case)})


def _softmax_plain(q, k, v, mask):
    """attention_plain's attention: f32 scores + mask, softmax over exactly
    Nk keys, the normalized p rounded to the input dtype, P.V in f32."""
    s = q.float() @ k.float().transpose(-1, -2) * q.shape[-1] ** -0.5
    s = s + mask[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def test_tile_walk_matches_the_plain_softmax(rng):
    """The CUDA tile's walk (64-key tiles, online softmax, unnormalized p
    rounded to bf16) against the plain softmax at 136 keys, bf16, sequence 0
    fully masked: within 2^-7 relative (the two round p at different points,
    each to a bf16 ulp). Two tiles that would look right elsewhere break it:
    the last tile padded to 192 keys with -1e9 (the fully masked sequence
    then averages pad values too), and scores rounded to bf16 before the
    exponential."""
    B, h, N, d = 2, 2, 136, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, N, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.from_numpy(np.where(rng.random((B, N)) < 0.3, -1e9, 0.0).astype(np.float32))
    mask[0] = -1e9
    want = _softmax_plain(q, k, v, mask).float()

    def rel(got):
        return ((got.float() - want).abs() / want.abs().clamp(min=1.0)).max().item()

    bound = 2.0 ** -7
    assert rel(tfa.tile_walk_plain(q, k, v, mask)) <= bound
    zeros = torch.zeros((B, h, 192 - N, d), dtype=q.dtype)
    padded = tfa.tile_walk_plain(torch.cat([q, zeros], 2)[:, :, :N], torch.cat([k, zeros], 2),
                                 torch.cat([v, zeros], 2),
                                 torch.cat([mask, torch.full((B, 192 - N), -1e9)], 1))
    assert rel(padded) > bound
    assert rel(_walk_rounding_scores(q, k, v, mask)) > bound


def _walk_rounding_scores(q, k, v, mask):
    """tile_walk_plain with the scores rounded to bf16 before the softmax."""
    m = torch.full(q.shape[:3] + (1,), -torch.inf)
    l, o = torch.zeros_like(m), torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], tfa.TILE):
        s = q.float() @ k[:, :, k0:k0 + tfa.TILE].float().transpose(-1, -2) * q.shape[-1] ** -0.5
        s = (s + mask[:, None, None, k0:k0 + tfa.TILE]).to(torch.bfloat16).float()
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        l = l * torch.exp(m - m_new) + p.sum(-1, keepdim=True)
        o = o * torch.exp(m - m_new) + p.to(q.dtype).float() @ v[:, :, k0:k0 + tfa.TILE].float()
        m = m_new
    return (o / l).to(q.dtype)


def test_text_encoder_at_128_tokens_matches_jax(rng, monkeypatch):
    """One post-LN layer at 128 tokens, ragged masks, against the JAX encoder
    with its K3 (``MMRP_FORCE_PALLAS=1``, interpret mode)."""
    kw = dict(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64, max_positions=128)
    ids = rng.integers(0, 8192, (2, 128)).astype(np.int32)
    mask = (np.arange(128)[None, :] < np.array([128, 71])[:, None]).astype(np.int32)
    jmodel = jtext.TextEncoder(jtext.TextConfig.small(dropout=0.0, **kw))
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                            jnp.asarray(mask))["params"], seed=4)
    monkeypatch.setenv("MMRP_FORCE_PALLAS", "1")
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    tmodel = load(ttext.TextEncoder(ttext.TextConfig.small(**kw), device="cpu"), params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for key in ("tokens", "cls"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_serving_forward_at_128_tokens_matches_jax(monkeypatch):
    """A tiny multimodal model (one 28 px Swin stage, one BERT layer, one
    fusion layer, text positions 128) at text length 128 against JAX on the
    slice route (``MMRP_FORCE_PALLAS=1``, ``MMRP_SWIN_WHOLE=0``); tolerance
    as tests/test_torch_slice.py's."""
    head = dict(HEAD, num_fusion_layers=1, max_text_len=128)
    jcfg = jmm.MultiModalConfig(swin=JSwinConfig.micro(), text=jtext.TextConfig.small(
        dropout=0.0, **TEXT), dropout=0.0, drop_path=0.0, **head)
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    img, ids, mask = inputs(L=128)
    img = np.ascontiguousarray(img[:, :28, :28])
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(img),
                                            jnp.asarray(ids), jnp.asarray(mask))["params"],
                       seed=5)
    tmodel = MultiModalRetrievalModel(MultiModalConfig(
        swin=SwinConfig.micro(), text=ttext.TextConfig.small(**TEXT), **head), device="cpu")
    load_flax_params(tmodel, params)
    for key, val in ROUTES["slice"][0].items():
        monkeypatch.setenv(key, val)
    want = run_jax(jmodel, params, img, ids, mask)
    # the port's default Swin plan runs a stage this narrow on K1 + K2: the slice route
    got = run_port(tmodel.eval(), img, ids, mask)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=5e-4, atol=5e-4, err_msg=key)
