"""Whole-block Swin ops of the port against the JAX ops they replace, on the CPU.

``mmrp_tpu_torch.ops.fused_swin_block`` (windows, raw) and
``mmrp_tpu_torch.ops.fused_swin_pair`` (chain, pair): on a CPU tensor each
wrapper runs its plain-PyTorch version, held here against the Pallas kernel
in interpret mode and against its XLA oracle (``xla_equivalent``,
``_xla_chain``, ``_xla_pair``) on the same float32 inputs, made with numpy
from a seed. JAX gets the Flax-layout weights, the port the same weights
transposed to the nn.Linear layout.

Tolerance 2e-4 in f32, the JAX package's own for these kernels
(``tests/test_fused_swin_chain.py``): both sides compute the same function,
differing in the order of f32 sums and the LayerNorm's internal formula.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.ops import fused_swin_block as jsb
from mmrp_tpu.ops import fused_swin_pair as jsp
from mmrp_tpu.ops import window_attention as jwa
from mmrp_tpu_torch.ops import fused_swin_block as tsb
from mmrp_tpu_torch.ops import fused_swin_pair as tsp
from mmrp_tpu_torch.ops.fused_window_attention import build_bias_full

TOL = dict(rtol=2e-4, atol=2e-4)
WS = 7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _block(rng, C, hidden):
    """12 Flax-layout arrays in the JAX argument order (fused_swin_block)."""
    mk = lambda *s: (rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return [
        1.0 + 0.1 * mk(C), 0.1 * mk(C),                    # ln0
        mk(C, 3 * C) * C ** -0.5, 0.1 * mk(3 * C),         # qkv
        mk(C, C) * C ** -0.5, 0.1 * mk(C),                 # proj
        1.0 + 0.1 * mk(C), 0.1 * mk(C),                    # ln1
        mk(C, hidden) * C ** -0.5, 0.1 * mk(hidden),       # mlp1
        mk(hidden, C) * hidden ** -0.5, 0.1 * mk(C),       # mlp2
    ]


def _port(blk, dtype=torch.float32):
    """Flax (in, out) kernels -> nn.Linear (out, in); LN params stay f32."""
    out = []
    for i, a in enumerate(blk):
        t = _t(a.T if a.ndim == 2 else a)
        out.append(t if i in (0, 1, 6, 7) else t.to(dtype))
    return out


def _case(rng, C=32, heads=2, H=14, shift=0, B=2):
    """(x map, Flax block, relative-bias table, JAX padded bias, port bias)."""
    blk = _block(rng, C, 4 * C)
    table = (0.5 * rng.standard_normal(((2 * WS - 1) ** 2, heads))).astype(np.float32)
    jbias = jsb.build_bias_padded(jnp.asarray(table), WS, H, H, shift)
    tbias = build_bias_full(_t(table), WS, H, H, shift)
    x = rng.standard_normal((B, H, H, C)).astype(np.float32)
    return x, blk, jbias, tbias


def _j(blk):
    return [jnp.asarray(a) for a in blk]


# -- windows and raw -----------------------------------------------------------


@pytest.mark.parametrize("C,heads,shift,pad_gemm", [
    (32, 2, 0, False), (32, 2, 3, False), (64, 4, 3, True)])
def test_windows_matches_jax(rng, C, heads, shift, pad_gemm):
    x, blk, jbias, tbias = _case(rng, C, heads, shift=shift)
    xw = np.asarray(jwa.window_partition(jnp.roll(jnp.asarray(x), (-shift, -shift), (1, 2)),
                                         WS))
    oracle = np.asarray(jsb.xla_equivalent(jnp.asarray(xw), *_j(blk), jbias, num_heads=heads))
    kernel = np.asarray(jsb.fused_swin_block_windows(
        jnp.asarray(xw), *_j(blk), jbias, heads, pad_gemm=pad_gemm, interpret=True))
    before = tsb.fused_swin_block_windows.launches
    got = tsb.fused_swin_block_windows(_t(xw), *_port(blk), tbias, heads).numpy()
    assert tsb.fused_swin_block_windows.launches == before  # CPU: plain version
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_raw_matches_jax(rng, shift):
    x, blk, jbias, tbias = _case(rng, 32, 2, shift=shift)
    xs = np.roll(x, (-shift, -shift), (1, 2))  # the caller pre-rolls
    kernel = np.asarray(jsb.fused_swin_block_raw(jnp.asarray(xs), *_j(blk), jbias, 2, WS,
                                                 interpret=True))
    before = tsb.fused_swin_block_raw.launches
    got = tsb.fused_swin_block_raw(_t(xs), *_port(blk), tbias, 2, WS).numpy()
    assert tsb.fused_swin_block_raw.launches == before
    oracle = np.asarray(jwa.window_reverse(jsb.xla_equivalent(
        jwa.window_partition(jnp.asarray(xs), WS), *_j(blk), jbias, num_heads=2), WS, 14, 14))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


def test_windows_bf16_matches_xla_equivalent(rng):
    """The working dtype: both sides round qkv, p, the attention output,
    LN1(y) and the GELU output to bf16 at the same places and keep y in f32,
    but sum in other orders, so an intermediate can round one bf16 ulp
    apart (2^-8 relative) and carry that through the next GEMM. Outputs are
    of magnitude ~4, where one ulp is 2^-6; the bound is two such ulps plus
    2^-6 relative."""
    x, blk, jbias, tbias = _case(rng, 64, 2, shift=3)
    xw = np.asarray(jwa.window_partition(jnp.asarray(x), WS))
    jblk = [jnp.asarray(a, jnp.float32 if i in (0, 1, 6, 7) else jnp.bfloat16)
            for i, a in enumerate(blk)]
    want = np.asarray(jsb.xla_equivalent(jnp.asarray(xw, jnp.bfloat16), *jblk, jbias,
                                         num_heads=2).astype(jnp.float32))
    got = tsb.fused_swin_block_windows(_t(xw, torch.bfloat16), *_port(blk, torch.bfloat16),
                                       tbias, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -6, atol=2.0 ** -5)


# -- chain and pair ------------------------------------------------------------


@pytest.mark.parametrize("roll_after", [-3, 0, 3])
def test_chain_matches_jax(rng, roll_after):
    x, blk, jbias, tbias = _case(rng, 32, 2, shift=3 if roll_after > 0 else 0)
    oracle = np.asarray(jsp._xla_chain(jnp.asarray(x), _j(blk), jbias, num_heads=2, eps=1e-6,
                                       ws=WS, roll_after=roll_after))
    kernel = np.asarray(jsp.fused_swin_block_chain(jnp.asarray(x), _j(blk), jbias, 2, WS,
                                                   roll_after, interpret=True))
    before = tsp.fused_swin_block_chain.launches
    got = tsp.fused_swin_block_chain(_t(x), _port(blk), tbias, 2, WS, roll_after).numpy()
    assert tsp.fused_swin_block_chain.launches == before
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("C,heads", [(32, 2), (64, 4)])
def test_pair_matches_jax(rng, C, heads):
    x, blk0, jbias0, tbias0 = _case(rng, C, heads, shift=0)
    _, blk1, jbias1, tbias1 = _case(rng, C, heads, shift=3)
    oracle = np.asarray(jsp._xla_pair(jnp.asarray(x), _j(blk0), jbias0, _j(blk1), jbias1,
                                      num_heads=heads, eps=1e-6, ws=WS, shift=3))
    kernel = np.asarray(jsp.fused_swin_block_pair(jnp.asarray(x), _j(blk0), jbias0, _j(blk1),
                                                  jbias1, heads, WS, 3, interpret=True))
    before = tsp.fused_swin_block_pair.launches
    got = tsp.fused_swin_block_pair(_t(x), _port(blk0), tbias0, _port(blk1), tbias1, heads,
                                    WS, 3).numpy()
    assert tsp.fused_swin_block_pair.launches == before
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


def test_pair_is_two_chain_steps(rng):
    """The pair's two launches are chain steps with roll_after -s and +s."""
    x, blk0, _, tbias0 = _case(rng, 32, 2, shift=0)
    _, blk1, _, tbias1 = _case(rng, 32, 2, shift=3)
    b0, b1 = _port(blk0, torch.bfloat16), _port(blk1, torch.bfloat16)
    xb = _t(x, torch.bfloat16)
    y = tsp.fused_swin_block_chain(xb, b0, tbias0, 2, WS, -3)
    want = tsp.fused_swin_block_chain(y, b1, tbias1, 2, WS, 3)
    got = tsp.fused_swin_block_pair(xb, b0, tbias0, b1, tbias1, 2, WS, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- routing gates and dispatch ------------------------------------------------


def test_vmem_gates_equal_jax():
    """The copied gates give JAX's answer on a grid of geometries, and at
    the Swin-B stages at 224 px: the pair fits at C = 256 only, the chain at
    every stage but C = 1024 (stage 1 is below ``whole_min_c`` anyway)."""
    for C in (16, 32, 64, 128, 256, 512, 1024):
        for res in (7, 14, 28, 56):
            for heads in (1, 2, 4, 8, 16, 32):
                for wb in (1, 2):
                    args = (C, res, res, heads, 7)
                    assert tsp.pair_vmem_ok(*args, weight_bytes=wb) == \
                        jsp.pair_vmem_ok(*args, weight_bytes=wb), (args, wb)
                    assert tsp.chain_vmem_ok(*args, weight_bytes=wb) == \
                        jsp.chain_vmem_ok(*args, weight_bytes=wb), (args, wb)
    stages = ((128, 56, 4), (256, 28, 8), (512, 14, 16), (1024, 7, 32))
    assert [tsp.pair_vmem_ok(C, r, r, h, 7) for C, r, h in stages] == [False, True, False, False]
    assert [tsp.chain_vmem_ok(C, r, r, h, 7) for C, r, h in stages] == [True, True, True, False]


@pytest.mark.parametrize("flavor", ["windows", "raw", "chain", "pair"])
def test_wrappers_refuse_devices_without_a_kernel(flavor):
    C = 64
    x = torch.empty((1, 7, 7, C), device="meta", dtype=torch.bfloat16)
    blk = [torch.empty(s, device="meta") for s in
           ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,), (C,), (C,),
            (4 * C, C), (4 * C,), (C, 4 * C), (C,))]
    bias = torch.empty((1, 2, 49, 49), device="meta")
    calls = {
        "windows": lambda: tsb.fused_swin_block_windows(x.reshape(1, 1, 49, C), *blk, bias, 2),
        "raw": lambda: tsb.fused_swin_block_raw(x, *blk, bias, 2, WS),
        "chain": lambda: tsp.fused_swin_block_chain(x, blk, bias, 2, WS, 0),
        "pair": lambda: tsp.fused_swin_block_pair(x, blk, bias, blk, bias, 2, WS, 3),
    }
    with pytest.raises(ValueError, match="no kernel for meta"):
        calls[flavor]()
