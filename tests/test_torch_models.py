"""Port models (mmrp_tpu_torch.models) against the JAX models, on the CPU.

Parameters come from ``model.init`` on the CPU, then every leaf is moved by
normal x 0.02 (so biases, LN offsets and the enhancers' ``alpha`` are
nonzero and their branches are tested), and go through the Flax -> torch
bridge. Inputs are numpy from a seed; both sides run in float32.

The JAX side runs on its XLA path and on the kernel route of the serving
slice (``MMRP_FORCE_PALLAS=1``, ``MMRP_SWIN_WHOLE=0``: the Pallas kernels in
interpret mode); the Swin encoder also on the whole-block routes
(``MMRP_SWIN_WHOLE_MINC=16``: pair, then chain or windows). Tolerance 1e-4:
a few layers of f32 arithmetic that differ in the order of sums and in the
LayerNorm variance form (Flax's one-pass E[x^2] - E[x]^2 against the port's
two-pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.models import fusion as jfusion
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models import swin as jswin
from mmrp_tpu.models import text_encoder as jtext
from mmrp_tpu_torch.models import multimodal as tmm
from mmrp_tpu_torch.models import swin as tswin
from mmrp_tpu_torch.models import text_encoder as ttext
from mmrp_tpu_torch.models.layers import ln_f32, sinusoidal_positions
from mmrp_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(params, seed=0):
    """Every leaf + N(0, 0.02^2); ``alpha`` (zero at init) -> 0.5 + N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        noise = rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.02
        if getattr(path[-1], "key", None) == "alpha":
            return jnp.asarray(0.5 + noise)
        return jnp.asarray(np.asarray(leaf) + noise)

    return jax.tree_util.tree_map_with_path(move, params)


def load(module, params):
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.eval()


# JAX environment of each kernel route, and the port SwinConfig fields that match it
ROUTE_ENV = {
    "slice": ({"MMRP_SWIN_WHOLE": "0"}, {"whole_block": False}),
    "whole": ({"MMRP_SWIN_WHOLE_MINC": "16"}, {"whole_min_c": 16}),
    "whole_nochain": ({"MMRP_SWIN_WHOLE_MINC": "16", "MMRP_SWIN_CHAIN": "0"},
                      {"whole_min_c": 16, "chain": False}),
}


@pytest.fixture()
def slice_route(monkeypatch):
    """Switch the JAX model onto a kernel route (default: the K1/K2/K3 slice)."""

    def enable(route="slice"):
        monkeypatch.setenv("MMRP_FORCE_PALLAS", "1")
        for key, val in ROUTE_ENV[route][0].items():
            monkeypatch.setenv(key, val)

    for key in ("MMRP_FORCE_PALLAS", "MMRP_SWIN_WHOLE", "MMRP_SWIN_WHOLE_MINC",
                "MMRP_SWIN_CHAIN"):
        monkeypatch.delenv(key, raising=False)
    return enable


def test_ln_f32_matches_jax(rng):
    from mmrp_tpu.models.layers import ln_f32 as jln

    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    for affine_in_f32 in (False, True):
        want = np.asarray(jln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.float32,
                              affine_in_f32=affine_in_f32))
        got = ln_f32(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b),
                     torch.float32, affine_in_f32=affine_in_f32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sinusoidal_positions_match_jax():
    from mmrp_tpu.models.layers import sinusoidal_positions as jsin

    np.testing.assert_array_equal(sinusoidal_positions(51, 64), jsin(51, 64))


@pytest.mark.parametrize("route", ["xla", "slice", "whole", "whole_nochain"])
def test_swin_encoder_matches_jax(rng, slice_route, route):
    """Tiny Swin with shifted windows and a merge (56 px: 14x14 then 7x7)."""
    jcfg = jswin.SwinConfig(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2))
    img = rng.random((2, 56, 56, 3), dtype=np.float32)
    jmodel = jswin.SwinEncoder(jcfg)
    params = randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"])
    if route != "xla":
        slice_route(route)
    want = jmodel.apply({"params": params}, jnp.asarray(img))

    fields = ROUTE_ENV[route][1] if route != "xla" else {}
    tcfg = tswin.SwinConfig(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                            **fields)
    tmodel = load(tswin.SwinEncoder(tcfg, device="cpu"), params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(img))
    assert tcfg.num_patches == 49
    for key in ("patches", "global"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("route", ["xla", "slice"])
def test_text_encoder_matches_jax(rng, slice_route, route):
    """Two post-LN layers over ragged masks; ids longer than max_positions
    are truncated."""
    kw = dict(hidden_dim=32, num_layers=2, num_heads=2, intermediate_dim=64, max_positions=16)
    jcfg = jtext.TextConfig.small(dropout=0.0, **kw)
    ids = rng.integers(0, 8192, (3, 20)).astype(np.int32)
    mask = (np.arange(20)[None, :] < np.array([20, 9, 1])[:, None]).astype(np.int32)
    jmodel = jtext.TextEncoder(jcfg)
    params = randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                   jnp.asarray(mask))["params"], seed=1)
    if route == "slice":
        slice_route()
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))

    tmodel = load(ttext.TextEncoder(ttext.TextConfig.small(**kw), device="cpu"), params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got["tokens"].shape == (3, 16, 32)
    for key in ("tokens", "cls"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


def test_fusion_layer_matches_jax(rng):
    """One FusionLayer (enhancers, cross-attentions, self-attention, FFN,
    adapter) against the JAX layer's XLA path, with a ragged text mask."""
    D, Np, Lt = 64, 9, 12
    jcfg = jmm.MultiModalConfig(
        swin=jswin.SwinConfig.micro(), text=jtext.TextConfig.small(), joint_dim=D,
        num_heads=4, dropout=0.0, drop_path=0.0, max_text_len=Lt)
    patches = rng.standard_normal((2, Np, D)).astype(np.float32)
    glob = rng.standard_normal((2, D)).astype(np.float32)
    txt = rng.standard_normal((2, Lt, D)).astype(np.float32)
    tmask = (np.arange(Lt)[None, :] < np.array([Lt, 5])[:, None]).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (patches, glob, txt, tmask)]
    jlayer = jmm.FusionLayer(jcfg, drop_path=0.0)
    params = randomize(jlayer.init(jax.random.PRNGKey(0), *jargs, True, False)["params"],
                       seed=2)
    want, _ = jlayer.apply({"params": params}, *jargs, True, False)

    tcfg = tmm.MultiModalConfig(swin=tswin.SwinConfig.micro(), text=ttext.TextConfig.small(),
                                joint_dim=D, num_heads=4, max_text_len=Lt)
    tlayer = load(tmm.FusionLayer(tcfg, num_patches=Np), params)
    with torch.no_grad():
        got = tlayer(*(torch.from_numpy(a) for a in (patches, glob, txt, tmask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_post_ln_matches_jax(rng):
    """CrossAttention's XLA path applies the post-LN affine in f32
    (``ln_f32(..., affine_in_f32=True)``); the port's kernel form must agree."""
    from mmrp_tpu_torch.models.fusion import CrossAttention

    D = 32
    q = rng.standard_normal((2, 7, D)).astype(np.float32)
    kv = rng.standard_normal((2, 5, D)).astype(np.float32)
    kv_mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    ln_s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    jmod = jfusion.CrossAttention(D, 4)
    jargs = [jnp.asarray(a) for a in (q, kv, kv_mask)]
    params = randomize(jmod.init(jax.random.PRNGKey(0), *jargs)["params"], seed=3)
    want, _ = jmod.apply({"params": params}, *jargs, True, False,
                         post_ln=(jnp.asarray(ln_s), jnp.asarray(ln_b)))
    tmod = load(CrossAttention(D, 4), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv_mask),
                   post_ln=(torch.from_numpy(ln_s), torch.from_numpy(ln_b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
