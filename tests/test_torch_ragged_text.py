"""The packed text route against the padded route and JAX, on the CPU.

A batch of reports of lengths 1, 4, 39, 64, 65, 200 and L (the padded
length), every mask a prefix of valid tokens: K3's packed forms in plain
PyTorch (``attention_plain_packed``) against JAX's ``xla_equivalent`` on the
padded batch at the valid rows; the text encoder (``tokens`` at the valid
rows, ``cls``) and one fusion layer (its pooled output and the pooled text)
on the packed route against the padded route and the JAX model;
``serving_forward`` (``joint_emb``, the logits through ``probs``) against
the padded route; a full mask and a
mask that is no prefix take the padded route; and ``StreamingPipeline``
hands the forward its host mask, so a batch runs packed with no read of the
device.

Tolerances: against the padded route 1e-5 (the same f32 arithmetic, sums
over fewer padded zeros); against JAX the f32 tolerance of
``test_torch_models.py`` (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models import text_encoder as jtext
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.ops import fused_attention as jfa
from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.models import multimodal as tmm
from mmrp_tpu_torch.models import text_encoder as ttext
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.ops import fused_attention as tfa
from mmrp_tpu_torch.serve.stream import StreamingPipeline
from mmrp_tpu_torch.utils import trace
from mmrp_tpu_torch.utils.convert import init_params

from test_torch_models import load, randomize

L = 256
LENGTHS = np.array([1, 4, 39, 64, 65, 200, L])
PADDED = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
C, H = 32, 2


def prefix_mask(lengths=LENGTHS, width=L):
    return (np.arange(width)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)


def grown(before):
    """Each counter's growth since ``before`` (``trace.counters()``)."""
    return {k: v - before.get(k, 0) for k, v in trace.counters().items()
            if v != before.get(k, 0)}


def test_pack_plans_each_row():
    rows = tfa.pack(np.array([2, 1, 3]), 4, "cpu")
    assert (rows.B, rows.T, rows.max_len, rows.width) == (3, 6, 3, 4)
    assert rows.offsets.tolist() == [0, 2, 3, 6] and rows.lengths.tolist() == [2, 1, 3]
    assert rows.pos.tolist() == [0, 1, 0, 0, 1, 2]
    assert rows.slot.tolist() == [0, 1, 3, 6, 7, 8]
    assert rows.pad_index.tolist() == [0, 1, 6, 2, 6, 6, 3, 4, 5]
    assert all(t.dtype == torch.int32 for t in rows[:5])
    x = torch.arange(6.0)[:, None]
    assert tfa.to_padded(x, rows)[..., 0].tolist() == [[0, 1, 0], [2, 0, 0], [3, 4, 5]]
    for bad in ([0, 1], [5], []):
        with pytest.raises(ValueError, match="lengths"):
            tfa.pack(np.array(bad, np.int64), 4, "cpu")


def test_prefix_lengths_and_pack_text():
    assert ttext.prefix_lengths(prefix_mask()).tolist() == LENGTHS.tolist()
    holes = prefix_mask()
    holes[3, 10] = 0
    assert ttext.prefix_lengths(holes) is None
    empty = prefix_mask()
    empty[0] = 0
    assert ttext.prefix_lengths(empty) is None
    full = np.ones((2, 8), np.int64)
    assert ttext.pack_text(ttext.prefix_lengths(full), 8, "cpu") is None
    # lengths past the width are cut, as the encoder cuts the tokens
    rows = ttext.pack_text(np.array([3, 300]), 16, "cpu")
    assert rows.lengths.tolist() == [3, 16] and rows.width == 16


def _k3_case(rng, Nq, Nk, cross, ln_mode):
    x = rng.standard_normal((len(LENGTHS), Nq, C)).astype(np.float32)
    kv = rng.standard_normal((len(LENGTHS), Nk, C)).astype(np.float32) if cross else None
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
    return x, kv, pos, alpha, ln, w, flags


# (ln_mode, which side is packed, Nq, Nk): the BERT layer and the text
# enhancer (packed self-attention), text -> image (packed queries, the 49
# patches as keys), image -> text (49 queries, packed keys)
@pytest.mark.parametrize("ln_mode,packed,Nq,Nk", [
    ("post", "self", L, L), ("pre", "self", L, L), ("post", "q", L, 49), ("post", "kv", 49, L)])
def test_attention_plain_packed_matches_jax(rng, ln_mode, packed, Nq, Nk):
    x, kv, pos, alpha, ln, w, flags = _k3_case(rng, Nq, Nk, packed != "self", ln_mode)
    valid = prefix_mask() > 0
    key_mask = np.where(valid, 0.0, -1e9).astype(np.float32) if packed != "q" else \
        np.zeros((len(LENGTHS), Nk), np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = np.asarray(jfa.xla_equivalent(j(x), j(kv), jnp.asarray(key_mask), *map(j, ln),
                                         *map(j, w), pos=j(pos), alpha=j(alpha), **flags))
    rows = tfa.pack(LENGTHS, L, "cpu")
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    tx = t(x[valid]) if packed in ("self", "q") else t(x)
    tkv = None if kv is None else t(kv[valid]) if packed == "kv" else t(kv)
    tw = [t(a.T.copy()) if a.ndim == 2 else t(a) for a in w]
    kw = dict(rows=rows if packed in ("self", "q") else None,
              kv_rows=rows if packed == "kv" else None)
    got = tfa.fused_attention_packed(tx, *map(t, ln), *tw, kv=tkv, pos=t(pos),
                                     alpha=None if alpha is None else torch.tensor(alpha),
                                     **kw, **flags).numpy()
    np.testing.assert_allclose(got, want[valid] if packed != "kv" else want, **PADDED)


TEXT = dict(hidden_dim=C, num_layers=2, num_heads=H, intermediate_dim=64, max_positions=L)


def test_text_encoder_packed_matches_padded_and_jax(rng):
    ids = rng.integers(0, 8192, (len(LENGTHS), L)).astype(np.int32)
    mask = prefix_mask()
    jmodel = jtext.TextEncoder(jtext.TextConfig.small(dropout=0.0, **TEXT))
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                            jnp.asarray(mask))["params"], seed=1)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    enc = load(ttext.TextEncoder(ttext.TextConfig.small(**TEXT), device="cpu"), params)
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    before = trace.counters()
    with torch.no_grad():
        padded = enc(tids, tmask)
        packed = enc(tids, tmask, rows=ttext.pack_text(LENGTHS, L, "cpu"))
    T = int(LENGTHS.sum())
    assert grown(before) == {"text.padded": 1, "text.packed": 1, "text.rows": 7 * L + T,
                             "text.rows_padded": 2 * 7 * L}
    valid = mask > 0
    assert packed["tokens"].shape == (T, C)
    np.testing.assert_allclose(packed["tokens"].numpy(), padded["tokens"].numpy()[valid],
                               **PADDED)
    np.testing.assert_allclose(packed["cls"].numpy(), padded["cls"].numpy(), **PADDED)
    np.testing.assert_allclose(packed["tokens"].numpy(), np.asarray(want["tokens"])[valid],
                               **TOL)
    np.testing.assert_allclose(packed["cls"].numpy(), np.asarray(want["cls"]), **TOL)


def test_fusion_layer_packed_matches_padded_and_jax(rng):
    """One fusion layer: its pooled output and the fusion's pooled text."""
    D, Np, B = 64, 9, len(LENGTHS)
    jcfg = jmm.MultiModalConfig(
        swin=JSwinConfig.micro(), text=jtext.TextConfig.small(), joint_dim=D, num_heads=4,
        dropout=0.0, drop_path=0.0, max_text_len=L)
    patches = rng.standard_normal((B, Np, D)).astype(np.float32)
    glob = rng.standard_normal((B, D)).astype(np.float32)
    txt = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = prefix_mask()
    jargs = [jnp.asarray(a) for a in (patches, glob, txt, mask)]
    jlayer = jmm.FusionLayer(jcfg, drop_path=0.0)
    params = randomize(jax.jit(jlayer.init, static_argnums=(5, 6))(
        jax.random.PRNGKey(0), *jargs, True, False)["params"], seed=2)
    want, _ = jax.jit(jlayer.apply, static_argnums=(5, 6))({"params": params}, *jargs, True,
                                                            False)
    tcfg = tmm.MultiModalConfig(swin=SwinConfig.micro(), text=ttext.TextConfig.small(),
                                joint_dim=D, num_heads=4, max_text_len=L)
    layer = load(tmm.FusionLayer(tcfg, num_patches=Np), params)
    rows = tfa.pack(LENGTHS, L, "cpu")
    args = [torch.from_numpy(a) for a in (patches, glob, txt, mask)]
    packed_args = (*args[:2], args[2][torch.from_numpy(mask > 0)], None)
    with torch.no_grad():
        padded = layer(*args)
        packed = layer(*packed_args, txt_rows=rows)
        seq_padded = layer.fusion(*args)
        seq_packed = layer.fusion(*packed_args, txt_rows=rows)
    np.testing.assert_allclose(packed.numpy(), padded.numpy(), **PADDED)
    np.testing.assert_allclose(packed.numpy(), np.asarray(want), **TOL)
    assert seq_packed.shape == seq_padded.shape == (B, Np + 2, D)
    np.testing.assert_allclose(seq_packed[:, -1].numpy(), seq_padded[:, -1].numpy(), **PADDED)


@pytest.fixture(scope="module")
def model():
    """A port model at text length L from a seeded init (a micro Swin at 28
    px, one BERT layer, one fusion layer): the padded route it is held to is
    held to JAX by ``test_torch_slice.py``."""
    text = dict(hidden_dim=C, num_layers=1, num_heads=H, intermediate_dim=64)
    head = dict(joint_dim=64, num_fusion_layers=1, num_heads=4, num_classes=7, max_text_len=L)
    swin = dict(img_size=28, embed_dim=16, depths=(2,), num_heads=(2,))
    model = tmm.MultiModalRetrievalModel(tmm.MultiModalConfig(
        swin=SwinConfig(**swin), text=ttext.TextConfig.small(**text), **head), device="cpu")
    init_params(model, seed=0)
    return model.eval()


def model_inputs(mask=None):
    rng = np.random.default_rng(5)
    B = len(LENGTHS)
    img = rng.random((B, 28, 28, 3), dtype=np.float32)
    ids = rng.integers(0, 8192, (B, L)).astype(np.int32)
    return img, ids, prefix_mask() if mask is None else mask


def test_serving_forward_packed_matches_padded(model):
    img, ids, mask = model_inputs()
    fwd = serving_forward(model)
    args = (torch.from_numpy(img), torch.from_numpy(ids).long(), torch.from_numpy(mask))
    before = trace.counters()
    packed = {k: v.numpy() for k, v in fwd(*args[:2], mask).items()}
    assert grown(before) == {"text.packed": 1, "text.rows": int(LENGTHS.sum()),
                             "text.rows_padded": len(LENGTHS) * L}
    padded = {k: v.numpy() for k, v in fwd(*args).items()}

    def logits(p):
        p = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
        return np.log(p) - np.log1p(-p)

    for key in ("joint_emb", "probs"):
        np.testing.assert_allclose(packed[key], padded[key], err_msg=key, **PADDED)
    np.testing.assert_allclose(logits(packed["probs"]), logits(padded["probs"]), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["full", "not_prefix", "tensor"])
def test_other_masks_take_the_padded_route(model, case):
    """A batch without padding, and one whose mask has a hole, run padded
    (the packed plan could not hold them), counted as such; so does a mask
    given as a tensor (no host mask to plan from)."""
    mask = prefix_mask()
    if case == "full":
        mask[:] = 1
    elif case == "not_prefix":
        mask[2, 1] = 0
    else:
        mask = torch.from_numpy(mask)
    img, ids, _ = model_inputs()
    before = trace.counters()
    serving_forward(model)(torch.from_numpy(img), torch.from_numpy(ids).long(), mask)
    assert grown(before) == {"text.padded": 1, "text.rows": len(LENGTHS) * L,
                             "text.rows_padded": len(LENGTHS) * L}


def test_stream_passes_the_host_mask(model):
    """StreamingPipeline's forward takes the packed route on a batch of
    prefix masks, reads nothing from the device to plan it, and returns the
    padded route's rows."""
    img, ids, mask = model_inputs()
    pipe = StreamingPipeline(model, K=3)
    before = trace.counters()
    got = pipe.process_batch({"image": img, "input_ids": ids, "attention_mask": mask})
    counts = grown(before)
    assert counts.get("text.packed") == 1 and "text.padded" not in counts
    assert "host_reads" not in counts
    want = serving_forward(model)(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(got["joint_emb"], want["joint_emb"].numpy(), **PADDED)
    np.testing.assert_allclose(got["probs"], want["probs"].numpy(), **PADDED)
