"""The port's CUDA kernels against their plain-PyTorch versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false. The
file imports no JAX, so it also runs on a machine without it; the repo's
``tests/conftest.py`` does import JAX, hence on such a machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Inputs are bf16 from a seeded CUDA generator, at small shapes that still
cover ragged token counts and every head dim of the slice. Tolerance: the
kernel and the plain version round at the same places, but sum in other
orders, and one bf16 ulp of an output of magnitude ~4 is 0.03.
"""

import pytest
import torch

from mmrp_tpu_torch.ops import fused_attention as tfa
from mmrp_tpu_torch.ops import fused_mlp as tfm
from mmrp_tpu_torch.ops import fused_swin_block as tsb
from mmrp_tpu_torch.ops import fused_swin_pair as tsp
from mmrp_tpu_torch.ops import fused_window_attention as tfw
from mmrp_tpu_torch.ops import wattn_core as twc
from mmrp_tpu_torch.ops import window_attention as twa

ATOL = 6e-2
# a whole Swin block (two residual branches, and a pair two blocks deep)
# reaches outputs of magnitude ~8, where one bf16 ulp is 0.06: bound the
# error by 4 ulps of the output, as chip_smoke.py does
SWIN_TOL = dict(atol=2.0 ** -5, rtol=2.0 ** -5)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(gen, shape, dev, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("C,heads,nW,shift", [(128, 4, 4, 3), (256, 8, 1, 0), (64, 1, 4, 0)])
def test_window_attention_kernel(dev, C, heads, nW, shift):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, ws = 2, 7
    xw = _rand(gen, (B, nW, ws * ws, C), dev)
    table = _rand(gen, ((2 * ws - 1) ** 2, heads), dev, 0.5, torch.float32)
    H = int(nW ** 0.5) * ws
    args = (xw, 1 + _rand(gen, (C,), dev, 0.1, torch.float32),
            _rand(gen, (C,), dev, 0.1, torch.float32),
            _rand(gen, (3 * C, C), dev, C ** -0.5), _rand(gen, (3 * C,), dev, 0.1),
            _rand(gen, (C, C), dev, C ** -0.5), _rand(gen, (C,), dev, 0.1),
            tfw.build_bias_full(table, ws, H, H, shift), heads)
    before = tfw.fused_window_attention_windows.launches
    with torch.no_grad():
        got = tfw.fused_window_attention_windows(*args)
        want = tfw.window_attention_plain(*args)
    torch.cuda.synchronize()
    assert tfw.fused_window_attention_windows.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,Hd,post_ln", [(200, 128, 512, False), (51, 1024, 4096, False),
                                            (64, 256, 1024, True)])
def test_ln_mlp_kernel(dev, M, C, Hd, post_ln):
    gen = torch.Generator(device=dev).manual_seed(1)
    args = (_rand(gen, (M, C), dev), 1 + _rand(gen, (C,), dev, 0.1, torch.float32),
            _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (Hd, C), dev, C ** -0.5),
            _rand(gen, (Hd,), dev, 0.1), _rand(gen, (C, Hd), dev, Hd ** -0.5),
            _rand(gen, (C,), dev, 0.1))
    with torch.no_grad():
        got = tfm.fused_ln_mlp_residual(*args, post_ln=post_ln)
        want = tfm.ln_mlp_plain(*args, post_ln=post_ln)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=0)


# M rows of each MLP shape of the serving path (batch 8), the same at batch 1
# (ragged), and M that make the host pick each cluster split on 132 SMs
# (csrc/mlp_sm90.cuh::mlp_cluster_size: the fewest ranks whose hidden slice is
# at most 512 wide and whose layout fits, doubled while the grid stays within
# one block per SM): C 128 -> S 1 / 2 / 4, C 256 -> 2 / 4 / 8, C 512 -> 4 / 8,
# C 1024 -> 8; C 1024 Hd 1024 -> 4 (S 2 would not fit); then Swin-T / S
# stages 1-2 (C 96 and 192, not multiples of 128: partial K chunk and output
# tile) at batch 8 and ragged
MLP_SHAPES = [(25088, 128, 512, False), (4000, 128, 512, False), (200, 128, 512, False),
              (408, 1024, 4096, False), (51, 1024, 4096, False), (6272, 256, 1024, False),
              (1568, 256, 1024, False), (196, 256, 1024, True), (1568, 512, 2048, False),
              (196, 512, 2048, False), (51, 768, 3072, True), (51, 1024, 1024, True),
              (25088, 96, 384, False), (6272, 192, 768, False), (200, 96, 384, True),
              (51, 192, 768, False), (100, 64, 256, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,C,Hd,post_ln", MLP_SHAPES)
def test_ln_mlp_kernel_at_every_split(dev, M, C, Hd, post_ln):
    """K2 on the wgmma MLP at the serving shapes, ragged M and every cluster
    split, pre- and post-LN, within 4 bf16 ulps of the output."""
    gen = torch.Generator(device=dev).manual_seed(14)
    args = (_rand(gen, (M, C), dev), 1 + _rand(gen, (C,), dev, 0.1, torch.float32),
            _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (Hd, C), dev, C ** -0.5),
            _rand(gen, (Hd,), dev, 0.1), _rand(gen, (C, Hd), dev, Hd ** -0.5),
            _rand(gen, (C,), dev, 0.1))
    before = tfm.fused_ln_mlp_residual.launches
    with torch.no_grad():
        got = tfm.fused_ln_mlp_residual(*args, post_ln=post_ln)
        want = tfm.ln_mlp_plain(*args, post_ln=post_ln)
    torch.cuda.synchronize()
    assert tfm.fused_ln_mlp_residual.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SWIN_TOL)


@pytest.mark.cuda
def test_mlp_cluster_sizes_are_the_kernels_host_code(dev):
    """The Python copies of the MLP kernels' cluster sizing (which
    ``kernel_takes`` and the plan read) against the host code that launches
    them, over a grid of widths, hidden widths, row tiles and SM counts; and
    the whole block's predicate, the same for every form (bf16, static and
    per-row W8A8 all launch the wgmma epilogue, whose host code sizes the
    cluster by mlp_cluster_size with f32 rows staged), against that host
    code's answer."""
    from mmrp_tpu_torch.ops import _build

    lib = _build.library()
    n = 0
    for C in (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024):
        for Hd in sorted({C, 2 * C, 3 * C, 4 * C, 8 * C, 384, 4096}):
            for row_tiles in (1, 7, 25, 98, 392):
                for sms in (0, 132):
                    for staged in (2, 4):
                        assert lib.mmrp_mlp_cluster(row_tiles, Hd, staged * C, sms) == \
                            tfm.mlp_cluster_size(row_tiles, Hd, staged * C, sms), \
                            (C, Hd, row_tiles, sms, staged)
                    n += 1
            fits = lib.mmrp_mlp_cluster(1, Hd, 4 * C, 0) > 0
            for quant in (False, "static", True):
                assert tsb.kernel_takes(C, C // 32, 49, Hd, quant) == fits, (C, Hd, quant)
    assert n > 500


@pytest.mark.cuda
def test_wrappers_raise_where_kernel_takes_refuses(dev):
    """Each wrapper raises on CUDA tensors of a shape its ``kernel_takes``
    refuses (no fallback), and runs one it takes."""
    gen = torch.Generator(device=dev).manual_seed(15)
    C, Hd = 64, 320  # K2 takes Hd % 128 == 0 only
    assert not tfm.kernel_takes(C, Hd)
    args = (_rand(gen, (16, C), dev), torch.ones(C, device=dev), torch.zeros(C, device=dev),
            _rand(gen, (Hd, C), dev), _rand(gen, (Hd,), dev), _rand(gen, (C, Hd), dev),
            _rand(gen, (C,), dev))
    with pytest.raises(ValueError, match="the kernel takes"):
        tfm.fused_ln_mlp_residual(*args)
    blk, bias = _swin_block(gen, dev, 64, 4, 7, 0)  # head dim 16: no kernel
    assert not tsb.kernel_takes(64, 4, 49, 256)
    with pytest.raises(ValueError, match="the kernel takes"):
        tsb.fused_swin_block_windows(_rand(gen, (1, 1, 49, 64), dev), *blk, bias, 4)
    assert not tfw.kernel_takes(64, 4, 49)
    with pytest.raises(ValueError, match="the kernel takes"):
        tfw.fused_window_attention_windows(_rand(gen, (1, 1, 49, 64), dev), *blk[:6], bias, 4)
    args, kw = _k3_inputs(gen, dev, "post", False, 1, 16, 16, 64, 2)
    assert not tfa.kernel_takes(64, 2, 16)
    with pytest.raises(ValueError, match="the kernel takes"):
        tfa.fused_attention(*args, **kw)
    qkv, bias, dout, kw = _core_inputs(gen, dev, 1, 14, 16, 2, 3)  # head dim 8: no C-F / C-B
    assert not twc.kernel_takes(16, 2, 7, 3)
    with pytest.raises(ValueError, match="the kernel takes"):
        twc.core_forward(qkv, bias, **kw)
    with pytest.raises(ValueError, match="the kernel takes"):
        twc.core_backward(qkv, bias, dout, **kw)
    with torch.no_grad():
        blk, bias = _swin_block(gen, dev, 128, 4, 7, 0)
        assert tsb.kernel_takes(128, 4, 49, 512)
        tsb.fused_swin_block_windows(_rand(gen, (1, 1, 49, 128), dev), *blk, bias, 4)


@pytest.mark.cuda
def test_predict_runs_the_slice_model_through_its_plain_routes(dev):
    """MMRPredictor.predict on the slice tests' model, whose attentions no
    kernel takes (head dims 8 and 16, widths 16 to 64), in bf16 on the card:
    every such call site on its plain route, counted, the fusion FFN (C 64)
    on K2, every output finite, and the outputs against the same weights in
    f32 on the CPU within a bf16 tolerance."""
    import numpy as np

    from mmrp_tpu_torch.api import MMRPredictor, serving_forward
    from mmrp_tpu_torch.models.multimodal import (
        MultiModalConfig,
        MultiModalRetrievalModel,
        plain_routes,
    )
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig
    from mmrp_tpu_torch.utils.convert import init_params

    cfg = MultiModalConfig(
        swin=SwinConfig(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2)),
        text=TextConfig.small(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64),
        joint_dim=64, num_fusion_layers=2, num_heads=4, num_classes=7, max_text_len=16)
    assert len(plain_routes(cfg)) == 10
    model = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev).eval()
    init_params(model, seed=0)
    rng = np.random.default_rng(0)
    img = rng.random((2, 56, 56, 3), dtype=np.float32)
    ids = rng.integers(0, cfg.text.vocab_size, (2, 16)).astype(np.int64)
    mask = (np.arange(16)[None, :] < np.array([[16], [9]])).astype(np.int64)
    counters = (tfw.fused_window_attention_windows, tfm.fused_ln_mlp_residual,
                tfa.fused_attention)
    before = [(fn.plain_calls, fn.launches) for fn in counters]
    pred = MMRPredictor(model, [f"c{i}" for i in range(7)]).predict(img, ids, mask)
    torch.cuda.synchronize()
    # 4 Swin blocks (K1 + K2 each), 1 BERT attention, 2 fusion layers of 5
    # attentions (plain) and one FFN (K2)
    assert [(fn.plain_calls - b[0], fn.launches - b[1]) for fn, b in zip(counters, before)] \
        == [(4, 0), (4, 2), (1 + 2 * 5, 0)]
    assert all(np.isfinite(pred[k]).all() for k in ("probs", "joint_emb"))
    ref = MultiModalRetrievalModel(cfg, device="cpu").eval()
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    want = serving_forward(ref)(torch.from_numpy(img), torch.from_numpy(ids),
                                torch.from_numpy(mask))
    # bf16 against f32: on the CPU the same bf16 model differs from f32 by at
    # most 2.3e-3 (probs) and 1.9e-2 (joint_emb), cosine 0.99998
    np.testing.assert_allclose(pred["probs"], want["probs"].numpy(), rtol=0, atol=1e-2)
    np.testing.assert_allclose(pred["joint_emb"], want["joint_emb"].numpy(), rtol=0, atol=5e-2)
    cos = torch.nn.functional.cosine_similarity(torch.as_tensor(pred["joint_emb"]).float(),
                                                want["joint_emb"].float(), dim=-1)
    assert cos.min().item() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("ln_mode,cross,B,Nq,Nk,C,heads", [
    ("post", False, 2, 64, 64, 768, 12),
    ("pre", False, 2, 51, 51, 1024, 8),
    ("post", True, 2, 13, 9, 256, 4),
    ("none", True, 3, 49, 64, 128, 4),
])
def test_seq_attention_kernel(dev, ln_mode, cross, B, Nq, Nk, C, heads):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = _rand(gen, (B, Nq, C), dev)
    kv = _rand(gen, (B, Nk, C), dev) if cross else None
    mask = torch.where(torch.rand((B, Nk), generator=gen, device=dev) < 0.3, -1e9, 0.0)
    mask[:, 0] = 0.0
    pos = _rand(gen, (Nq, C), dev, 0.5) if ln_mode == "pre" else None
    alpha = torch.tensor(0.37, device=dev) if ln_mode == "pre" else None
    w = []
    for _ in range(4):
        w += [_rand(gen, (C, C), dev, C ** -0.5), _rand(gen, (C,), dev, 0.1)]
    ln = (1 + _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (C,), dev, 0.1, torch.float32))
    kw = dict(kv=kv, key_mask=mask, pos=pos, alpha=alpha, num_heads=heads, ln_mode=ln_mode,
              include_residual=True, residual_from_raw=ln_mode == "pre")
    with torch.no_grad():
        got = tfa.fused_attention(x, *ln, *w, **kw)
        want = tfa.attention_plain(x, *ln, *w, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=0)


def _k3_inputs(gen, dev, ln_mode, cross, B, Nq, Nk, C, heads, full_mask=False):
    """K3's inputs at one shape: a key mask with 30% of keys masked (key 0 kept),
    or with sequence 0 masked entirely; pos and alpha for the pre form."""
    x = _rand(gen, (B, Nq, C), dev)
    kv = _rand(gen, (B, Nk, C), dev) if cross else None
    mask = torch.where(torch.rand((B, Nk), generator=gen, device=dev) < 0.3, -1e9, 0.0)
    mask[:, 0] = 0.0
    if full_mask:
        mask[0] = -1e9
    pos = _rand(gen, (Nq, C), dev, 0.5) if ln_mode == "pre" else None
    alpha = torch.tensor(0.37, device=dev) if ln_mode == "pre" else None
    w = []
    for _ in range(4):
        w += [_rand(gen, (C, C), dev, C ** -0.5), _rand(gen, (C,), dev, 0.1)]
    ln = (1 + _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (C,), dev, 0.1, torch.float32))
    kw = dict(kv=kv, key_mask=mask, pos=pos, alpha=alpha, num_heads=heads, ln_mode=ln_mode,
              include_residual=not cross, residual_from_raw=ln_mode == "pre")
    return (x, *ln, *w), kw


# token counts around the 64-wide attention tiles, up to the model's 512
# positions: one tile, one past it (a one-key last tile), two, ragged, eight
LONG = [64, 65, 128, 136, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ln_mode,cross,C,heads,Nq,Nk", [
    *[("post", False, 768, 12, n, n) for n in LONG],     # BERT self-attention
    ("pre", False, 1024, 8, 136, 136),                   # text enhancer
    ("post", True, 1024, 8, 512, 49),                    # text -> image cross
    ("post", True, 1024, 8, 49, 512),                    # image -> text cross, masked
    ("none", True, 256, 4, 65, 136),
])
def test_seq_attention_long_kernel(dev, quant, ln_mode, cross, C, heads, Nq, Nk):
    """K3 past the old 64-token limit, with sequence 0 fully masked: its rows
    average exactly its Nk values (keys past Nk in the last tile excluded)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    args, kw = _k3_inputs(gen, dev, ln_mode, cross, 2, Nq, Nk, C, heads, full_mask=True)
    kw = dict(kw, quant=quant)
    counter = "launches_int8" if quant else "launches"
    before = getattr(tfa.fused_attention, counter)
    with torch.no_grad():
        got = tfa.fused_attention(*args, **kw)
        want = tfa.attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(tfa.fused_attention, counter) == before + 1
    tol = INT8_TOL if quant else SWIN_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_seq_attention_refuses_past_the_positions(dev):
    gen = torch.Generator(device=dev).manual_seed(13)
    args, kw = _k3_inputs(gen, dev, "post", False, 1, 513, 513, 128, 2)
    with pytest.raises(ValueError, match="512"):
        tfa.fused_attention(*args, **kw)


@pytest.mark.cuda
def test_predict_at_128_tokens(dev):
    """MMRPredictor.predict on a small model whose widths the kernels take,
    at text length 128 (K3 refused more than 64 tokens before): the card's
    bf16 output against the same weights in f32 on the CPU."""
    import numpy as np

    from mmrp_tpu_torch.api import MMRPredictor, serving_forward
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig
    from mmrp_tpu_torch.utils.convert import init_params

    L, B = 128, 2
    cfg = MultiModalConfig(
        swin=SwinConfig(img_size=56, embed_dim=64, depths=(2,), num_heads=(2,)),
        text=TextConfig.small(hidden_dim=256, num_layers=1, num_heads=4, intermediate_dim=512),
        joint_dim=128, num_fusion_layers=1, num_heads=4, num_classes=5, max_text_len=L)
    model = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev).eval()
    init_params(model, seed=0)
    rng = np.random.default_rng(0)
    img = rng.random((B, 56, 56, 3), dtype=np.float32)
    ids = rng.integers(0, cfg.text.vocab_size, (B, L)).astype(np.int64)
    mask = (np.arange(L)[None, :] < np.array([[L], [97]])).astype(np.int64)
    before = tfa.fused_attention.launches
    pred = MMRPredictor(model, [f"c{i}" for i in range(5)]).predict(img, ids, mask)
    torch.cuda.synchronize()
    assert tfa.fused_attention.launches - before == 1 + 5 * cfg.num_fusion_layers
    ref = MultiModalRetrievalModel(cfg, device="cpu").eval()
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    want = serving_forward(ref)(torch.from_numpy(img), torch.from_numpy(ids),
                                torch.from_numpy(mask))
    got, wj = pred["joint_emb"], want["joint_emb"].numpy()
    cos = (got * wj).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(wj, axis=1))
    assert cos.min() > 0.999
    assert np.abs(pred["probs"] - want["probs"].numpy()).max() < 1e-2


def _swin_block(gen, dev, C, heads, H, shift, ws=7):
    """12 block tensors (nn.Linear layout) and the (nW, h, N, N) bias_full of
    ws x ws windows (N = ws^2)."""
    Hd = 4 * C
    blk = (1 + _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (C,), dev, 0.1, torch.float32),
           _rand(gen, (3 * C, C), dev, C ** -0.5), _rand(gen, (3 * C,), dev, 0.1),
           _rand(gen, (C, C), dev, C ** -0.5), _rand(gen, (C,), dev, 0.1),
           1 + _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (C,), dev, 0.1, torch.float32),
           _rand(gen, (Hd, C), dev, C ** -0.5), _rand(gen, (Hd,), dev, 0.1),
           _rand(gen, (C, Hd), dev, Hd ** -0.5), _rand(gen, (C,), dev, 0.1))
    table = _rand(gen, ((2 * ws - 1) ** 2, heads), dev, 0.5, torch.float32)
    return blk, tfw.build_bias_full(table, ws, H, H, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,C,heads,H,roll", [
    ("windows", 1024, 32, 7, 0), ("windows", 128, 2, 14, 0), ("raw", 256, 8, 14, 0),
    ("chain", 256, 4, 14, -3), ("chain", 512, 16, 14, 3), ("chain", 128, 4, 7, 0)])
def test_swin_block_kernel(dev, flavor, C, heads, H, roll):
    gen = torch.Generator(device=dev).manual_seed(3)
    blk, bias = _swin_block(gen, dev, C, heads, H, 3 if roll > 0 else 0)
    x = _rand(gen, (2, H, H, C), dev)
    with torch.no_grad():
        if flavor == "windows":
            xw = x.reshape(2, H // 7, 7, H // 7, 7, C).permute(0, 1, 3, 2, 4, 5) \
                .reshape(2, (H // 7) ** 2, 49, C).contiguous()
            fn = tsb.fused_swin_block_windows
            before = fn.launches
            got = fn(xw, *blk, bias, heads)
            want = tsb.swin_block_plain(xw, *blk, bias, heads)
        elif flavor == "raw":
            fn = tsb.fused_swin_block_raw
            before = fn.launches
            got = fn(x, *blk, bias, heads, 7)
            want = tsb.raw_plain(x, *blk, bias, num_heads=heads, ws=7)
        else:
            fn = tsp.fused_swin_block_chain
            before = fn.launches
            got = fn(x, blk, bias, heads, 7, roll)
            want = tsp.chain_plain(x, blk, bias, heads, 7, roll)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SWIN_TOL)


# the whole-block MLP epilogue at the serving path's shapes (batch 8), at
# batch 1 (ragged row tiles: 196 / 784 / 49 rows) and the splits they give:
# pair C 256 S 2 / 8, chain C 512 S 4 / 8, windows C 1024 S 8
BLOCK_SHAPES = [("pair", 8, 256, 8, 28), ("pair", 1, 256, 8, 28), ("chain", 8, 512, 16, 14),
                ("chain", 1, 512, 16, 14), ("windows", 8, 1024, 32, 7),
                ("windows", 1, 1024, 32, 7), ("chain", 2, 96, 3, 14), ("pair", 1, 192, 6, 14),
                ("windows", 2, 768, 24, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, "static", "per_row", True])
@pytest.mark.parametrize("flavor,B,C,heads,H", BLOCK_SHAPES)
def test_swin_block_epilogue_at_every_split(dev, flavor, B, C, heads, H, quant):
    """The wgmma epilogue in bf16, static W8A8 (calibrated scales), static
    W8A8 with per-row scales, and the dynamic form (True; JAX has it on the
    windows and raw flavors only, so a pair or chain shape runs raw on the
    same map) at the serving shapes, within the bf16 / int8 bounds of
    chip_smoke.py, with the launch counted in its form."""
    gen = torch.Generator(device=dev).manual_seed(16)
    (blk0, bias0), (blk1, bias1) = (_swin_block(gen, dev, C, heads, H, s)
                                    for s in (0, 3 if H > 7 else 0))
    x = _rand(gen, (B, H, H, C), dev)
    kw, tol, counter = {}, SWIN_TOL, "launches"
    if quant is True:
        kw, tol, counter = dict(quant=True), INT8_TOL, "launches_dynamic"
        flavor = "raw" if flavor != "windows" else flavor
    elif quant:
        (blk0, s0), (blk1, s1) = _int8_block(blk0), _int8_block(blk1)
        acts = (4.5 / 127, 3.0 / 127, 5.0 / 127, 2.5 / 127) if quant == "static" else None
        kw = dict(quant="static", wscales=s0, act_scales=acts)
        tol = INT8_PAIR_TOL if flavor == "pair" else INT8_TOL
        counter = "launches_static" if acts else "launches_per_row"
    with torch.no_grad():
        if flavor == "raw":
            fn = tsb.fused_swin_block_raw
            before = getattr(fn, counter)
            got = fn(x, *blk0, bias0, heads, 7, **kw)
            want = tsb.raw_plain(x, *blk0, bias0, num_heads=heads, ws=7, **kw)
        elif flavor == "pair":
            pkw = {} if not quant else dict(quant="static", wscales0=s0, wscales1=s1,
                                            act_scales0=kw["act_scales"],
                                            act_scales1=kw["act_scales"])
            fn = tsp.fused_swin_block_pair
            before = getattr(fn, counter)
            got = fn(x, blk0, bias0, blk1, bias1, heads, 7, 3, **pkw)
            want = tsp.pair_plain(x, blk0, bias0, blk1, bias1, heads, 7, 3, **pkw)
        elif flavor == "chain":
            fn = tsp.fused_swin_block_chain
            before = getattr(fn, counter)
            got = fn(x, blk1, bias1, heads, 7, 3, **dict(kw, wscales=s1) if quant else {})
            want = tsp.chain_plain(x, blk1, bias1, heads, 7, 3,
                                   **dict(kw, wscales=s1) if quant else {})
        else:
            fn = tsb.fused_swin_block_windows
            xw = x.reshape(B, 1, 49, C)
            before = getattr(fn, counter)
            got = fn(xw, *blk0, bias0, heads, **kw)
            want = tsb.swin_block_plain(xw, *blk0, bias0, heads, **kw)
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_swin_pair_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    C, heads, H = 256, 8, 28
    blk0, bias0 = _swin_block(gen, dev, C, heads, H, 0)
    blk1, bias1 = _swin_block(gen, dev, C, heads, H, 3)
    x = _rand(gen, (2, H, H, C), dev)
    before = tsp.fused_swin_block_pair.launches
    with torch.no_grad():
        got = tsp.fused_swin_block_pair(x, blk0, bias0, blk1, bias1, heads, 7, 3)
        want = tsp.pair_plain(x, blk0, bias0, blk1, bias1, heads, 7, 3)
    torch.cuda.synchronize()
    assert tsp.fused_swin_block_pair.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SWIN_TOL)


def _core_inputs(gen, dev, B, res, C, heads, shift, ws=7):
    qkv = _rand(gen, (B, res, res, 3 * C), dev)
    table = _rand(gen, ((2 * ws - 1) ** 2, heads), dev, 0.5, torch.float32)
    dout = _rand(gen, (B, res, res, C), dev)
    kw = dict(ws=ws, shift=shift, num_heads=heads, scale=(C // heads) ** -0.5)
    return qkv, tfw.build_bias_full(table, ws, res, res, shift), dout, kw


# (B, res, C, heads, shift): Swin-B stage-1 and stage-3 geometries; then
# batches that the backward's cluster ranks may split unevenly (the ranks
# follow the clusters the card holds; with 132 SMs' default counts 7 images
# at stage 1 go 4 + 3, 9 at stage 3 go 2 + 2 + 2 + 2 + 1), one of 1024
# (window, head) pairs, B = 1, and Swin-T's stages 1-2 (3 and 6 heads)
CORE_CASES = [(2, 56, 128, 4, 0), (2, 56, 128, 4, 3), (3, 14, 512, 16, 0),
              (3, 14, 512, 16, 3), (7, 56, 128, 4, 3), (3, 56, 512, 16, 0),
              (7, 14, 512, 16, 3), (9, 14, 512, 16, 0), (1, 56, 128, 4, 3),
              (2, 56, 96, 3, 3), (2, 28, 192, 6, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,res,C,heads,shift", CORE_CASES)
def test_core_kernels(dev, B, res, C, heads, shift):
    """C-F and C-B against the plain composition (autograd through it for
    the backward). dbias sums B images' dS, so its bound is relative to its
    largest element; it is the same bit for bit from run to run."""
    gen = torch.Generator(device=dev).manual_seed(5)
    qkv, bias, dout, kw = _core_inputs(gen, dev, B, res, C, heads, shift)
    before = (twc.core_forward.launches, twc.core_backward.launches)
    with torch.no_grad():
        out = twc.core_forward(qkv, bias, **kw)
        dqkv, dbias = twc.core_backward(qkv, bias, dout, **kw)
        dqkv2, dbias2 = twc.core_backward(qkv, bias, dout, **kw)
    want = twc.window_attention_core_plain(qkv, bias, **kw)
    want_dqkv, want_dbias = twc.core_backward_plain(qkv, bias, dout, **kw)
    torch.cuda.synchronize()
    assert (twc.core_forward.launches, twc.core_backward.launches) == \
        (before[0] + 1, before[1] + 2)
    torch.testing.assert_close(out.float(), want.float(), **SWIN_TOL)
    torch.testing.assert_close(dqkv.float(), want_dqkv.float(), **SWIN_TOL)
    assert (dbias - want_dbias).abs().max() <= 2.0 ** -6 * want_dbias.abs().max()
    assert torch.equal(dbias, dbias2) and torch.equal(dqkv, dqkv2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,shift", [(3, 0), (2, 4)])
def test_core_kernels_at_64_tokens(dev, B, shift):
    """8 x 8 windows (64 tokens, eight key tiles, no row past the window):
    C-B reads its bias from device memory."""
    gen = torch.Generator(device=dev).manual_seed(8)
    qkv, bias, dout, kw = _core_inputs(gen, dev, B, 16, 128, 4, shift, ws=8)
    with torch.no_grad():
        out = twc.core_forward(qkv, bias, **kw)
        dqkv, dbias = twc.core_backward(qkv, bias, dout, **kw)
    want = twc.window_attention_core_plain(qkv, bias, **kw)
    want_dqkv, want_dbias = twc.core_backward_plain(qkv, bias, dout, **kw)
    torch.testing.assert_close(out.float(), want.float(), **SWIN_TOL)
    torch.testing.assert_close(dqkv.float(), want_dqkv.float(), **SWIN_TOL)
    assert (dbias - want_dbias).abs().max() <= 2.0 ** -6 * want_dbias.abs().max()


@pytest.mark.cuda
def test_core_function_matches_autograd_of_the_plain_version(dev):
    """window_attention_core on CUDA tensors is the autograd.Function of C-F
    and C-B: its gradients for qkv and bias match autograd through the
    plain composition, and both kernels ran."""
    gen = torch.Generator(device=dev).manual_seed(6)
    qkv, bias, dout, kw = _core_inputs(gen, dev, 2, 14, 256, 8, 3)
    before = (twc.core_forward.launches, twc.core_backward.launches)
    grads = []
    for fn in (twc.window_attention_core, twc.window_attention_core_plain):
        q, b = qkv.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        out = fn(q, b, **kw)
        out.backward(dout)
        grads.append((out.detach(), q.grad, b.grad))
    torch.cuda.synchronize()
    assert (twc.core_forward.launches, twc.core_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    (out, dq, db), (want, want_dq, want_db) = grads
    torch.testing.assert_close(out.float(), want.float(), **SWIN_TOL)
    torch.testing.assert_close(dq.float(), want_dq.float(), **SWIN_TOL)
    assert (db - want_db).abs().max() <= 2.0 ** -6 * want_db.abs().max()


# (res, C, heads) of the training stages with more than one window
CORE_STAGES = {"swin_base": ((56, 128, 4), (28, 256, 8), (14, 512, 16)),
               "swin_tiny": ((56, 96, 3), (28, 192, 6), (14, 384, 12)),
               "swin_small": ((56, 96, 3), (28, 192, 6), (14, 384, 12))}


@pytest.mark.cuda
def test_core_plan_is_the_kernels_host_code(dev):
    """The Python copy of C-F / C-B's sizing (``wattn_core.core_plan``, which
    ``kernel_takes`` reads) against the host code that launches them, at
    every Swin-B, -T and -S training stage for B in {1, 2, 7, 64}, windows of
    7 and 8, with the clusters of 1 to 8 blocks this card holds at once (as
    the launcher asks for them) and with the default counts on 132 and 0
    SMs."""
    import ctypes

    from mmrp_tpu_torch.ops import _build

    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 0
    for ws in (7, 8):
        card_fit = [lib.mmrp_core_fit(ws, r) for r in range(1, 9)]
        assert min(card_fit) > 0, card_fit
        for stages in CORE_STAGES.values():
            for res, C, heads in stages:
                nW = (res // 7) ** 2
                for B in (1, 2, 7, 64):
                    for s, fit in ((sms, card_fit), (132, None), (0, None)):
                        want = twc.core_plan(B, nW, heads, ws, s, fit)
                        fit = fit or [twc.BLOCKS_PER_SM * s // r for r in range(1, 9)]
                        arr = (ctypes.c_int * 8)(*fit)
                        assert tuple(lib.mmrp_core_plan(B, nW, heads, ws, s, arr, what)
                                     for what in range(5)) == tuple(want), \
                            (res, C, heads, B, s, ws, fit)
                        n += 1
    assert n >= 216


@pytest.mark.cuda
def test_train_step_runs_the_slice_model_through_its_plain_routes(dev):
    """One make_train_step on the slice tests' model in bf16 on the card: its
    stage-1 attention core (head dim 8, which C-F / C-B refuse) on its plain
    route, counted, with no C-F / C-B launch; the loss and the gradient norm
    finite."""
    import numpy as np

    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import (
        MultiModalConfig,
        MultiModalRetrievalModel,
        model_routes,
    )
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step
    from mmrp_tpu_torch.utils.convert import init_params

    cfg = MultiModalConfig(
        swin=SwinConfig(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2)),
        text=TextConfig.small(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64),
        joint_dim=64, num_fusion_layers=2, num_heads=4, num_classes=7, max_text_len=16)
    assert model_routes(cfg, train=True) == {"swin.stage0.core": "plain"}
    model = MultiModalRetrievalModel(cfg, dtype=torch.bfloat16, device=dev)
    init_params(model, seed=0)
    tcfg = Config(lr=1e-3)
    state = init_train_state(model, tcfg, total_steps=4, kg_dim=24)
    step = make_train_step(model, tcfg, np.ones(7, np.float32))
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((2, 56, 56, 3), dtype=np.float32),
             "input_ids": rng.integers(0, cfg.text.vocab_size, (2, 16)),
             "attention_mask": (np.arange(16)[None, :] < np.array([[16], [9]])).astype(np.int64),
             "labels": (rng.random((2, 7)) < 0.3).astype(np.float32),
             "kg_target": rng.standard_normal((2, 24)).astype(np.float32),
             "kg_target_valid": np.ones(2, np.float32)}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    before = (twc.window_attention_core.plain_calls, twc.core_forward.launches,
              twc.core_backward.launches)
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    # stage 1's two blocks, one core call each in the forward
    assert (twc.window_attention_core.plain_calls - before[0],
            twc.core_forward.launches - before[1], twc.core_backward.launches - before[2]) \
        == (2, 0, 0)
    assert np.isfinite(metrics["loss/total"]) and np.isfinite(metrics["grad_norm"])
    assert metrics["grad_norm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shift,n_pad,B", [(0, 64, 2), (3, 64, 2), (3, 49, 5)])
def test_window_attention_heads_kernel(dev, shift, n_pad, B):
    """W walks the images of each head-window over one bias tile; 5 images
    take the double buffer through an odd count, 49 tokens a ragged tile."""
    gen = torch.Generator(device=dev).manual_seed(7)
    heads, d, res = 4, 32, 28
    table = _rand(gen, (169, heads), dev, 0.5, torch.float32)
    bias2 = twa.build_combined_bias(table, 7, res, res, shift, n_pad)
    q, k, v = (_rand(gen, (B, bias2.shape[0], n_pad, d), dev) for _ in range(3))
    before = twa.window_attention_heads.launches
    with torch.no_grad():
        got = twa.window_attention_heads(q, k, v, bias2, d ** -0.5)
        want = twa.window_attention_xla(q, k, v, bias2, d ** -0.5)
    torch.cuda.synchronize()
    assert twa.window_attention_heads.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SWIN_TOL)


@pytest.mark.cuda
def test_kernels_refuse_inputs_autograd_tracks(dev):
    C = 128
    x = torch.zeros((16, C), device=dev, dtype=torch.bfloat16, requires_grad=True)
    w1 = torch.zeros((512, C), device=dev, dtype=torch.bfloat16)
    w2 = torch.zeros((C, 512), device=dev, dtype=torch.bfloat16)
    ln = torch.ones(C, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        tfm.fused_ln_mlp_residual(x, ln, ln, w1, w1[:, 0].contiguous(), w2, x[0].detach())


@pytest.mark.cuda
def test_kernels_refuse_wrong_dtype(dev):
    C = 128
    x = torch.zeros((16, C), device=dev)  # f32: the kernels take bf16
    with pytest.raises(TypeError, match="dtype"):
        tfm.fused_ln_mlp_residual(x, x[0], x[0], x.new_zeros(512, C), x.new_zeros(512),
                                  x.new_zeros(C, 512), x[0])


# -- the int8 (W8A8) forms ---------------------------------------------------------

# int8 kernel against its plain version: the same int8 products (exact int32
# sums), but a bf16 GEMM input that rounds one ulp apart (LN, attention,
# GELU summed in another order) can land one int8 step away, or move its
# row's scale; bound 8 bf16 ulps of the output, twice the bf16 kernels'
INT8_TOL = dict(atol=2.0 ** -4, rtol=2.0 ** -4)
# the pair is two blocks deep: the map between them is rounded to bf16 at
# magnitudes up to ~8 (one ulp 2^-4), and the second block's residual carries
# such a difference to outputs of any size: twice the bound
INT8_PAIR_TOL = dict(atol=2.0 ** -3, rtol=2.0 ** -3)


@pytest.mark.cuda
@pytest.mark.parametrize("ln_mode,cross,B,Nq,Nk,C,heads", [
    ("post", False, 2, 64, 64, 768, 12),
    ("pre", False, 2, 51, 51, 1024, 8),
    ("none", True, 3, 49, 64, 128, 4),
])
def test_seq_attention_int8_kernel(dev, ln_mode, cross, B, Nq, Nk, C, heads):
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _rand(gen, (B, Nq, C), dev)
    kv = _rand(gen, (B, Nk, C), dev) if cross else None
    mask = torch.where(torch.rand((B, Nk), generator=gen, device=dev) < 0.3, -1e9, 0.0)
    mask[:, 0] = 0.0
    pos = _rand(gen, (Nq, C), dev, 0.5) if ln_mode == "pre" else None
    alpha = torch.tensor(0.37, device=dev) if ln_mode == "pre" else None
    w = []
    for _ in range(4):
        w += [_rand(gen, (C, C), dev, C ** -0.5), _rand(gen, (C,), dev, 0.1)]
    ln = (1 + _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (C,), dev, 0.1, torch.float32))
    kw = dict(kv=kv, key_mask=mask, pos=pos, alpha=alpha, num_heads=heads, ln_mode=ln_mode,
              include_residual=True, residual_from_raw=ln_mode == "pre", quant=True)
    before = tfa.fused_attention.launches_int8
    with torch.no_grad():
        got = tfa.fused_attention(x, *ln, *w, **kw)
        want = tfa.attention_plain(x, *ln, *w, **kw)
    torch.cuda.synchronize()
    assert tfa.fused_attention.launches_int8 == before + 1
    torch.testing.assert_close(got.float(), want.float(), **INT8_TOL)


def _int8_block(blk):
    """The block with int8 GEMM weights, and their scales."""
    from mmrp_tpu_torch.ops.quant import quantize_weight

    blk, scales = list(blk), []
    for i in tsb.GEMM_WEIGHTS:
        blk[i], s = quantize_weight(blk[i])
        scales.append(s)
    return blk, tuple(scales)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,C,heads,H,roll", [
    ("windows_static", 1024, 32, 7, 0), ("windows_per_row", 1024, 32, 7, 0),
    ("windows_dynamic", 256, 8, 14, 0), ("windows_dynamic", 1024, 32, 7, 0),
    ("raw_dynamic", 512, 16, 14, 0), ("chain_static", 512, 16, 14, 3),
    ("chain_static", 256, 8, 28, -3)])
def test_swin_block_int8_kernel(dev, flavor, C, heads, H, roll):
    gen = torch.Generator(device=dev).manual_seed(9)
    blk, bias = _swin_block(gen, dev, C, heads, H, 3 if roll > 0 else 0)
    x = _rand(gen, (2, H, H, C), dev)
    xw = x.reshape(2, H // 7, 7, H // 7, 7, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(2, (H // 7) ** 2, 49, C).contiguous()
    q8, scales = _int8_block(blk)
    acts = (4.5 / 127, 3.0 / 127, 5.0 / 127, 2.5 / 127)
    with torch.no_grad():
        if flavor == "windows_dynamic":
            fn, counter = tsb.fused_swin_block_windows, "launches_dynamic"
            kw = dict(quant=True)
            before = getattr(fn, counter)
            got, want = fn(xw, *blk, bias, heads, **kw), tsb.swin_block_plain(xw, *blk, bias,
                                                                              heads, **kw)
        elif flavor.startswith("windows"):
            per_row = flavor == "windows_per_row"
            fn = tsb.fused_swin_block_windows
            counter = "launches_per_row" if per_row else "launches_static"
            kw = dict(quant="static", wscales=scales, act_scales=None if per_row else acts)
            before = getattr(fn, counter)
            got, want = fn(xw, *q8, bias, heads, **kw), tsb.swin_block_plain(xw, *q8, bias,
                                                                             heads, **kw)
        elif flavor == "raw_dynamic":
            fn, counter = tsb.fused_swin_block_raw, "launches_dynamic"
            before = getattr(fn, counter)
            got = fn(x, *blk, bias, heads, 7, quant=True)
            want = tsb.raw_plain(x, *blk, bias, num_heads=heads, ws=7, quant=True)
        else:
            fn, counter = tsp.fused_swin_block_chain, "launches_static"
            before = getattr(fn, counter)
            kw = dict(quant="static", wscales=scales, act_scales=acts)
            got = fn(x, q8, bias, heads, 7, roll, **kw)
            want = tsp.chain_plain(x, q8, bias, heads, 7, roll, **kw)
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1
    torch.testing.assert_close(got.float(), want.float(), **INT8_TOL)


@pytest.mark.cuda
def test_swin_pair_static_kernel(dev):
    """The static pair with calibrated scales on both blocks, on the second
    only, and on neither (per-row scales): counted as launches_static when
    both blocks have them, else launches_per_row."""
    gen = torch.Generator(device=dev).manual_seed(10)
    C, heads, H = 256, 8, 28
    (blk0, bias0), (blk1, bias1) = (_swin_block(gen, dev, C, heads, H, s) for s in (0, 3))
    (q0, s0), (q1, s1) = _int8_block(blk0), _int8_block(blk1)
    x = _rand(gen, (2, H, H, C), dev)
    acts = (4.5 / 127,) * 4
    fn = tsp.fused_swin_block_pair
    for a0, a1, counter in ((acts, acts, "launches_static"), (None, acts, "launches_per_row"),
                            (None, None, "launches_per_row")):
        kw = dict(quant="static", wscales0=s0, wscales1=s1, act_scales0=a0, act_scales1=a1)
        before = getattr(fn, counter)
        with torch.no_grad():
            got = fn(x, q0, bias0, q1, bias1, heads, 7, 3, **kw)
            want = tsp.pair_plain(x, q0, bias0, q1, bias1, heads, 7, 3, **kw)
        torch.cuda.synchronize()
        assert getattr(fn, counter) == before + 1, counter
        torch.testing.assert_close(got.float(), want.float(), **INT8_PAIR_TOL)


@pytest.mark.cuda
def test_int_mm_matches_exact_product(dev):
    """quant_dot's cuBLASLt int8 product, rows padded past 16, is exact."""
    from mmrp_tpu_torch.ops.quant import exact_int_matmul, int_mm

    gen = torch.Generator(device=dev).manual_seed(11)
    for M in (8, 392, 512):
        xq = torch.randint(-127, 128, (M, 3072), generator=gen, device=dev).to(torch.int8)
        wq = torch.randint(-127, 128, (768, 3072), generator=gen, device=dev).to(torch.int8)
        assert torch.equal(int_mm(xq, wq), exact_int_matmul(xq, wq))


# The attention launch that K1 and the whole Swin block share
# (csrc/attention.cuh::window_attn_wgmma) and K1's projection (k1_proj_wgmma).


def _k1_inputs(gen, dev, B, nW, ws, C, heads, shift=0):
    """K1's arguments on B images of nW ws x ws windows."""
    H = int(round(nW ** 0.5)) * ws
    table = _rand(gen, ((2 * ws - 1) ** 2, heads), dev, 0.5, torch.float32)
    return (_rand(gen, (B, nW, ws * ws, C), dev), 1 + _rand(gen, (C,), dev, 0.1, torch.float32),
            _rand(gen, (C,), dev, 0.1, torch.float32), _rand(gen, (3 * C, C), dev, C ** -0.5),
            _rand(gen, (3 * C,), dev, 0.1), _rand(gen, (C, C), dev, C ** -0.5),
            _rand(gen, (C,), dev, 0.1), tfw.build_bias_full(table, ws, H, H, shift), heads)


def _k1_check(args, residual=True):
    fn = tfw.fused_window_attention_windows
    before = fn.launches
    with torch.no_grad():
        got = fn(*args, include_residual=residual)
        want = tfw.window_attention_plain(*args, include_residual=residual)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **SWIN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 9))
def test_attention_kernel_at_every_split(dev, splits):
    """C 1024 (8 head groups of 4 heads, the tight shared-memory layout) over
    as many windows as make the host split each window's groups over
    ``splits`` blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    windows = -(-sms // splits)
    assert tfw.attn_splits(windows, 1024, sms) == splits
    gen = torch.Generator(device=dev).manual_seed(17)
    _k1_check(_k1_inputs(gen, dev, windows, 1, 7, 1024, 32))


# (C, heads, ws, B, nW, residual): head dims 32 / 64 / 128; C 96, 64, 192 and
# 320 (a zero-filled last K chunk, a last head group of fewer heads); N 49 and 9
ATTN_FORMS = [(96, 3, 7, 2, 4, True), (96, 3, 3, 3, 4, True), (192, 6, 7, 2, 1, False),
              (64, 1, 7, 2, 4, True), (320, 5, 3, 2, 4, True), (1024, 16, 7, 3, 1, True),
              (1024, 8, 3, 5, 1, True), (512, 4, 7, 2, 4, True), (128, 4, 7, 2, 16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("C,heads,ws,B,nW,residual", ATTN_FORMS)
def test_attention_kernel_forms(dev, C, heads, ws, B, nW, residual):
    gen = torch.Generator(device=dev).manual_seed(18)
    _k1_check(_k1_inputs(gen, dev, B, nW, ws, C, heads, shift=ws // 2 if nW > 1 else 0),
              residual)


# the whole block's attention launch on the map (rows gathered by map_row, the
# output rolled), in bf16, static W8A8 with calibrated scales ("static") or
# per-row scales ("per_row"), and the dynamic _qdot (True): (flavor, C, heads,
# ws, H, roll, quant)
BLOCK_ATTN_FORMS = [("chain", 96, 3, 7, 14, 3, False), ("chain", 96, 3, 3, 9, -1, False),
                    ("chain", 1024, 32, 7, 14, -3, False),
                    ("chain", 1024, 32, 7, 14, 3, "static"),
                    ("chain", 256, 8, 7, 28, -3, "per_row"),
                    ("windows", 1024, 32, 7, 7, 0, "per_row"),
                    ("windows", 192, 6, 3, 6, 0, "static"), ("raw", 96, 3, 7, 14, 0, True),
                    ("raw", 128, 2, 3, 6, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,C,heads,ws,H,roll,quant", BLOCK_ATTN_FORMS)
def test_swin_block_attention_forms(dev, flavor, C, heads, ws, H, roll, quant):
    gen = torch.Generator(device=dev).manual_seed(19)
    blk, bias = _swin_block(gen, dev, C, heads, H, ws // 2 if roll > 0 else 0, ws)
    x = _rand(gen, (2, H, H, C), dev)
    kw, tol, counter = {}, SWIN_TOL, "launches"
    if quant in ("static", "per_row"):
        blk, scales = _int8_block(blk)
        acts = (4.5 / 127, 3.0 / 127, 5.0 / 127, 2.5 / 127) if quant == "static" else None
        kw = dict(quant="static", wscales=scales, act_scales=acts)
        tol, counter = INT8_TOL, "launches_static" if acts else "launches_per_row"
    elif quant:
        kw = dict(quant=True)
        tol, counter = INT8_TOL, "launches_dynamic"
    with torch.no_grad():
        if flavor == "chain":
            fn = tsp.fused_swin_block_chain
            before = getattr(fn, counter)
            got = fn(x, blk, bias, heads, ws, roll, **kw)
            want = tsp.chain_plain(x, blk, bias, heads, ws, roll, **kw)
        elif flavor == "raw":
            fn = tsb.fused_swin_block_raw
            before = getattr(fn, counter)
            got = fn(x, *blk, bias, heads, ws, **kw)
            want = tsb.raw_plain(x, *blk, bias, num_heads=heads, ws=ws, **kw)
        else:
            fn = tsb.fused_swin_block_windows
            xw = x.reshape(2, H // ws, ws, H // ws, ws, C).permute(0, 1, 3, 2, 4, 5) \
                .reshape(2, (H // ws) ** 2, ws * ws, C).contiguous()
            before = getattr(fn, counter)
            got = fn(xw, *blk, bias, heads, **kw)
            want = tsb.swin_block_plain(xw, *blk, bias, heads, **kw)
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_attention_layout_is_the_kernels_host_code(dev):
    """The Python copies of the attention launch's shared-memory layout and
    split (which ``kernel_takes`` and chip_smoke.py read) against the host code
    that launches it."""
    from mmrp_tpu_torch.ops import _build

    lib = _build.library()
    n = 0
    for C in range(16, 1024 + 1, 16):
        for D in (32, 64, 128):
            smem = tfw.attention_smem(C, D)
            assert lib.mmrp_attention_smem(C, D) == (smem if smem <= tfw.MAX_SMEM else 0), (C, D)
        for windows in (1, 7, 8, 17, 33, 64, 132, 512, 4096):
            for sms in (1, 114, 132):
                assert lib.mmrp_attn_splits(windows, C, sms) == \
                    tfw.attn_splits(windows, C, sms), (windows, C, sms)
                n += 1
    assert n > 1500
