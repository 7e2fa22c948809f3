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


def _swin_block(gen, dev, C, heads, H, shift):
    """12 block tensors (nn.Linear layout) and the (nW, h, 49, 49) bias_full."""
    ws, Hd = 7, 4 * C
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
