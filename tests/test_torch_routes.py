"""The kernel-or-plain plan of the port's models (CPU).

Every kernel call site of a model has a route fixed at construction from the
kernel wrappers' ``kernel_takes``: ``kernel``, ``plain`` (the kernel's plain
version, on any device, counted in the wrapper's ``plain_calls``) or
``int8`` (a W8A8 XLA branch of the JAX model); a Swin step is named by its
route or ``plain``. The flagship has no plain route at any serving precision
or text length; the slice tests' model and the micro preset name theirs; each
``kernel_takes`` holds its kernel's limits; and a model whose shapes no
kernel takes serves through its plain routes, counted, and matches JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.multimodal import (
    MultiModalConfig,
    MultiModalRetrievalModel,
    model_routes,
    plain_routes,
)
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.ops import fused_attention as K3
from mmrp_tpu_torch.ops import fused_mlp as K2
from mmrp_tpu_torch.ops import fused_swin_block as SB
from mmrp_tpu_torch.ops import fused_swin_pair as SP
from mmrp_tpu_torch.ops import fused_window_attention as K1
from mmrp_tpu_torch.utils.convert import load_flax_params
from test_torch_slice import KEYS, TOL, inputs, randomize, run_jax

SLICE = MultiModalConfig(  # tests/test_torch_slice.py's model
    swin=SwinConfig(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2)),
    text=TextConfig.small(hidden_dim=32, num_layers=1, num_heads=2, intermediate_dim=64),
    joint_dim=64, num_fusion_layers=2, num_heads=4, num_classes=7, max_text_len=16)


@pytest.mark.parametrize("serve_quant", ["none", "int8", "int8_static"])
@pytest.mark.parametrize("text_len", [64, 128, 512])
def test_flagship_plan_has_no_plain_route(serve_quant, text_len):
    """Routes are fixed at construction from the most tokens a site can see
    (the fusion stack's text_dim, BERT's 512 positions)."""
    fields = dict(serve_quant=serve_quant, text_dim=text_len)
    cfg = MultiModalConfig.from_config(Config(**fields), flagship=True)
    routes = model_routes(cfg)
    assert plain_routes(cfg) == []
    assert [routes[f"swin.stage{s}.step0"] for s in range(4)] == \
        ["k1k2", "pair", "chain", "windows"]
    assert sum(k.startswith("swin.") for k in routes) == 2 + 1 + 18 + 2
    fusion = {k: v for k, v in routes.items() if k.startswith("fusion.")}
    want = "int8" if serve_quant != "none" else "kernel"
    assert set(fusion.values()) == {want} and len(fusion) == 6
    assert routes["text.attention"] == "kernel"  # K3, bf16 or its in-kernel W8A8
    # the same plan on a model built on the meta device
    if text_len == 64:
        assert MultiModalRetrievalModel(cfg, device="meta").routes == routes


def test_small_models_name_their_plain_routes():
    # head dims 8 and 16 everywhere; the fusion FFN (C 64, Hd 256) is K2's
    routes = model_routes(SLICE)
    assert routes.pop("fusion.ffn") == "kernel"
    assert set(routes.values()) == {"plain"} and len(routes) == 2 + 2 + 1 + 5
    micro = MultiModalConfig.from_config(Config(image_backbone="swin_micro"))
    routes = model_routes(micro)
    # Swin-micro at 224 px: one stage of head dim 8; the 32-wide text tower;
    # 3136 patches, past K3's 512 tokens, for the image-side fusion attentions
    assert routes["swin.stage0.step0"] == routes["text.attention"] == "plain"
    assert {k: routes[f"fusion.{k}"] for k in ("txt_enh", "img_enh", "txt2img", "img2txt",
                                               "self_attention", "ffn")} == \
        {"txt_enh": "kernel", "img_enh": "plain", "txt2img": "plain", "img2txt": "plain",
         "self_attention": "plain", "ffn": "kernel"}
    # use_pallas_attention=False: every Swin step plain, on the K1 + K2 route
    off = MultiModalConfig.from_config(Config(use_pallas_attention=False), flagship=True)
    swin = {k: v for k, v in model_routes(off).items() if k.startswith("swin.")}
    assert set(swin.values()) == {"plain"} and len(swin) == 24


def test_kernel_takes_holds_the_kernels_limits():
    # K3: head dims 32 / 64 / 128, C % 128 == 0 up to 1024, 1..512 tokens
    assert K3.kernel_takes(768, 12, 512) and K3.kernel_takes(1024, 8, 49, 512)
    assert K3.kernel_takes(128, 4, 1)
    for args in ((768, 12, 513), (1024, 8, 49, 513), (64, 2, 16), (1280, 10, 64),
                 (1024, 64, 64), (96, 3, 64), (1024, 8, 0)):
        assert not K3.kernel_takes(*args), args
    # K1: head dims 32 / 64 / 128, at most 64 tokens per window
    assert K1.kernel_takes(128, 4, 49) and K1.kernel_takes(64, 2, 64)
    for args in ((16, 2, 49), (128, 4, 65), (48, 2, 49), (1024, 4, 49)):
        assert not K1.kernel_takes(*args), args
    # K2: C % 16 == 0 up to 1024; Hd split into multiples of 128 of at most 512
    # whose layout fits one block (the fewest ranks; C 1024 Hd 1024 needs 4)
    for C, Hd, S in ((128, 512, 1), (256, 1024, 2), (512, 2048, 4), (1024, 4096, 8),
                     (768, 3072, 8), (128, 384, 1), (96, 384, 1), (192, 768, 2),
                     (64, 256, 1), (1024, 1024, 4), (768, 1024, 4)):
        assert K2.kernel_takes(C, Hd) and K2.mlp_cluster_size(1, Hd, 2 * C) == S, (C, Hd)
    for C, Hd in ((72, 288), (1280, 5120), (128, 200), (1024, 8192), (128, 640)):
        assert not K2.kernel_takes(C, Hd), (C, Hd)
    # the whole block: the attention phase's limits and the MLP's; the per-row
    # int8 forms keep the C % 32 epilogue
    acts = (0.1,) * 4
    for quant, a in ((False, None), ("static", acts), ("static", None), (True, None)):
        assert SB.kernel_takes(1024, 32, 49, 4096, quant, a)
        assert SP.kernel_takes(512, 16, 7, 2048, quant, a)
        assert not SB.kernel_takes(16, 2, 49, 64, quant, a)
    assert SB.wgmma_epilogue(False) and SB.wgmma_epilogue("static", acts)
    assert not SB.wgmma_epilogue("static", None) and not SB.wgmma_epilogue(True)
    # C 96 (Swin-T stage 1): bf16 and the int8 forms; C 48 (head dim 16): none
    for quant, a in ((False, None), ("static", acts), ("static", None), (True, None)):
        assert SB.kernel_takes(96, 3, 49, 384, quant, a)
        assert not SB.kernel_takes(48, 3, 49, 192, quant, a)
    # past C 1024 (head dim 32 at 33 heads): none
    assert not SB.kernel_takes(1056, 33, 49, 4224)


def _header_constants():
    """The integer constants of the MLP kernels' headers, evaluated."""
    import re
    from pathlib import Path

    csrc = Path(K2.__file__).resolve().parent.parent / "csrc"
    names = {}
    for header in ("common.cuh", "gemm_sm90.cuh", "mlp_sm90.cuh", "attention.cuh"):
        for decl in re.findall(r"^constexpr (?:int|size_t) ([^;]*);", (csrc / header).read_text(),
                               re.M):
            for item in decl.split(","):
                name, expr = (part.strip() for part in item.split("=", 1))
                names[name] = int(eval(expr, {}, dict(names)))
    return names


@pytest.mark.parametrize("staged", [2, 4])
def test_mlp_kernel_takes_is_the_layout_limit(staged):
    """``fused_mlp`` copies csrc/mlp_sm90.cuh's limits: its constants are the
    headers', and over a grid of widths and MLP ratios its predicate says yes
    exactly where some cluster of 1, 2, 4 or 8 ranks gives each a hidden slice
    (a multiple of 128, at most kSpanMax) and ``mlp_layout`` fits kMaxSmem,
    staged rows included (K2: 2 bytes per element, the block's epilogue: 4)."""
    k = _header_constants()
    assert (K2.SPAN_MAX, K2.MAX_SMEM, K2.TILE_M, K2.TILE_N) == \
        (k["kSpanMax"], k["kMaxSmem"], k["kTileM"], k["kTileN"])
    assert (K2.RING_BYTES, K2.RED_BYTES) == (k["kRingBytes"], k["kTileM"] * k["kRedLd"] * 4)

    def layout_total(span, rows):  # mlp_sm90.cuh::mlp_layout
        return span * 2 // 128 * k["kChunkA"] + k["kRingBytes"] + \
            k["kTileM"] * k["kRedLd"] * 4 + rows + 1024

    taken = 0
    for C in range(16, 1040 + 1, 16):
        ratios = {int(C * ratio) for ratio in (1.0, 2.0, 3.0, 4.0, 4.5, 8.0)}
        for Hd in sorted(ratios | set(range(128, 8192 + 1, 128))):
            fits = [S for S in (1, 2, 4, 8) if Hd % (S * 128) == 0 and Hd // S <= 512
                    and layout_total(Hd // S, k["kTileM"] // S * C * staged) <= k["kMaxSmem"]]
            want = C <= 1024 and bool(fits)
            assert K2.kernel_takes(C, Hd, staged) == want, (C, Hd)
            if want:
                taken += 1
                assert K2.mlp_cluster_size(1, Hd, staged * C) == fits[0], (C, Hd)
    assert taken > 400


# (C, heads) of every stage of the Swin presets at 224 px: Swin-T / Swin-S
# (and medclip), Swin-B, Swin-micro
SWIN_STAGES = [(96, 3), (192, 6), (384, 12), (768, 24), (128, 4), (256, 8), (512, 16),
               (1024, 32), (16, 2)]


def test_attention_kernel_takes_is_the_layout_limit():
    """``fused_window_attention`` copies csrc/attention.cuh's limits: its
    constants are the headers', its predicate says yes exactly where the head
    dim is 32, 64 or 128, 1 <= N <= 64, C % 16 == 0 up to kAttnMaxC and
    ``attn_layout`` fits kMaxSmem, and it takes every shape the earlier
    predicate (head dim and N only) took up to C 1024; the whole block keeps
    every preset stage in every precision."""
    k = _header_constants()
    assert (K1.TILE_M, K1.TILE_N, K1.CHUNK_A, K1.CHUNK_W, K1.SLOTS, K1.MAX_SMEM, K1.MAX_C) == \
        (k["kTileM"], k["kTileN"], k["kChunkA"], k["kChunkW"], k["kAttnSlots"], k["kMaxSmem"],
         k["kAttnMaxC"])

    def layout(C, D):  # attention.cuh::attn_layout: [total] if it fits one block
        total = ((C * 2 + 127) // 128 * k["kChunkA"] + k["kAttnSlots"] * k["kChunkW"]
                 + 2 * (k["kTileN"] // D) * k["kTileM"] * (D + 8) * 2 + k["kTileM"] * 4 + 1024)
        return [total] if total <= k["kMaxSmem"] else []

    widths = sorted(set(range(16, 1104 + 1, 16)) | {C for C, _ in SWIN_STAGES} | {40, 1000})
    taken = 0
    for C in widths:
        for heads in sorted({1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 33}
                            | {C // d for d in (32, 64, 128)}):
            if heads < 1 or C % heads:
                continue
            D = C // heads
            fits = layout(C, D) if D in (32, 64, 128) else []
            if fits:
                assert K1.attention_smem(C, D) == fits[0], (C, D)
            for N in (0, 1, 9, 49, 64, 65):
                want = (D in (32, 64, 128) and 1 <= N <= 64 and C % 16 == 0
                        and C <= k["kAttnMaxC"] and bool(fits))
                assert K1.kernel_takes(C, heads, N) == want, (C, heads, N)
                taken += want
                if D in (32, 64, 128) and 1 <= N <= 64 and C <= 1024:  # the earlier predicate
                    assert K1.kernel_takes(C, heads, N), (C, heads, N)
    assert taken > 200
    # the split of a window's head groups over blocks: the fewest with
    # windows x splits >= the SMs, at most one a group (Swin-B at batch 8 and 64)
    for windows, C, splits in ((512, 128, 1), (128, 256, 2), (32, 512, 4), (8, 1024, 8),
                               (4096, 128, 1), (256, 512, 1), (64, 1024, 3)):
        assert K1.attn_splits(windows, C, 132) == splits, (windows, C)
    acts = (0.1,) * 4
    for C, heads in SWIN_STAGES[:-1]:
        assert K1.kernel_takes(C, heads, 49)
        for quant, a in ((False, None), ("static", acts), ("static", None), (True, None)):
            assert SB.kernel_takes(C, heads, 49, 4 * C, quant, a), (C, quant, a)
    assert not K1.kernel_takes(*SWIN_STAGES[-1], 49)  # head dim 8


@pytest.mark.parametrize("name", ["swin_tiny", "swin_small", "medclip"])
@pytest.mark.parametrize("quant", ["none", "int8", "int8_static"])
def test_swin_tiny_and_small_run_every_step_on_a_kernel(name, quant):
    """Swin-T, Swin-S and medclip (Swin-T) at 224 px: C 96 / 192 / 384 / 768,
    head dim 32: every step of every stage on a kernel, stages 1-2 on K1 + K2
    at C 96 and 192."""
    from mmrp_tpu_torch.models.swin import plan_names

    cfg = MultiModalConfig.from_config(Config(image_backbone=name, serve_quant=quant))
    depth3 = 18 if name == "swin_small" else 6
    # serve_quant "int8" keeps the Swin tower in bf16
    late = {"none": ("chain", "windows"), "int8": ("chain", "windows"),
            "int8_static": ("chain", "chain")}[quant]
    assert plan_names(cfg.swin) == [["k1k2"] * 2, ["k1k2"] * 2, [late[0]] * depth3,
                                    [late[1]] * 2]
    assert not [r for r in plain_routes(cfg) if r.startswith("swin.")]


def test_micro_from_config_serves_through_plain_routes_like_jax(monkeypatch):
    """serving_forward of from_config(Config(image_backbone="swin_micro"))
    (narrowed so the CPU run is quick) against the JAX model of the same
    Config, with every plain route counted."""
    monkeypatch.delenv("MMRP_FORCE_PALLAS", raising=False)
    fields = dict(image_backbone="swin_micro", image_size=28, joint_dim=64,
                  num_fusion_layers=2, num_heads=4, text_dim=16)
    pcfg = MultiModalConfig.from_config(Config(**fields))
    jmodel = jmm.MultiModalRetrievalModel(jmm.MultiModalConfig.from_config(JConfig(**fields)))
    img, ids, mask = inputs()
    img = img[:, :28, :28]
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(img),
                                            jnp.asarray(ids), jnp.asarray(mask))["params"])
    model = MultiModalRetrievalModel(pcfg, device="cpu").eval()
    load_flax_params(model, params)
    counters = (K1.fused_window_attention_windows, K2.fused_ln_mlp_residual,
                K3.fused_attention)
    for fn in counters:
        monkeypatch.setattr(fn, "plain_calls", 0)
    got = serving_forward(model)(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask))
    want = run_jax(jmodel, params, img, ids, mask)
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **TOL)
    # one Swin block: K1 + K2; the text tower's attention; per fusion layer
    # five attentions, none of which the kernels take here (the FFN, C 64,
    # is K2's: its CPU tensors run the plain version uncounted)
    assert [fn.plain_calls for fn in counters] == [1, 1, 1 + 2 * 5]
