"""The port's other vision towers and fusion variants against JAX's, on the CPU.

Each tower (``models/{vit,resnet,efficientnet,medclip}.py``) at reduced depth
with the same randomized Flax weights in both packages (through
``utils/convert.py``: conv kernels to (out, in / groups, kh, kw), the
depthwise convs included, GroupNorm ``scale``), the conv towers at an even
and an odd image size (Flax's ``SAME`` pads the odd element after: 3x3/2
convs (0, 1), the 7x7/2 stem (2, 3), the max-pool with -inf); the full-size
``Backbones`` of every tower by parameter shapes (``jax.eval_shape``), and the
ViT one output for output; ``MultiModalRetrievalModel`` with
``use_shared_ffn`` and with ``use_cls_only`` against JAX's, with the plain
routes counted where JAX's FusionLayer leaves its Pallas kernels for its XLA
branch; ``ref_port.reference_forward`` in each mode against JAX's; and the
explain engine's ViT branch (``cls_global``) against JAX's.

Tolerances: towers 1e-4 of the output's largest magnitude (f32, sums in
other orders, GroupNorm and LayerNorm variance in one pass against two);
MedCLIP, the whole model and ``ref_port`` rtol / atol 1e-4 (the Swin tests');
explain maps rtol 1e-4 / atol 1e-5 (``tests/test_torch_explain.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.api import serving_forward as jax_serving_forward
from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.models import efficientnet as jeff
from mmrp_tpu.models import medclip as jmedclip
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models import ref_port as jref
from mmrp_tpu.models import resnet as jresnet
from mmrp_tpu.models import swin as jswin
from mmrp_tpu.models import vit as jvit
from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models import efficientnet, medclip, ref_port, resnet, vit
from mmrp_tpu_torch.models.layers import same_pads
from mmrp_tpu_torch.models.multimodal import (
    Backbones,
    MultiModalConfig,
    MultiModalRetrievalModel,
    model_routes,
    plain_routes,
    vision_dims,
)
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.ops import fused_attention as K3
from mmrp_tpu_torch.ops import fused_mlp as K2
from mmrp_tpu_torch.ops import fused_window_attention as K1
from mmrp_tpu_torch.utils.convert import (
    flax_to_state_dict,
    init_params,
    load_flax_params,
    state_dict_to_flax_flat,
)
from test_torch_config import jax_param_shapes
from test_torch_slice import KEYS

TOL = dict(rtol=1e-4, atol=1e-4)


def assert_close_scaled(got, want, what=""):
    """|got - want| <= 1e-4 * max |want|."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), f"{what}: {err} vs scale {np.abs(want).max()}"


def jax_params(module, *args, seed=0):
    """Seeded parameters of the shapes ``module.init`` gives (traced, not
    compiled: a jitted init costs seconds here), each leaf nonzero: kernels
    N(0, 1 / fan_in), LN / GroupNorm scales 1 + N(0, 0.02^2), ``alpha``
    0.5 + N(0, 0.02^2), everything else N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def fill(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            dense_general_in = leaf.ndim == 3 and path[-2].key != "out"
            fan_in = leaf.shape[0] if dense_general_in else int(np.prod(leaf.shape[:-1]))
            return jnp.asarray(noise / np.sqrt(fan_in))
        if name == "scale":
            return jnp.asarray(1 + 0.02 * noise)
        return jnp.asarray((0.5 if name == "alpha" else 0.0) + 0.02 * noise)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_tower(module, img, seed=0):
    params = jax_params(module, jnp.asarray(img), seed=seed)
    return params, jax.jit(lambda p, x: module.apply({"params": p}, x))(params, jnp.asarray(img))


def port_tower(tower, params, img):
    tower.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        return tower.eval()(torch.from_numpy(img))


def test_same_pads_is_flax():
    """The (before, after) pads of Flax's SAME, and a stride-2 conv of the
    port against lax.conv_general_dilated at both parities."""
    assert same_pads(224, 3, 2) == (0, 1) and same_pads(224, 7, 2) == (2, 3)
    assert same_pads(225, 3, 2) == (1, 1) and same_pads(28, 5, 2) == (1, 2)
    assert same_pads(224, 16, 16) == (0, 0) and same_pads(56, 1, 2) == (0, 0)
    from mmrp_tpu_torch.models.layers import Conv, max_pool_same

    rng = np.random.default_rng(0)
    for size in (10, 11):
        x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
        k = rng.standard_normal((5, 5, 4, 6)).astype(np.float32)
        want = jax.lax.conv_general_dilated(x, k, (2, 2), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        conv = Conv(4, 6, 5, 2, device="cpu")
        conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
        with torch.no_grad():
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        from flax import linen as fnn

        pooled = fnn.max_pool(jnp.asarray(-np.abs(x)), (3, 3), strides=(2, 2), padding="SAME")
        got = max_pool_same(torch.from_numpy(-np.abs(x)).permute(0, 3, 1, 2), 3, 2)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(pooled))


def test_vit_tower_matches_jax():
    cfg = dict(img_size=32, num_layers=1)
    img = np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32)
    params, want = jax_tower(jvit.ViTEncoder(jvit.ViTConfig.small(**cfg)), img)
    got = port_tower(vit.ViTEncoder(vit.ViTConfig.small(**cfg), device="cpu"), params, img)
    assert got["patches"].shape == (2, 4, 192)
    for key in ("patches", "global"):
        assert_close_scaled(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_tower_matches_jax(size):
    """Two stages of one bottleneck each, width 32 (GroupNorm(32) per channel)."""
    fields = dict(stage_sizes=(1, 1), width=32)
    img = np.random.default_rng(size).random((2, size, size, 3), dtype=np.float32)
    params, want = jax_tower(jresnet.ResNetEncoder(jresnet.ResNetConfig(**fields)), img)
    tower = resnet.ResNetEncoder(resnet.ResNetConfig(**fields), device="cpu")
    got = port_tower(tower, params, img)
    assert got["patches"].shape[1] == tower.config.num_patches(size) == \
        np.asarray(want["patches"]).shape[1]
    for key in ("patches", "global"):
        assert_close_scaled(got[key].numpy(), want[key], key)


EFF_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 5), (6, 40, 1, 2, 3))


@pytest.mark.parametrize("size", [32, 33])
def test_efficientnet_tower_matches_jax(size):
    """Three stages (a 5x5/2 depthwise, a residual MBConv), head 64."""
    fields = dict(stem_channels=16, head_channels=64, stages=EFF_STAGES)
    img = np.random.default_rng(size).random((2, size, size, 3), dtype=np.float32)
    params, want = jax_tower(jeff.EfficientNetEncoder(jeff.EfficientNetConfig(**fields)), img)
    tower = efficientnet.EfficientNetEncoder(efficientnet.EfficientNetConfig(**fields),
                                             device="cpu")
    got = port_tower(tower, params, img)
    assert got["patches"].shape[1] == tower.config.num_patches(size)
    for key in ("patches", "global"):
        assert_close_scaled(got[key].numpy(), want[key], key)


def test_medclip_tower_matches_jax():
    swin = dict(img_size=56, embed_dim=16, depths=(2, 2), num_heads=(2, 2))
    img = np.random.default_rng(3).random((2, 56, 56, 3), dtype=np.float32)
    module = jmedclip.MedCLIPVisionEncoder(swin=jswin.SwinConfig(**swin, use_pallas=False),
                                           proj_dim=24)
    params, want = jax_tower(module, img)
    got = port_tower(medclip.MedCLIPVisionEncoder(SwinConfig(**swin), 24, device="cpu"),
                     params, img)
    for key in ("patches", "global"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("backbone", ["medclip", "vit", "resnet50", "efficientnet"])
def test_full_size_models_have_jax_parameter_shapes(backbone):
    """Every tower at 224 px in the whole model: the same parameters and
    shapes as JAX's (``jax.eval_shape``), the bridge's round trip exact, and
    the tower no kernel call site where JAX computes it in XLA."""
    fields = dict(image_backbone=backbone)
    jcfg = jmm.MultiModalConfig.from_config(JConfig(**fields))
    pcfg = MultiModalConfig.from_config(Config(**fields))
    want = jax_param_shapes(jcfg, 16)
    model = MultiModalRetrievalModel(pcfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert vision_dims(pcfg) == {"medclip": (49, 512), "vit": (196, 192),
                                 "resnet50": (49, 2048), "efficientnet": (49, 1280)}[backbone]
    swin_sites = [k for k in model_routes(pcfg) if k.startswith("swin.")]
    assert bool(swin_sites) == (backbone == "medclip")
    assert plain_routes(pcfg) == []  # every call site of these shapes on a kernel


def test_backbones_vit_matches_jax():
    """JAX's Backbones with its fixed ViT-small at 32 px (the image modality:
    no text tower), against the port's on the same weights."""
    fields = dict(image_backbone="vit", image_size=32, text_dim=8, modality="image")
    jcfg = jmm.MultiModalConfig.from_config(JConfig(**fields))
    rng = np.random.default_rng(4)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    ids = rng.integers(0, 8192, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    module = jmm.Backbones(jcfg)
    params = jax_params(module, img, ids, mask)
    want = jax.jit(lambda p: module.apply({"params": p}, img, ids, mask))(params)
    tower = Backbones(MultiModalConfig.from_config(Config(**fields)), device="cpu").eval()
    tower.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(img), torch.from_numpy(ids).long(),
                    torch.from_numpy(mask).long())
    assert got.keys() == want.keys()
    for key in want:
        assert_close_scaled(got[key].numpy(), want[key], key)


def test_init_params_and_the_bridge_cover_the_towers():
    """init_params leaves no parameter at zero in any tower (at reduced
    depth) or in a micro model with the shared FFN; the bridge's flat tree
    maps back onto the same state dict exactly, a root module's own
    parameters (the ViT's cls token, the image modality's null token) under
    their bare names."""
    micro = MultiModalConfig.from_config(Config(image_backbone="swin_micro", image_size=28,
                                                joint_dim=32, num_heads=2, num_fusion_layers=1,
                                                text_dim=8, use_shared_ffn=True))
    modules = {
        "vit": vit.ViTEncoder(vit.ViTConfig.small(img_size=32, num_layers=1), device="cpu"),
        "resnet": resnet.ResNetEncoder(resnet.ResNetConfig(stage_sizes=(1, 1), width=32),
                                       device="cpu"),
        "efficientnet": efficientnet.EfficientNetEncoder(efficientnet.EfficientNetConfig(
            stem_channels=16, head_channels=64, stages=EFF_STAGES), device="cpu"),
        "medclip": medclip.MedCLIPVisionEncoder(SwinConfig.micro(), 24, device="cpu"),
        "model": MultiModalRetrievalModel(micro, device="cpu"),
        "image_model": MultiModalRetrievalModel(dataclasses.replace(micro, mode="image"),
                                                device="cpu"),
    }
    for what, module in modules.items():
        init_params(module, seed=1)
        for name, p in module.named_parameters():
            assert (p != 0).float().mean() > 0.999, (what, name)
        flat = state_dict_to_flax_flat(module)
        assert not [k for k in flat if k.startswith("/")], what
        back = flax_to_state_dict(flat)
        state = module.state_dict()
        assert back.keys() == state.keys()
        for k in state:
            assert torch.equal(back[k], state[k]), (what, k)


# -- the fusion variants -------------------------------------------------------

MICRO = dict(image_backbone="swin_micro", image_size=28, joint_dim=128, num_heads=4,
             num_fusion_layers=1, text_dim=16)


def jax_fused_calls(jmodel, img, ids, mask, monkeypatch):
    """The JAX model's kernel calls when its Pallas path is on
    (``MMRP_FORCE_PALLAS=1``), traced with abstract parameters, not run:
    {the FusionLayers' self-attention (the call with the positions and the
    residual of its input), K2 (the FusionLayers' FFN and the micro Swin
    block's MLP)}."""
    from mmrp_tpu.ops import fused_attention as jK3
    from mmrp_tpu.ops import fused_mlp as jK2

    calls = {"self_attention": 0, "ffn": 0}
    real_attn, real_mlp = jK3.fused_attention, jK2.fused_ln_mlp_residual

    def attn(*a, **kw):
        # the enhancers fold their positions in too, with the raw-x residual
        calls["self_attention"] += kw.get("pos") is not None and not kw.get("residual_from_raw")
        return real_attn(*a, **kw)

    def mlp(*a, **kw):
        calls["ffn"] += 1
        return real_mlp(*a, **kw)

    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, ids, mask)
    with monkeypatch.context() as m:
        m.setenv("MMRP_FORCE_PALLAS", "1")
        m.setattr(jK3, "fused_attention", attn)
        m.setattr(jK2, "fused_ln_mlp_residual", mlp)
        jax.eval_shape(lambda p: jmodel.apply(p, img, ids, mask), params)
    return calls


@pytest.mark.parametrize("variant", ["use_shared_ffn", "use_cls_only"])
def test_fusion_variant_matches_jax(variant, monkeypatch):
    """The whole model on the micro Swin with 128-wide fusion (head dim 32:
    K3 and K2 take its self-attention and FFN): the serving outputs as JAX's
    XLA path; the plain routes where JAX's FusionLayer leaves its kernels for
    its XLA branch (with the shared FFN its self-attention and FFN, one plain
    call each per layer; without it JAX calls its kernels there and the
    port's plan has no plain fusion route). With the shared FFN also the
    training route's forward (dropout and drop path 0) against JAX's."""
    fields = dict(MICRO, **{variant: True})
    jcfg = jmm.MultiModalConfig.from_config(JConfig(**fields))
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    rng = np.random.default_rng(5)
    img = rng.random((2, 28, 28, 3), dtype=np.float32)
    ids = rng.integers(0, 8192, (2, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < np.array([16, 7])[:, None]).astype(np.int32)
    params = jax_params(jmodel, img, ids, mask)
    pcfg = MultiModalConfig.from_config(Config(**fields))
    model = MultiModalRetrievalModel(pcfg, device="cpu").eval()
    load_flax_params(model, params)
    shared = variant == "use_shared_ffn"
    assert ("shared_ffn.Dense_0.weight" in model.state_dict()) == shared
    assert ("fusion_layer0.ffn.Dense_0.weight" in model.state_dict()) != shared
    counters = (K1.fused_window_attention_windows, K2.fused_ln_mlp_residual, K3.fused_attention)
    for fn in counters:
        monkeypatch.setattr(fn, "plain_calls", 0)
    got = serving_forward(model)(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask).long())
    want = jax.jit(jax_serving_forward(jmodel))(params, img, ids, mask)
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    layers = MICRO["num_fusion_layers"]
    default = jmm.MultiModalRetrievalModel(jmm.MultiModalConfig.from_config(JConfig(**MICRO)))
    assert jax_fused_calls(default, img, ids, mask, monkeypatch) == \
        {"self_attention": layers, "ffn": layers + 1}
    assert jax_fused_calls(jmodel, img, ids, mask, monkeypatch) == \
        ({"self_attention": 0, "ffn": 1} if shared else
         {"self_attention": layers, "ffn": layers + 1})
    fusion_plain = {k for k in plain_routes(pcfg) if k.startswith("fusion.")}
    assert fusion_plain == ({"fusion.self_attention", "fusion.ffn"} if shared else set())
    # the micro Swin block (K1 + K2) and the 32-wide text layer are plain
    # routes in any case; the shared FFN adds one K3 and one K2 call a layer
    extra = layers if shared else 0
    assert [fn.plain_calls for fn in counters] == [1, 1 + extra, 1 + extra]
    if not shared:
        return
    # the training route: every tower on its JAX XLA branch, no dropout
    quiet = dict(dropout=0.0, drop_path=0.0)
    jtrain = jmm.MultiModalRetrievalModel(dataclasses.replace(
        jcfg, swin=dataclasses.replace(jcfg.swin, dropout=0.0, drop_path_rate=0.0),
        text=dataclasses.replace(jcfg.text, dropout=0.0), **quiet))
    want = jax.jit(lambda p: jtrain.apply({"params": p}, img, ids, mask, deterministic=False,
                                          rngs={"dropout": jax.random.PRNGKey(1)}))(params)
    tcfg = dataclasses.replace(
        pcfg, swin=dataclasses.replace(pcfg.swin, dropout=0.0, drop_path_rate=0.0),
        text=dataclasses.replace(pcfg.text, dropout=0.0), **quiet)
    tmodel = MultiModalRetrievalModel(tcfg, device="cpu")
    load_flax_params(tmodel, params)
    got = tmodel(torch.from_numpy(img), torch.from_numpy(ids).long(),
                 torch.from_numpy(mask).long(), deterministic=False,
                 generator=torch.Generator().manual_seed(0))
    for key in ("logits", "joint_emb"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


# -- ref_port ------------------------------------------------------------------

R_IMG, R_TXT, R_JOINT, R_HEADS, R_CLASSES, R_LAYERS = 24, 20, 16, 2, 5, 2
R_B, R_NP, R_LT = 2, 4, 3


def ref_state(shared: bool, seed: int = 0):
    """A seeded reference MultiModalRetrievalModel.state_dict() (keys and
    shapes of the reference's torch modules), numpy f32."""
    rng = np.random.default_rng(seed)
    sd = {}

    def lin(name, i, o):
        sd[f"{name}.weight"] = rng.standard_normal((o, i)) * i ** -0.5
        sd[f"{name}.bias"] = rng.standard_normal(o) * 0.1

    def ln(name, d):
        sd[f"{name}.weight"] = 1 + rng.standard_normal(d) * 0.1
        sd[f"{name}.bias"] = rng.standard_normal(d) * 0.1

    def mha(name, d):
        sd[f"{name}.in_proj_weight"] = rng.standard_normal((3 * d, d)) * d ** -0.5
        sd[f"{name}.in_proj_bias"] = rng.standard_normal(3 * d) * 0.1
        lin(f"{name}.out_proj", d, d)

    def enhancer(name, d, L):
        mha(f"{name}.self_attn", d)
        ln(f"{name}.norm1", d)
        sd[f"{name}.pos_embed"] = rng.standard_normal((1, L, d)) * 0.1
        sd[f"{name}.alpha"] = np.array([0.5 + rng.standard_normal() * 0.1])

    J = R_JOINT
    for i in range(R_LAYERS):
        p = f"fusion_layers.{i}."
        enhancer(p + "txt_self_attn", R_TXT, 16)
        enhancer(p + "img_patch_self_attn", R_IMG, 16)
        enhancer(p + "img_global_self_attn", R_IMG, 1)
        ln(p + "ln_img", J)
        ln(p + "ln_txt", J)
        for name, d in (("query_txt", R_TXT), ("key_img", R_IMG), ("value_img", R_IMG),
                        ("query_img", R_IMG), ("key_txt", R_TXT), ("value_txt", R_TXT),
                        ("txt_proj", R_TXT), ("img_patch_proj", R_IMG),
                        ("img_global_proj", R_IMG)):
            lin(p + name, d, J)
        mha(p + "attn_txt2img", J)
        mha(p + "attn_img2txt", J)
        sd[p + "default_txt_token"] = rng.standard_normal((1, 1, R_TXT)) * 0.1
        lin(p + "comb_mlp.0", 3 * J, J)
        lin(p + "comb_mlp.3", J, J)
        ln(f"norm1_layers.{i}", J)
        ln(f"norm2_layers.{i}", J)
        lin(f"adapters.{i}.0", J, J // 4)
        lin(f"adapters.{i}.2", J // 4, J)
        if not shared:
            lin(f"ffn.{i}.linear1", J, 4 * J)
            lin(f"ffn.{i}.linear2", 4 * J, J)
    if shared:
        lin("shared_ffn.linear1", J, 4 * J)
        lin("shared_ffn.linear2", 4 * J, J)
    mha("self_attn", J)
    sd["alpha"] = np.array([0.7])
    sd["pos_encoder.pe"] = rng.standard_normal((1, 64, J)) * 0.1
    lin("img_proj", R_IMG, J)
    lin("txt_proj", R_TXT, J)
    lin("classifier.0", J, 4 * J)
    lin("classifier.3", 4 * J, R_CLASSES)
    sd["backbones.ignored.weight"] = np.zeros(3)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def ref_feats(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R_B, R_IMG)).astype(np.float32),
            rng.standard_normal((R_B, R_NP, R_IMG)).astype(np.float32),
            rng.standard_normal((R_B, R_LT, R_TXT)).astype(np.float32))


def assert_outputs_close(got, want):
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
        elif isinstance(w, dict):
            assert got[key].keys() == w.keys(), key
            for k in w:
                np.testing.assert_allclose(got[key][k].numpy(), np.asarray(w[k]),
                                           err_msg=f"{key}.{k}", **TOL)
        else:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(w), err_msg=key, **TOL)


@pytest.mark.parametrize("mode,shared,cls_only", [
    ("multimodal", True, False), ("multimodal", False, False), ("image", True, False),
    ("text", False, True)])
def test_reference_forward_matches_jax(mode, shared, cls_only):
    """reference_forward (with its attention maps in the multimodal mode) on
    the same converted state in both packages; the converters equal."""
    sd = ref_state(shared)
    jp = jref.convert_reference_state(sd, R_LAYERS, use_shared_ffn=shared)
    tp = ref_port.convert_reference_state(sd, R_LAYERS, use_shared_ffn=shared)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tp, jp)
    g, p, t = ref_feats()
    kw = dict(num_heads=R_HEADS, model_type=mode, use_cls_only=cls_only,
              use_shared_ffn=shared, return_attention=mode == "multimodal")
    want = jax.jit(lambda *a: jref.reference_forward(*a, **kw))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(g), jnp.asarray(p),
        None if mode == "image" else jnp.asarray(t))
    got = ref_port.reference_forward(ref_port.params_to_torch(tp), torch.from_numpy(g),
                                     torch.from_numpy(p),
                                     None if mode == "image" else torch.from_numpy(t), **kw)
    assert_outputs_close(got, want)


@pytest.mark.parametrize("cls_only,text", [(False, True), (True, True), (False, False)])
def test_reference_fusion_matches_jax(cls_only, text):
    """The fusion module alone: the sequence, the cls-only pooled variant and
    the default text token."""
    fp = ref_port.convert_fusion_state(ref_state(True), "fusion_layers.0.")
    g, p, t = ref_feats(2)
    want = jax.jit(lambda *a: jref.cross_modal_fusion(*a, R_HEADS, use_cls_only=cls_only))(
        jax.tree_util.tree_map(jnp.asarray, fp), jnp.asarray(g), jnp.asarray(p),
        jnp.asarray(t) if text else None)
    got = ref_port.cross_modal_fusion(ref_port.params_to_torch(fp), torch.from_numpy(g),
                                      torch.from_numpy(p), torch.from_numpy(t) if text else None,
                                      R_HEADS, use_cls_only=cls_only)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    assert_outputs_close(got[1], want[1])


def test_reference_rejects_the_model_level_cls_only():
    tp = ref_port.params_to_torch(ref_port.convert_reference_state(ref_state(True), R_LAYERS))
    g, p, t = (torch.from_numpy(a) for a in ref_feats())
    for fn, params, args in ((ref_port.reference_forward, tp, (g, p, t)),
                             (jref.reference_forward, {}, (None, None, None))):
        with pytest.raises(NotImplementedError, match="use_cls_only=True"):
            fn(params, *args, num_heads=R_HEADS, use_cls_only=True)


# -- the explain engine's ViT branch ---------------------------------------------


def test_vit_integrated_gradients_match_jax():
    """Patch IG of a model with the ViT tower (its global is the cls token,
    interpolated beside the patches: ``cls_global``) against JAX's engine
    (rtol 1e-4 / atol 1e-5)."""
    from mmrp_tpu.models import explain as jexplain
    from mmrp_tpu_torch.models import explain

    fields = dict(image_backbone="vit", image_size=32, joint_dim=16, num_heads=2,
                  num_fusion_layers=1, text_dim=8)
    jmodel = jmm.MultiModalRetrievalModel(jmm.MultiModalConfig.from_config(
        JConfig(**fields), num_classes=6))
    rng = np.random.default_rng(6)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    ids = rng.integers(0, 8192, (2, 8)).astype(np.int32)
    mask = (np.arange(8)[None] < np.array([8, 5])[:, None]).astype(np.int32)
    params = jax_params(jmodel, img, ids, mask)
    model = MultiModalRetrievalModel(MultiModalConfig.from_config(Config(**fields),
                                                                  num_classes=6),
                                     device="cpu").eval()
    load_flax_params(model, params)
    want = jexplain.ExplanationEngine(jmodel, {"model": params}).integrated_gradients(
        img, ids, mask, 2, n_steps=4, chunk=2)
    got = explain.ExplanationEngine(model).integrated_gradients(img, ids, mask, 2, n_steps=4,
                                                                 chunk=2)
    assert got.shape == np.asarray(want).shape == (2, 32, 32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    assert (np.ptp(got.reshape(2, -1), axis=1) > 0.5).all()


def test_run_dir_serves_a_vit_run_with_a_text_override_as_jax(tmp_path):
    """A run directory whose config.yaml names the vit backbone and whose
    model_config.json pins the text tower to a ported checkpoint's dims:
    ``from_run_dir`` rebuilds JAX's model (config for config) and serves its
    npz weights as the JAX model does (probs and joint_emb, 1e-5)."""
    import json

    import yaml

    from mmrp_tpu.labels import LABEL_COLS
    from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
    from mmrp_tpu.utils.checkpoint import save_param_tree as jsave_param_tree
    from mmrp_tpu_torch.api import MMRPredictor
    from test_torch_config import assert_same_model

    fields = dict(image_backbone="vit", image_size=32, joint_dim=32, num_fusion_layers=1,
                  num_heads=2, text_dim=16)
    text = dict(vocab_size=40, hidden_dim=48, num_layers=2, num_heads=2, intermediate_dim=80,
                max_positions=48, type_vocab_size=3)
    run = tmp_path / "run"
    (run / "joint").mkdir(parents=True)
    jcfg = JConfig(**fields)
    (run / "config.yaml").write_text(yaml.safe_dump(
        {k: v for k, v in jcfg.to_dict().items() if k != "run_name"}))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(35)]
    (run / "vocab.txt").write_text("\n".join(vocab) + "\n")
    mm = jmm.MultiModalConfig.from_config(jcfg, num_classes=len(LABEL_COLS),
                                          text_override=JTextConfig(**text))
    (run / "model_config.json").write_text(json.dumps({
        "flagship": False, "vision_backbone": mm.vision_backbone,
        "text": {k: v for k, v in dataclasses.asdict(mm.text).items()
                 if k not in ("quant", "remat")}}))
    rng = np.random.default_rng(7)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    ids = rng.integers(0, 40, (2, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < np.array([16, 9])[:, None]).astype(np.int32)
    jmodel = jmm.MultiModalRetrievalModel(mm)
    params = jax_params(jmodel, img, ids, mask)
    jsave_param_tree(str(run / "joint" / "params.npz"), {"model": params})
    pred = MMRPredictor.from_run_dir(str(run), device="cpu")
    assert_same_model(pred.model.config, mm)
    assert pred.model.backbones.vision_name == "vit"
    got = pred.embed(img, ids, mask)
    want = jax.jit(jax_serving_forward(jmodel))(params, img, ids, mask)
    for key in ("probs", "joint_emb"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), err_msg=key,
                                   rtol=1e-5, atol=1e-5)
