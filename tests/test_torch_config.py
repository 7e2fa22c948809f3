"""The port's ``Config`` and ``MultiModalConfig.from_config`` against the JAX
package's.

``from_config`` must build the JAX model from the same ``Config``: the same
Swin and text presets field by field, the same fusion-stack fields and the
same parameter shapes (JAX's from ``jax.eval_shape`` of ``model.init``, the
port's ``state_dict`` of a model on the meta device, through the weight
bridge's key map), for ``Config()``, ``configs/config.yaml`` read by each
package, a micro backbone, the image modality and a ``text_override``.
``Config.load`` reads the flat YAML without PyYAML, and every field whose
behaviour is not ported raises.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.models.multimodal import (
    MultiModalConfig,
    MultiModalRetrievalModel,
)
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parent.parent
YAML = str(REPO / "configs" / "config.yaml")
TEXT_OVERRIDE = dict(hidden_dim=128, num_layers=2, num_heads=4, intermediate_dim=512,
                     vocab_size=1000, max_positions=256)
# (label, Config fields, flagship, text_override)
CASES = [
    ("default", {}, False, None),
    ("flagship", {}, True, None),
    ("micro", dict(image_backbone="swin_micro", image_size=28), False, None),
    ("image", dict(modality="image", image_backbone="swin_tiny", joint_dim=256,
                   num_fusion_layers=2, num_heads=4), False, None),
    ("text_override", dict(image_backbone="swin_tiny", text_dim=256,
                           serve_quant="int8_static"), False, TEXT_OVERRIDE),
]
# MedCLIP's vision tower is Swin-Tiny (the whole model's parameters:
# tests/test_torch_backbones.py)
MEDCLIP = ("medclip", dict(image_backbone="medclip", use_pallas_attention=False), False, None)


def shared(a, b, skip=()):
    """The fields two dataclasses share, as (name, a's value, b's value)."""
    names = {f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)}
    return [(n, getattr(a, n), getattr(b, n)) for n in sorted(names - set(skip))]


def assert_same_model(port: MultiModalConfig, jax_cfg) -> None:
    for name, got, want in shared(port, jax_cfg, skip=("swin", "text")):
        assert got == want, name
    for part in ("swin", "text"):
        pairs = shared(getattr(port, part), getattr(jax_cfg, part))
        assert len(pairs) >= 9, part
        for name, got, want in pairs:
            assert got == want, f"{part}.{name}"


def both_configs(fields, flagship, text_override):
    jcfg = jmm.MultiModalConfig.from_config(
        JConfig(**fields), flagship=flagship,
        text_override=None if text_override is None else JTextConfig(**text_override))
    pcfg = MultiModalConfig.from_config(
        Config(**fields), flagship=flagship,
        text_override=None if text_override is None else TextConfig(**text_override))
    return pcfg, jcfg


@pytest.mark.parametrize("label,fields,flagship,text_override", CASES + [MEDCLIP],
                         ids=[c[0] for c in CASES + [MEDCLIP]])
def test_from_config_builds_the_jax_model(label, fields, flagship, text_override):
    pcfg, jcfg = both_configs(fields, flagship, text_override)
    assert_same_model(pcfg, jcfg)
    if text_override is not None:  # the override's dims, with the serving precision
        assert pcfg.text == TextConfig(**TEXT_OVERRIDE, quant="int8_kernel")
        assert pcfg.swin == SwinConfig.tiny(quant="int8_static")


def test_config_yaml_loads_alike_in_both_packages(capsys):
    port, jax_cfg = Config.load(YAML), JConfig.load(YAML)
    out = capsys.readouterr().out
    # keys of JAX fields the port has not ported warn and are ignored: the
    # device mesh, the benchmark's text length; the training pipeline's fields
    # (epochs, kg_*, la_*) and retrieval_backend (its parity galleries) are the
    # port's own
    assert "[WARN] Unknown keys in config file (ignored):" in out
    warned = out.split("[WARN] Unknown keys in config file (ignored):")[1].splitlines()[0]
    for key in ("mesh_shape", "gallery_shard_axis"):
        assert f"'{key}'" in warned
    for key in ("epochs", "kg_model", "la_lr", "retrieval_backend"):
        assert f"'{key}'" not in warned
    for name, got, want in shared(port, jax_cfg):
        assert got == want and type(got) is type(want), name
    assert port.augment is True and port.lr == 2e-5 and port.cls_weight == 5.0
    assert_same_model(MultiModalConfig.from_config(port),
                      jmm.MultiModalConfig.from_config(jax_cfg))


def test_config_load_coerces_and_warns(tmp_path, capsys):
    path = tmp_path / "c.yaml"
    path.write_text("# a comment\nlr: 1e-4   # trailing\nseed: '7'\njoint_dim: 64.0\n"
                    "use_cls_only: \"no\"\nimage_backbone: 'swin_tiny'  # a # in a comment\n"
                    "swin_act_amax_path: null\nnot_a_field: 3\n\n")
    cfg = Config.load(str(path))
    out = capsys.readouterr().out
    assert "Unknown keys in config file (ignored): ['not_a_field']" in out
    assert "Using default values for:" in out
    assert (cfg.lr, cfg.seed, cfg.joint_dim, cfg.use_cls_only, cfg.image_backbone) == \
        (1e-4, 7, 64, False, "swin_tiny")
    assert cfg.swin_act_amax_path is None and cfg.num_heads == Config().num_heads
    path.write_text("nested:\n  key: 1\n")
    with pytest.raises(ValueError, match="flat 'key: value'"):
        Config.load(str(path))
    # the serving fields' validation, as JAX's
    for text, match in (("dtype_policy: fp8\n", "invalid dtype_policy"),
                        ("batch_size: 0\n", "batch_size must be > 0")):
        path.write_text(text)
        with pytest.raises(ValueError, match=match):
            Config.load(str(path))
        with pytest.raises(ValueError, match=match):
            JConfig.load(str(path))


def test_fields_not_ported_raise():
    """remat_backbone is carried, served (tests/test_torch_serve.py) and
    trained: make_train_step steps a remat model (its gradients equal the
    plain step's bit for bit: tests/test_torch_pipeline.py). The fields that
    raised until the other towers and the fusion variants were ported
    (use_shared_ffn, use_cls_only, the resnet50 and medclip backbones) build
    the model (tests/test_torch_backbones.py holds them to JAX's)."""
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step

    cfg = Config(remat_backbone=True, joint_dim=32, num_heads=2, num_fusion_layers=1,
                 image_backbone="swin_micro", image_size=28, text_dim=8, lr=1e-3)
    mm = MultiModalConfig.from_config(cfg, num_classes=5)
    assert mm.remat_backbone and not MultiModalConfig.from_config(Config()).remat_backbone
    model = MultiModalRetrievalModel(mm, device="cpu")
    assert model.backbones.swin.remat and model.backbones.text.remat
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.random((2, 28, 28, 3), dtype=np.float32)),
             "input_ids": torch.from_numpy(rng.integers(0, 100, (2, 8))),
             "attention_mask": torch.ones((2, 8), dtype=torch.int64),
             "labels": torch.from_numpy((rng.random((2, 5)) < 0.5).astype(np.float32))}
    state = init_train_state(model, cfg, total_steps=3)
    step = make_train_step(model, cfg)
    before = {k: v.clone() for k, v in state.params.items()}
    losses = [step(state, batch)[1]["loss/total"] for _ in range(3)]
    assert np.isfinite(losses).all() and state.count == 3
    assert any(not torch.equal(v, before[k]) for k, v in state.params.items())
    for fields in (dict(use_shared_ffn=True), dict(use_cls_only=True),
                   dict(image_backbone="resnet50"), dict(image_backbone="medclip")):
        cfg = MultiModalConfig.from_config(Config(joint_dim=64, num_heads=4, **fields))
        model = MultiModalRetrievalModel(cfg, device="meta")
        keys = model.state_dict().keys()
        assert ("shared_ffn.Dense_0.weight" in keys) == cfg.use_shared_ffn
        assert model.fusion_layer0.cls_only == cfg.use_cls_only
        tower = {"resnet50": "resnet", "medclip": "medclip"}.get(cfg.vision_backbone, "swin")
        assert model.backbones.vision_name == tower
        assert any(k.startswith(f"backbones.{tower}.") for k in keys)
    assert MultiModalConfig.from_config(Config(image_backbone="resnet50")).vision_backbone \
        == "resnet50"


def jax_param_shapes(jcfg, text_len: int) -> dict:
    """State-dict key -> shape of the JAX model's parameters, through the
    bridge's key map, from jax.eval_shape (no parameter is computed)."""
    model = jmm.MultiModalRetrievalModel(jcfg)
    size = jcfg.swin.img_size
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32),
                          jax.ShapeDtypeStruct((1, text_len), jnp.int32),
                          jax.ShapeDtypeStruct((1, text_len), jnp.int32))
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)
    return {key: tuple(arr.shape) for key, arr in convert.state_items(views)}


@pytest.mark.parametrize("label,fields,flagship,text_override",
                         [c for c in CASES if c[0] != "flagship"],
                         ids=[c[0] for c in CASES if c[0] != "flagship"])
def test_parameter_shapes_match_jax(label, fields, flagship, text_override):
    pcfg, jcfg = both_configs(fields, flagship, text_override)
    want = jax_param_shapes(jcfg, 16)
    model = MultiModalRetrievalModel(pcfg, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
