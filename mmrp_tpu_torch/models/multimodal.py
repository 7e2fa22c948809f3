"""MultiModalRetrievalModel — Swin + BERT towers, fusion stack, 43-label head.

Counterpart of ``mmrp_tpu/models/multimodal.py`` on its serving route:
per-modality projections into the joint space, ``num_fusion_layers`` fusion
layers (cross-modal fusion -> sinusoidal positions + self-attention (K3) ->
LN + FFN + residual (K2) -> bottleneck adapter -> LN, pooled into the joint
embedding), then the MLP classifier with f32 logits. Modes: multimodal,
image and text (the missing modality is a learned null token). As in the
JAX model, each fusion layer re-attends the same backbone features.

``forward(..., deterministic=False, generator=g)`` is the training route:
every tower takes its JAX XLA branch with dropout and DropPath drawn from
``g`` (``multimodal.py:256, 299-341, 478, 495``), and no serving kernel runs.

``MultiModalConfig.quant="int8"`` serves the fusion stack through the same
XLA branch with every GEMM in W8A8 (``ops/quant.py``) and no kernel, as the
JAX model does (``multimodal.py:231-241, 299-341``). ``from_config`` builds
the JAX ``MultiModalConfig.from_config``'s model from a ``Config``
(``multimodal.py:60-130``), ``serve_quant`` on all three towers.

Every kernel call site has a route fixed at construction from the kernel
wrappers' ``kernel_takes`` (:func:`model_routes`): ``kernel``, ``plain`` (the
kernel's plain version, on any device, counted in the wrapper's
``plain_calls``), or ``int8`` (a W8A8 XLA branch of the JAX model); Swin
steps are named by their route or "plain" (``models/swin.py``). The training
route's call sites are the Swin attention cores (``model_routes(config,
train=True)``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.fusion import (
    CrossModalFusion,
    attach_int8_all,
    attention_route,
    plain_lins,
    run_attention,
)
from mmrp_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    MhaParams,
    MlpParams,
    dropout,
    gelu,
    ln_f32,
    sinusoidal_positions,
)
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder, plan_names, train_plan
from mmrp_tpu_torch.models.text_encoder import (
    TextConfig,
    TextEncoder,
    mha_train,
    qlinear_multi,
)
from mmrp_tpu_torch.models.text_encoder import attention_route as text_attention_route
from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops import fused_mlp as K2
from mmrp_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual, ln_mlp_plain


@dataclass(frozen=True)
class MultiModalConfig:
    swin: SwinConfig
    text: TextConfig
    vision_backbone: str = "swin"
    joint_dim: int = 1024
    num_fusion_layers: int = 5
    num_heads: int = 8
    num_classes: int = 43
    mode: str = "multimodal"  # multimodal | image | text
    use_shared_ffn: bool = False  # not ported: raises
    use_cls_only: bool = False  # not ported: raises
    dropout: float = 0.1  # training only
    drop_path: float = 0.1  # training only: fusion layer i gets drop_path * i / (L - 1)
    max_text_len: int = 512
    quant: str = "none"  # "int8": W8A8 GEMMs in the fusion stack (serving)

    @staticmethod
    def flagship(**kw) -> "MultiModalConfig":
        """Swin-B at 224 px + ClinicalBERT dims + 5 fusion layers at 1024."""
        return MultiModalConfig(swin=SwinConfig.base(), text=TextConfig.clinicalbert(), **kw)

    @staticmethod
    def from_config(cfg: Config, num_classes: int = 43, flagship: bool = False,
                    text_override: Optional[TextConfig] = None) -> "MultiModalConfig":
        """The JAX ``MultiModalConfig.from_config`` (``multimodal.py:60-130``):
        the Swin preset of ``image_backbone`` (``medclip``: Swin-Tiny) at
        ``image_size``; the text tower ``text_override`` (its dims, with the
        serving precision), else ClinicalBERT dims for ``flagship``, else the
        32-wide one-layer tower for a micro backbone, else
        ``TextConfig.small()``; the fusion stack's ``joint_dim``,
        ``num_fusion_layers``, ``num_heads``, ``modality`` and ``text_dim``.
        ``serve_quant`` "int8" and "int8_static" run the text tower as
        "int8_kernel" and the fusion stack as "int8"; "int8_static" also runs
        the Swin whole-block stages in static int8, with ``act_amax`` from
        ``swin_act_amax_path`` when one is given (else per-row activation
        scales). ``use_pallas_attention=False`` sends every Swin step to its
        plain version. ``remat_backbone`` is not ported and raises."""
        from mmrp_tpu_torch.models.quant_calib import load_act_amax

        sq = cfg.serve_quant
        if sq not in ("none", "int8", "int8_static"):
            raise ValueError(f"serve_quant must be none, int8 or int8_static, got {sq!r}")
        if cfg.remat_backbone:
            raise NotImplementedError(
                "remat_backbone=True (activation checkpointing of the towers) is not ported "
                "(ROADMAP.md Queue 1 item 6)")
        swin_kw = {}
        if sq == "int8_static":
            swin_kw["quant"] = "int8_static"
            if cfg.swin_act_amax_path:
                swin_kw["act_amax"] = load_act_amax(cfg.swin_act_amax_path)
        backbone = cfg.image_backbone.lower()
        swin = SwinConfig.from_name(
            cfg.image_backbone if cfg.image_backbone.startswith("swin")
            # MedCLIP's vision tower is Swin-Tiny
            else ("swin_tiny" if backbone == "medclip" else "swin"),
            use_pallas=cfg.use_pallas_attention, img_size=cfg.image_size, **swin_kw)
        if backbone.startswith("swin"):
            vision_backbone = "swin"
        elif backbone.startswith("resnet"):
            vision_backbone = "resnet50"
        elif backbone.startswith("efficientnet"):
            vision_backbone = "efficientnet"
        elif backbone in ("medclip", "vit"):
            vision_backbone = backbone
        else:
            vision_backbone = "swin"
        tq = "int8_kernel" if sq != "none" else "none"
        if text_override is not None:
            text = dataclasses.replace(text_override, quant=tq)
        elif flagship:
            text = TextConfig.clinicalbert(quant=tq)
        elif "micro" in cfg.image_backbone:
            text = TextConfig.small(hidden_dim=32, num_layers=1, num_heads=2,
                                    intermediate_dim=64, quant=tq)
        else:
            text = TextConfig.small(quant=tq)
        return MultiModalConfig(
            swin=swin, text=text, vision_backbone=vision_backbone, joint_dim=cfg.joint_dim,
            num_fusion_layers=cfg.num_fusion_layers, num_heads=cfg.num_heads,
            num_classes=num_classes, mode=cfg.modality, use_shared_ffn=cfg.use_shared_ffn,
            use_cls_only=cfg.use_cls_only, max_text_len=cfg.text_dim,
            quant="int8" if sq != "none" else "none")


def fusion_routes(config: MultiModalConfig) -> Dict[str, str]:
    """The routes of one fusion layer (every layer has the same shapes): its
    four fusion attentions, the self-attention over [cls, patches, text] and
    the FFN."""
    D, h, q = config.joint_dim, config.num_heads, config.quant == "int8"
    Np = 1 if config.mode == "text" else config.swin.num_patches
    Lt = config.max_text_len
    ffn = "int8" if q else ("kernel" if K2.kernel_takes(D, 4 * D) else "plain")
    return {"txt_enh": attention_route(D, h, Lt, Lt, q),
            "img_enh": attention_route(D, h, Np, Np, q),
            "txt2img": attention_route(D, h, Lt, Np, q),
            "img2txt": attention_route(D, h, Np, Lt, q),
            "self_attention": attention_route(D, h, Np + 2, Np + 2, q), "ffn": ffn}


def model_routes(config: MultiModalConfig, train: bool = False) -> Dict[str, str]:
    """Every kernel call site of the serving forward and its route, named
    ``swin.stage{s}.step{i}`` (the Swin step's route, or "plain"),
    ``text.attention`` and ``fusion.{site}`` (:func:`fusion_routes`). With
    ``train``, those of the training route, where every tower takes its JAX
    XLA branch and no serving kernel runs: the Swin attention core of each
    stage with more than one window, ``swin.stage{s}.core`` ("kernel" or
    "plain", ``models/swin.py::train_plan``)."""
    if train:
        if config.mode == "text":
            return {}
        return {f"swin.stage{s}.core": route
                for s, route in enumerate(train_plan(config.swin)) if route}
    routes = {}
    if config.mode != "text":
        for s, names in enumerate(plan_names(config.swin)):
            routes.update({f"swin.stage{s}.step{i}": n for i, n in enumerate(names)})
    if config.mode != "image":
        routes["text.attention"] = text_attention_route(config.text)
    routes.update({f"fusion.{k}": v for k, v in fusion_routes(config).items()})
    return routes


def plain_routes(config: MultiModalConfig, train: bool = False) -> list:
    """The call sites of :func:`model_routes` that no kernel takes."""
    return [name for name, route in model_routes(config, train).items() if route == "plain"]


class Backbones(nn.Module):
    """Vision + text encoders; the unimodal modes build only their tower."""

    def __init__(self, config: MultiModalConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "Backbones")
        self.config = config
        if config.mode != "text":
            if config.vision_backbone != "swin":
                raise NotImplementedError(
                    f"vision backbone {config.vision_backbone!r} is not ported yet "
                    "(ROADMAP.md Queue 1 item 9); the port runs 'swin'")
            self.swin = SwinEncoder(config.swin, dtype, device)
        if config.mode != "image":
            self.text = TextEncoder(config.text, dtype, device)

    def forward(self, image, input_ids, attention_mask, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        out = {}
        if self.config.mode != "text":
            vis = self.swin(image, deterministic, generator)
            out.update(img_patches=vis["patches"], img_global=vis["global"])
        if self.config.mode != "image":
            txt = self.text(input_ids, attention_mask, deterministic, generator)
            out.update(txt_tokens=txt["tokens"], txt_cls=txt["cls"])
        return out


class FusionLayer(nn.Module):
    """Cross-modal fusion -> pos + LN + self-attention + residual (K3) ->
    LN + FFN + residual (K2) -> adapter -> LN; returns the mean over the
    sequence. At ``quant="int8"`` the JAX XLA branch with W8A8 GEMMs."""

    def __init__(self, config: MultiModalConfig, num_patches: int, dtype=torch.float32,
                 device=None, drop_path: float = 0.0):
        super().__init__()
        if config.quant not in ("none", "int8"):
            raise ValueError(f"MultiModalConfig.quant must be none or int8, got {config.quant!r}")
        D = config.joint_dim
        self.num_heads = config.num_heads
        self.dropout = config.dropout
        self.quant = config.quant == "int8"
        self.drop_path = DropPath(drop_path)
        self.fusion = CrossModalFusion(D, config.num_heads, num_patches,
                                       config.max_text_len, dtype, device, config.dropout,
                                       self.quant)
        routes = fusion_routes(config)
        self.attn_route, self.ffn_route = routes["self_attention"], routes["ffn"]
        self.LayerNorm_0 = LayerNorm(D, dtype, device)
        self.attention = MhaParams(D, dtype, device)
        self.LayerNorm_1 = LayerNorm(D, dtype, device)
        self.ffn = MlpParams(4 * D, D, dtype, device)
        self.adapter_down = nn.Linear(D, D // 4, dtype=dtype, device=device)
        self.adapter_up = nn.Linear(D // 4, D, dtype=dtype, device=device)
        self.LayerNorm_2 = LayerNorm(D, dtype, device)
        # sequence = [cls, patches, pooled text]
        sin = torch.from_numpy(sinusoidal_positions(num_patches + 2, D))
        self.register_buffer("sin_pos", sin.to(device=device, dtype=dtype), persistent=False)
        if self.quant:
            attach_int8_all((*self.attention.linears(), self.ffn.Dense_0, self.ffn.Dense_1))

    def forward(self, img_patches, img_global, txt_tokens, txt_mask) -> torch.Tensor:
        seq = self.fusion(img_patches, img_global, txt_tokens, txt_mask)
        if self.quant:
            return self._xla(seq, qlinear_multi, None)
        B, L, D = seq.shape
        seq = run_attention(self.attn_route, seq, self.LayerNorm_0.weight,
                            self.LayerNorm_0.bias, *self.attention.weights(),
                            pos=self.sin_pos[:L], num_heads=self.num_heads, ln_mode="pre",
                            include_residual=True)
        args = (seq.reshape(B * L, D), self.LayerNorm_1.weight, self.LayerNorm_1.bias,
                *self.ffn.weights())
        seq = (fused_ln_mlp_residual(*args) if self.ffn_route == "kernel" else
               _build.run_plain(fused_ln_mlp_residual, ln_mlp_plain, *args)).reshape(B, L, D)
        return self._adapter_pool(seq)

    def forward_train(self, img_patches, img_global, txt_tokens, txt_mask,
                      generator: torch.Generator) -> torch.Tensor:
        """The JAX XLA branch (``multimodal.py:256, 299-341``) with autograd."""
        seq = self.fusion.forward_train(img_patches, img_global, txt_tokens, txt_mask,
                                        generator)
        return self._xla(dropout(seq, self.dropout, generator), plain_lins, generator)

    def _xla(self, seq, lins, generator):
        """The JAX XLA branch after the fusion with ``lins`` (plain or W8A8) as
        its GEMMs; dropout and drop path drawn from ``generator``, or none."""
        rate = self.dropout if generator is not None else 0.0

        def branch(y):
            return self.drop_path(y, generator) if generator is not None else y

        seq = seq + self.sin_pos[: seq.shape[1]][None]
        y = ln_f32(seq, self.LayerNorm_0.weight, self.LayerNorm_0.bias, seq.dtype)
        a = self.attention
        q, k, v = lins(y, (a.query, a.key, a.value))
        ctx = mha_train(q, k, v, self.num_heads, None, rate, generator)
        seq = seq + branch(lins(ctx, (a.out,))[0])
        y = ln_f32(seq, self.LayerNorm_1.weight, self.LayerNorm_1.bias, seq.dtype)
        y = dropout(gelu(lins(y, (self.ffn.Dense_0,))[0]), rate, generator)
        y = dropout(lins(y, (self.ffn.Dense_1,))[0], rate, generator)
        return self._adapter_pool(seq + branch(y))

    def _adapter_pool(self, seq: torch.Tensor) -> torch.Tensor:
        a = self.adapter_up(gelu(self.adapter_down(seq)))
        seq = self.LayerNorm_2(seq + a)
        return seq.float().mean(dim=1).to(seq.dtype)


class MultiModalRetrievalModel(nn.Module):
    """(image (B, H, W, 3) NHWC, ids (B, L), mask (B, L)) -> dict(logits f32,
    joint_emb, img_emb, txt_emb (f32)). Parameters are created in ``dtype``
    on ``device`` (LayerNorms, ``alpha``, ``rel_bias_table`` and the
    classifier's last layer in f32); build the model at the dtype it will
    run in rather than converting it afterwards. ``device`` is the card
    unless the caller names another (``"cpu"`` runs every kernel's plain
    version)."""

    def __init__(self, config: MultiModalConfig, dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "MultiModalRetrievalModel")
        if config.mode not in ("multimodal", "image", "text"):
            raise ValueError(f"invalid mode {config.mode!r}")
        if config.use_shared_ffn or config.use_cls_only:
            raise NotImplementedError(
                "use_shared_ffn and use_cls_only are not ported (ROADMAP.md Queue 1 item 9)")
        self.config = config
        self.routes = model_routes(config)
        self.dtype = dtype
        D = config.joint_dim
        kw = dict(dtype=dtype, device=device)
        self.backbones = Backbones(config, dtype, device)
        if config.mode != "text":
            F_img = config.swin.num_features
            self.img_proj = nn.Linear(F_img, D, **kw)
            self.img_global_proj = nn.Linear(F_img, D, **kw)
        if config.mode != "image":
            F_txt = config.text.hidden_dim
            self.txt_proj = nn.Linear(F_txt, D, **kw)
            self.txt_cls_proj = nn.Linear(F_txt, D, **kw)
        if config.mode == "image":
            self.null_txt = nn.Parameter(torch.zeros(1, 1, D, **kw))
        if config.mode == "text":
            self.null_img = nn.Parameter(torch.zeros(1, 1, D, **kw))
        self.joint_init = nn.Linear(2 * D, D, **kw)
        num_patches = 1 if config.mode == "text" else config.swin.num_patches
        for i in range(config.num_fusion_layers):
            dp = config.drop_path * i / max(config.num_fusion_layers - 1, 1)
            self.add_module(f"fusion_layer{i}",
                            FusionLayer(config, num_patches, dtype, device, dp))
            self.add_module(f"joint_norm{i}", LayerNorm(D, dtype, device))
        self.cls_hidden = nn.Linear(D, 4 * D, **kw)
        self.cls_out = nn.Linear(4 * D, config.num_classes, dtype=torch.float32,
                                 device=device)

    def forward(self, image, input_ids, attention_mask, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """``deterministic=False`` is the training route (module docstring);
        it needs ``generator``."""
        cfg = self.config
        if not deterministic and generator is None:
            raise ValueError("MultiModalRetrievalModel: the training route needs a "
                             "torch.Generator")
        feats = self.backbones(image, input_ids, attention_mask, deterministic, generator)
        B = input_ids.shape[0]
        if cfg.mode != "text":
            img_patches = self.img_proj(feats["img_patches"])
            img_global = self.img_global_proj(feats["img_global"])
        if cfg.mode != "image":
            txt_tokens = self.txt_proj(feats["txt_tokens"])
            txt_cls = self.txt_cls_proj(feats["txt_cls"])
            txt_mask = attention_mask[:, : txt_tokens.shape[1]]
        if cfg.mode == "image":
            txt_tokens = self.null_txt.expand(B, 1, -1).contiguous()
            txt_cls = txt_tokens[:, 0, :]
            txt_mask = torch.ones((B, 1), dtype=attention_mask.dtype,
                                  device=attention_mask.device)
        elif cfg.mode == "text":
            img_patches = self.null_img.expand(B, 1, -1).contiguous()
            img_global = img_patches[:, 0, :]

        joint = self.joint_init(torch.cat([img_global, txt_cls], dim=-1))
        for i in range(cfg.num_fusion_layers):
            layer = self._modules[f"fusion_layer{i}"]
            args = (img_patches, img_global, txt_tokens, txt_mask)
            pooled = layer(*args) if deterministic else layer.forward_train(*args, generator)
            joint = self._modules[f"joint_norm{i}"](joint + pooled)

        joint = joint.float()
        x = gelu(self.cls_hidden(joint.to(self.dtype)))
        if not deterministic:
            x = dropout(x, cfg.dropout, generator)
        logits = self.cls_out(x.float())
        return {
            "logits": logits,
            "joint_emb": joint,
            "img_emb": img_global.float(),
            "txt_emb": txt_cls.float(),
        }
