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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.fusion import CrossModalFusion
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
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder
from mmrp_tpu_torch.models.text_encoder import TextConfig, TextEncoder, mha_train
from mmrp_tpu_torch.ops.fused_attention import fused_attention
from mmrp_tpu_torch.ops.fused_mlp import fused_ln_mlp_residual


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

    @staticmethod
    def flagship(**kw) -> "MultiModalConfig":
        """Swin-B at 224 px + ClinicalBERT dims + 5 fusion layers at 1024."""
        return MultiModalConfig(swin=SwinConfig.base(), text=TextConfig.clinicalbert(), **kw)


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
                    "(ROADMAP.md Queue 1: other backbones); the port runs 'swin'")
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
    sequence."""

    def __init__(self, config: MultiModalConfig, num_patches: int, dtype=torch.float32,
                 device=None, drop_path: float = 0.0):
        super().__init__()
        D = config.joint_dim
        self.num_heads = config.num_heads
        self.dropout = config.dropout
        self.drop_path = DropPath(drop_path)
        self.fusion = CrossModalFusion(D, config.num_heads, num_patches,
                                       config.max_text_len, dtype, device, config.dropout)
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

    def forward(self, img_patches, img_global, txt_tokens, txt_mask) -> torch.Tensor:
        seq = self.fusion(img_patches, img_global, txt_tokens, txt_mask)
        B, L, D = seq.shape
        seq = fused_attention(seq, self.LayerNorm_0.weight, self.LayerNorm_0.bias,
                              *self.attention.weights(), pos=self.sin_pos[:L],
                              num_heads=self.num_heads, ln_mode="pre",
                              include_residual=True)
        seq = fused_ln_mlp_residual(seq.reshape(B * L, D), self.LayerNorm_1.weight,
                                    self.LayerNorm_1.bias,
                                    *self.ffn.weights()).reshape(B, L, D)
        return self._adapter_pool(seq)

    def forward_train(self, img_patches, img_global, txt_tokens, txt_mask,
                      generator: torch.Generator) -> torch.Tensor:
        """The JAX XLA branch (``multimodal.py:256, 299-341``) with autograd."""
        rate = self.dropout
        seq = self.fusion.forward_train(img_patches, img_global, txt_tokens, txt_mask,
                                        generator)
        seq = dropout(seq, rate, generator)
        seq = seq + self.sin_pos[: seq.shape[1]][None]
        y = ln_f32(seq, self.LayerNorm_0.weight, self.LayerNorm_0.bias, seq.dtype)
        a = self.attention
        ctx = mha_train(a.query(y), a.key(y), a.value(y), self.num_heads, None, rate,
                        generator)
        seq = seq + self.drop_path(a.out(ctx), generator)
        y = ln_f32(seq, self.LayerNorm_1.weight, self.LayerNorm_1.bias, seq.dtype)
        y = dropout(gelu(self.ffn.Dense_0(y)), rate, generator)
        y = dropout(self.ffn.Dense_1(y), rate, generator)
        return self._adapter_pool(seq + self.drop_path(y, generator))

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
                "use_shared_ffn and use_cls_only are not ported (ROADMAP.md Queue 1, "
                "detailed item 4)")
        self.config = config
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
