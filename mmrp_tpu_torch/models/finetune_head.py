"""Label-aware Swin finetuning head.

Counterpart of ``mmrp_tpu/models/finetune_head.py``: the port's
``SwinEncoder``, an image enhancer (one global self-attention block over the
patches), then ``num_classes`` learnable label queries cross-attending the
patch sequence, each query's output concatenated with the global feature and
passed through a fusion MLP to that label's logit. Parameter names are the
Flax tree's (``swin``, ``enhancer``, ``label_head/{label_queries,
label_cross_attn, fuse_in, fuse_out}``), so ``utils/convert.py`` loads a JAX
``SwinForFinetune``'s parameters.

``forward(image, deterministic=False, generator=g)`` is the training route:
Swin's (C-F / C-B at its attention cores, dropout and DropPath drawn from
``g``), and the enhancer and label cross-attention with their (zero by
default) attention dropout. The deterministic route serves Swin through its
kernels (``models/swin.py::swin_plan``). The model is built in ``dtype``
(bf16 on the card, where the kernels take nothing else), with the label
queries, the LayerNorms and ``fuse_out`` in f32 and f32 logits, as JAX's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.models.layers import MultiHeadDotProductAttention, SelfAttentionBlock, gelu
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder


class LabelQueryHead(nn.Module):
    """Label queries x patches cross-attention -> per-label logits (B, C)."""

    def __init__(self, num_classes: int, dim: int, num_heads: int = 8,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.label_queries = nn.Parameter(torch.zeros(1, num_classes, dim,
                                                      dtype=torch.float32, device=device))
        self.label_cross_attn = MultiHeadDotProductAttention(dim, num_heads, 0.0, dtype, device)
        self.fuse_in = nn.Linear(2 * dim, dim, dtype=dtype, device=device)
        self.fuse_out = nn.Linear(dim, 1, dtype=torch.float32, device=device)

    def forward(self, patches: torch.Tensor, global_feat: torch.Tensor,
                generator: torch.Generator = None) -> torch.Tensor:
        B = patches.shape[0]
        q = self.label_queries.to(patches.dtype).expand(B, -1, -1)
        attended = self.label_cross_attn(q, patches, generator=generator)  # (B, C, D)
        g = global_feat[:, None, :].expand(attended.shape)
        h = gelu(self.fuse_in(torch.cat([attended, g], dim=-1)))
        return self.fuse_out(h.float())[..., 0]


class SwinForFinetune(nn.Module):
    """Swin backbone + enhancer + label-query classifier: NHWC image ->
    {logits (B, C) f32, patches, global}. Built on the card unless ``device``
    names another."""

    def __init__(self, swin: SwinConfig, num_classes: int = 43, num_heads: int = 8,
                 dtype=torch.float32, device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device, "SwinForFinetune")
        self.config = swin
        dim = swin.num_features
        self.swin = SwinEncoder(swin, dtype, device)
        self.enhancer = SelfAttentionBlock(dim, num_heads, 0.0, dtype, device)
        self.label_head = LabelQueryHead(num_classes, dim, num_heads, dtype, device)

    def forward(self, image: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        if not deterministic and generator is None:
            raise ValueError("SwinForFinetune: the training route needs a torch.Generator")
        gen = None if deterministic else generator
        feats = self.swin(image, deterministic, generator)
        patches = self.enhancer(feats["patches"], generator=gen)
        global_feat = patches.float().mean(dim=1).to(patches.dtype)
        logits = self.label_head(patches, global_feat, gen)
        return {"logits": logits, "patches": patches, "global": global_feat}
