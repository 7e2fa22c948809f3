"""Cross-modal fusion modules on the fused-kernel route.

Counterpart of ``mmrp_tpu/models/fusion.py`` on its serving path (no
attention maps requested): every attention here is one call of the fused
attention kernel (K3, ``ops/fused_attention.py``):

- ``PreFusionEnhancer``: out = x + alpha * MHA(LN(x + pos)), ``ln_mode="pre"``
  with the position table and the raw-x residual folded in;
- ``CrossAttention``: LN(q_in + MHA(q_in, kv_in)), ``ln_mode="post"`` with a
  cross kv;
- ``CrossModalFusion``: both enhancers, both cross-attentions, masked text
  pooling and the fused sequence ``[cls, patches..., txt]``.

The port runs the token counts as they are (49 patches, 51-token sequence);
the JAX package pads them to multiples of 8 for its TPU kernels and masks the
pads, which leaves the real rows unchanged.

Training (``forward_train``) takes the JAX XLA branches (``fusion.py:130-163,
216-241``): plain GEMMs, f32 scores and softmax, dropout on the attention
probabilities.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mmrp_tpu_torch.models.layers import LayerNorm, MhaParams, ln_f32
from mmrp_tpu_torch.models.text_encoder import additive_key_mask, mha_train
from mmrp_tpu_torch.ops.fused_attention import fused_attention


class CrossAttention(nn.Module):
    """MHA with queries from ``q_in`` and keys/values from ``kv_in``."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 dropout: float = 0.0):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.dropout = dropout
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """``post_ln`` (scale, bias): return LayerNorm(q_in + attn_out)."""
        ln_s, ln_b = post_ln if post_ln is not None else (None, None)
        return fused_attention(
            q_in, ln_s, ln_b, self.q.weight, self.q.bias, self.k.weight, self.k.bias,
            self.v.weight, self.v.bias, self.out.weight, self.out.bias, kv=kv_in,
            key_mask=None if kv_mask is None else additive_key_mask(kv_mask),
            num_heads=self.num_heads, ln_mode="post" if post_ln is not None else "none",
            include_residual=False)

    def forward_train(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                      kv_mask: Optional[torch.Tensor], post_ln: Tuple[torch.Tensor, torch.Tensor],
                      generator: torch.Generator) -> torch.Tensor:
        ctx = mha_train(self.q(q_in), self.k(kv_in), self.v(kv_in), self.num_heads,
                        None if kv_mask is None else additive_key_mask(kv_mask),
                        self.dropout, generator)
        return ln_f32(q_in + self.out(ctx), *post_ln, q_in.dtype, affine_in_f32=True)


class PreFusionEnhancer(nn.Module):
    """Self-attention with a learned positional embedding and an
    alpha-scaled residual: out = x + alpha * MHA(LN(x + pos))."""

    def __init__(self, dim: int, num_heads: int, max_len: int, dtype=torch.float32,
                 device=None, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.max_len = max_len
        self.dropout = dropout
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, dim, dtype=dtype, device=device))
        self.alpha = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))
        self.LayerNorm_0 = LayerNorm(dim, dtype, device)
        self.attention = MhaParams(dim, dtype, device)

    def _pos(self, N: int) -> torch.Tensor:
        if N > self.max_len:
            raise ValueError(f"PreFusionEnhancer: {N} tokens, positional table holds "
                             f"{self.max_len}")
        return self.pos_embed[0, :N]

    def forward_train(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                      generator: torch.Generator) -> torch.Tensor:
        y = ln_f32(x + self._pos(x.shape[1])[None].to(x.dtype), self.LayerNorm_0.weight,
                   self.LayerNorm_0.bias, x.dtype)
        a = self.attention
        ctx = mha_train(a.query(y), a.key(y), a.value(y), self.num_heads,
                        None if mask is None else additive_key_mask(mask), self.dropout,
                        generator)
        return x + self.alpha.to(x.dtype) * a.out(ctx)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        N = x.shape[1]
        pos = self._pos(N)
        return fused_attention(
            x, self.LayerNorm_0.weight, self.LayerNorm_0.bias, *self.attention.weights(),
            key_mask=None if mask is None else additive_key_mask(mask),
            pos=pos, alpha=self.alpha, num_heads=self.num_heads,
            ln_mode="pre", include_residual=True, residual_from_raw=True)


class CrossModalFusion(nn.Module):
    """Image patches (B, Np, D), image global (B, D), text tokens (B, Lt, D)
    and text mask (B, Lt) -> fused sequence [cls, patches, txt] (B, Np+2, D)."""

    def __init__(self, dim: int, num_heads: int, num_patches: int, max_text_len: int,
                 dtype=torch.float32, device=None, dropout: float = 0.0):
        super().__init__()
        self.txt_enh = PreFusionEnhancer(dim, num_heads, max_text_len, dtype, device, dropout)
        self.img_enh = PreFusionEnhancer(dim, num_heads, num_patches, dtype, device, dropout)
        self.txt_norm = LayerNorm(dim, dtype, device)
        self.img_norm = LayerNorm(dim, dtype, device)
        self.txt2img = CrossAttention(dim, num_heads, dtype, device, dropout)
        self.img2txt = CrossAttention(dim, num_heads, dtype, device, dropout)
        self.cls_proj = nn.Linear(2 * dim, dim, dtype=dtype, device=device)

    def forward(self, img_patches: torch.Tensor, img_global: torch.Tensor,
                txt_tokens: torch.Tensor,
                txt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        txt_e = self.txt_enh(txt_tokens, txt_mask)
        pat_e = self.img_enh(img_patches)
        # text queries attend the patches and vice versa, both over the
        # enhanced tensors, each followed by residual + LN
        txt = self.txt2img(txt_e, pat_e, None,
                           post_ln=(self.txt_norm.weight, self.txt_norm.bias))
        patches = self.img2txt(pat_e, txt_e, txt_mask,
                               post_ln=(self.img_norm.weight, self.img_norm.bias))
        return self._sequence(img_global, txt, patches, txt_mask)

    def forward_train(self, img_patches: torch.Tensor, img_global: torch.Tensor,
                      txt_tokens: torch.Tensor, txt_mask: Optional[torch.Tensor],
                      generator: torch.Generator) -> torch.Tensor:
        txt_e = self.txt_enh.forward_train(txt_tokens, txt_mask, generator)
        pat_e = self.img_enh.forward_train(img_patches, None, generator)
        txt = self.txt2img.forward_train(txt_e, pat_e, None,
                                         (self.txt_norm.weight, self.txt_norm.bias), generator)
        patches = self.img2txt.forward_train(pat_e, txt_e, txt_mask,
                                             (self.img_norm.weight, self.img_norm.bias),
                                             generator)
        return self._sequence(img_global, txt, patches, txt_mask)

    def _sequence(self, img_global, txt, patches, txt_mask) -> torch.Tensor:
        """Masked text pooling and the fused sequence [cls, patches, txt]."""
        if txt_mask is not None:
            w = txt_mask.to(patches.dtype)
            txt_pooled = (txt * w[:, :, None]).sum(1) / torch.clamp(
                w.sum(1, keepdim=True), min=1.0)
        else:
            txt_pooled = txt.mean(dim=1)
        cls = self.cls_proj(torch.cat([img_global, txt_pooled], dim=-1))
        return torch.cat([cls[:, None, :], patches, txt_pooled[:, None, :]], dim=1)
