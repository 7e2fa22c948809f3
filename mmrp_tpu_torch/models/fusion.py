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

``return_attention=True`` (the explain engine's attention maps) runs each
cross-attention on the JAX XLA branch with its softmax weights returned
(``need_weights``, ``fusion.py:130-163``), not a kernel route and not
counted; the enhancers keep K3, as in JAX (``fusion.py:201-210``).

The port runs the token counts as they are (49 patches, 51-token sequence);
the JAX package pads them to multiples of 8 for its TPU kernels and masks the
pads, which leaves the real rows unchanged. Each attention's route is fixed
at construction from the most tokens it can see (:func:`attention_route`):
``kernel`` where K3 takes the shapes, ``plain`` (K3's plain version, counted
in ``fused_attention.plain_calls``) where it does not, ``int8`` for the W8A8
XLA branch.

Given the text's :class:`~mmrp_tpu_torch.ops.fused_attention.Packed` plan
(``txt_rows``), ``CrossModalFusion`` runs the text side packed: the text
enhancer and the text -> image attention on T packed query rows, the image
-> text attention over each report's own rows as keys (K3's packed forms),
and the text pooled as the mean of each report's rows. The image side is
unchanged.

Training (``forward_train``) takes the JAX XLA branches (``fusion.py:130-163,
216-241``): plain GEMMs, f32 scores and softmax, dropout on the attention
probabilities. ``quant=True`` serves through the same branches with every
GEMM in W8A8 (``quant_dot_multi`` for q/k/v, ``quant_dot`` for the output;
``ops/quant.py``) and no kernel, as the JAX modules do at ``quant=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mmrp_tpu_torch.models.layers import LayerNorm, MhaParams, ln_f32
from mmrp_tpu_torch.models.text_encoder import (
    additive_key_mask,
    mha_train,
    qlinear,
    qlinear_multi,
    run_attention,
)
from mmrp_tpu_torch.ops import fused_attention as K3
from mmrp_tpu_torch.ops.fused_attention import Packed, to_padded
from mmrp_tpu_torch.ops.quant import attach_int8


def attention_route(dim: int, num_heads: int, max_q: int, max_k: int, quant: bool) -> str:
    """"int8" (the W8A8 XLA branch), else "kernel" where K3 takes width
    ``dim``, ``num_heads`` heads and up to ``max_q`` / ``max_k`` query / key
    tokens, else "plain"."""
    if quant:
        return "int8"
    return "kernel" if K3.kernel_takes(dim, num_heads, max_q, max_k) else "plain"


def plain_lins(x, lins):
    """The XLA branch's GEMMs in the module dtype (``qlinear_multi``: W8A8)."""
    return [lin(x) for lin in lins]


def attach_int8_all(lins) -> None:
    """Int8 caches for linears the XLA branch runs through ``quant_dot``,
    which quantizes the f32 parameters."""
    for lin in lins:
        attach_int8(lin, from_master=True)


class CrossAttention(nn.Module):
    """MHA with queries from ``q_in`` and keys/values from ``kv_in``."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None,
                 dropout: float = 0.0, quant: bool = False, max_q: int = 512,
                 max_k: int = 512):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.dropout = dropout
        self.quant = quant
        self.route = attention_route(dim, num_heads, max_q, max_k, quant)
        self.q = nn.Linear(dim, dim, **kw)
        self.k = nn.Linear(dim, dim, **kw)
        self.v = nn.Linear(dim, dim, **kw)
        self.out = nn.Linear(dim, dim, **kw)
        if quant:
            attach_int8_all((self.q, self.k, self.v, self.out))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                post_ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rows: Optional[Packed] = None,
                kv_rows: Optional[Packed] = None) -> torch.Tensor:
        """``post_ln`` (scale, bias): return LayerNorm(q_in + attn_out).
        ``rows`` / ``kv_rows``: q_in / kv_in packed (K3's packed form), each
        query attending its own sequence's keys, no ``kv_mask``."""
        if self.quant:
            return self._xla(q_in, kv_in, kv_mask, post_ln, qlinear_multi, 0.0, None)
        ln_s, ln_b = post_ln if post_ln is not None else (None, None)
        if rows is not None or kv_rows is not None:
            keys = dict(rows=rows, kv_rows=kv_rows)
        else:
            keys = dict(key_mask=None if kv_mask is None else additive_key_mask(kv_mask))
        return run_attention(
            self.route, q_in, ln_s, ln_b, self.q.weight, self.q.bias, self.k.weight, self.k.bias,
            self.v.weight, self.v.bias, self.out.weight, self.out.bias, kv=kv_in, **keys,
            num_heads=self.num_heads, ln_mode="post" if post_ln is not None else "none",
            include_residual=False)

    def forward_train(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                      kv_mask: Optional[torch.Tensor], post_ln: Tuple[torch.Tensor, torch.Tensor],
                      generator: torch.Generator) -> torch.Tensor:
        return self._xla(q_in, kv_in, kv_mask, post_ln, plain_lins, self.dropout, generator)

    def forward_weights(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                        kv_mask: Optional[torch.Tensor],
                        post_ln: Tuple[torch.Tensor, torch.Tensor]):
        """(output, softmax weights (B, heads, Lq, Lk) f32): the JAX
        ``need_weights`` branch (plain GEMMs, or W8A8 at ``quant``)."""
        lins = qlinear_multi if self.quant else plain_lins
        return self._xla(q_in, kv_in, kv_mask, post_ln, lins, 0.0, None, return_weights=True)

    def _xla(self, q_in, kv_in, kv_mask, post_ln, lins, rate, generator,
             return_weights: bool = False):
        """The JAX XLA branch with ``lins`` (plain or W8A8) as its GEMMs."""
        (q,) = lins(q_in, (self.q,))
        k, v = lins(kv_in, (self.k, self.v))
        ctx = mha_train(q, k, v, self.num_heads,
                        None if kv_mask is None else additive_key_mask(kv_mask), rate, generator,
                        return_weights)
        ctx, weights = ctx if return_weights else (ctx, None)
        (out,) = lins(ctx, (self.out,))
        if post_ln is not None:
            out = ln_f32(q_in + out, *post_ln, q_in.dtype, affine_in_f32=True)
        return (out, weights) if return_weights else out


class PreFusionEnhancer(nn.Module):
    """Self-attention with a learned positional embedding and an
    alpha-scaled residual: out = x + alpha * MHA(LN(x + pos))."""

    def __init__(self, dim: int, num_heads: int, max_len: int, dtype=torch.float32,
                 device=None, dropout: float = 0.0, quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.max_len = max_len
        self.dropout = dropout
        self.quant = quant
        self.route = attention_route(dim, num_heads, max_len, max_len, quant)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, dim, dtype=dtype, device=device))
        self.alpha = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))
        self.LayerNorm_0 = LayerNorm(dim, dtype, device)
        self.attention = MhaParams(dim, dtype, device)
        if quant:
            attach_int8_all(self.attention.linears())

    def _pos(self, N: int) -> torch.Tensor:
        if N > self.max_len:
            raise ValueError(f"PreFusionEnhancer: {N} tokens, positional table holds "
                             f"{self.max_len}")
        return self.pos_embed[0, :N]

    def forward_train(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                      generator: torch.Generator) -> torch.Tensor:
        return self._xla(x, mask, plain_lins, self.dropout, generator)

    def _xla(self, x, mask, lins, rate, generator):
        """The JAX XLA branch with ``lins`` (plain or W8A8) as its GEMMs."""
        y = ln_f32(x + self._pos(x.shape[1])[None].to(x.dtype), self.LayerNorm_0.weight,
                   self.LayerNorm_0.bias, x.dtype)
        a = self.attention
        q, k, v = lins(y, (a.query, a.key, a.value))
        ctx = mha_train(q, k, v, self.num_heads,
                        None if mask is None else additive_key_mask(mask), rate, generator)
        (out,) = lins(ctx, (a.out,))
        return x + self.alpha.to(x.dtype) * out

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rows: Optional[Packed] = None) -> torch.Tensor:
        """``rows``: x (T, D) packed, each row at its position in its sequence."""
        if self.quant:
            return self._xla(x, mask, qlinear_multi, 0.0, None)
        if rows is not None:
            keys = dict(rows=rows)
            pos = self._pos(rows.width)[: rows.max_len]
        else:
            keys = dict(key_mask=None if mask is None else additive_key_mask(mask))
            pos = self._pos(x.shape[1])
        return run_attention(
            self.route, x, self.LayerNorm_0.weight, self.LayerNorm_0.bias, *self.attention.weights(),
            **keys, pos=pos, alpha=self.alpha, num_heads=self.num_heads,
            ln_mode="pre", include_residual=True, residual_from_raw=True)


class CrossModalFusion(nn.Module):
    """Image patches (B, Np, D), image global (B, D), text tokens (B, Lt, D)
    and text mask (B, Lt) -> fused sequence [cls, patches, txt] (B, Np+2, D)."""

    def __init__(self, dim: int, num_heads: int, num_patches: int, max_text_len: int,
                 dtype=torch.float32, device=None, dropout: float = 0.0, quant: bool = False):
        super().__init__()
        args = (dtype, device, dropout, quant)
        self.txt_enh = PreFusionEnhancer(dim, num_heads, max_text_len, *args)
        self.img_enh = PreFusionEnhancer(dim, num_heads, num_patches, *args)
        self.txt_norm = LayerNorm(dim, dtype, device)
        self.img_norm = LayerNorm(dim, dtype, device)
        self.txt2img = CrossAttention(dim, num_heads, *args, max_text_len, num_patches)
        self.img2txt = CrossAttention(dim, num_heads, *args, num_patches, max_text_len)
        self.cls_proj = nn.Linear(2 * dim, dim, dtype=dtype, device=device)

    def forward(self, img_patches: torch.Tensor, img_global: torch.Tensor,
                txt_tokens: torch.Tensor, txt_mask: Optional[torch.Tensor] = None,
                return_attention: bool = False, txt_rows: Optional[Packed] = None):
        """The fused sequence; with ``return_attention`` (sequence,
        {"txt2img", "img2txt"} softmax weights). ``txt_rows``: txt_tokens
        (T, D) packed by it, the text side on K3's packed forms (module
        docstring); ``txt_mask`` is then not read."""
        if txt_rows is not None:
            if return_attention or self.txt_enh.quant:
                raise ValueError("CrossModalFusion: the packed text runs the bf16 kernel "
                                 "routes only, without attention maps")
            txt_e = self.txt_enh(txt_tokens, rows=txt_rows)
            pat_e = self.img_enh(img_patches)
            txt = self.txt2img(txt_e, pat_e, post_ln=(self.txt_norm.weight, self.txt_norm.bias),
                               rows=txt_rows)
            patches = self.img2txt(pat_e, txt_e,
                                   post_ln=(self.img_norm.weight, self.img_norm.bias),
                                   kv_rows=txt_rows)
            return self._sequence(img_global, txt, patches, None, txt_rows)
        txt_e = self.txt_enh(txt_tokens, txt_mask)
        pat_e = self.img_enh(img_patches)
        # text queries attend the patches and vice versa, both over the
        # enhanced tensors, each followed by residual + LN
        txt_ln = (self.txt_norm.weight, self.txt_norm.bias)
        img_ln = (self.img_norm.weight, self.img_norm.bias)
        if return_attention:
            txt, t2i = self.txt2img.forward_weights(txt_e, pat_e, None, txt_ln)
            patches, i2t = self.img2txt.forward_weights(pat_e, txt_e, txt_mask, img_ln)
            return (self._sequence(img_global, txt, patches, txt_mask),
                    {"txt2img": t2i, "img2txt": i2t})
        txt = self.txt2img(txt_e, pat_e, None, post_ln=txt_ln)
        patches = self.img2txt(pat_e, txt_e, txt_mask, post_ln=img_ln)
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

    def _sequence(self, img_global, txt, patches, txt_mask,
                  txt_rows: Optional[Packed] = None) -> torch.Tensor:
        """Masked text pooling and the fused sequence [cls, patches, txt]."""
        if txt_rows is not None:
            # the masked mean's arithmetic on each report's own rows
            n = txt_rows.lengths.to(patches.dtype)[:, None]
            txt_pooled = to_padded(txt, txt_rows).sum(1) / torch.clamp(n, min=1.0)
        elif txt_mask is not None:
            w = txt_mask.to(patches.dtype)
            txt_pooled = (txt * w[:, :, None]).sum(1) / torch.clamp(
                w.sum(1, keepdim=True), min=1.0)
        else:
            txt_pooled = txt.mean(dim=1)
        cls = self.cls_proj(torch.cat([img_global, txt_pooled], dim=-1))
        return torch.cat([cls[:, None, :], patches, txt_pooled[:, None, :]], dim=1)
