"""Reference-semantics fusion stack: the reference's eval-time math and its weight converter.

Counterpart of ``mmrp_tpu/models/ref_port.py``. The production model
(``models/multimodal.py``) redesigns the reference's fusion architecture;
this module reproduces the reference's own eval-time forward, so that a
checkpoint trained with the reference's torch code can be converted
(:func:`convert_reference_state`) and served with its joint embeddings,
logits and attention maps:

- ``PreFusionEnhancer``: ``x += pos[:L]; x2 = MHA(x, x, x); out = LN(alpha * x + x2)``;
- ``CrossModalFusion``: bidirectional cross-attention at the raw backbone
  dims with separate q/k/v projections into the joint dim, residual
  projections, ``ln_img`` / ``ln_txt``, the ``[x1, patches_fused, x2]``
  sequence, and the cls-only ``comb_mlp`` pooled variant;
- the model's fusion loop: per-layer fusion -> positional encoding -> the
  shared self-attention -> mean-pool -> ``norm1`` / stochastic-depth residual
  with a learnable ``alpha`` -> ``norm2`` + FFN (shared or per layer) ->
  adapter; the image-only and text-only modes; the 4x-wide MLP classifier.

Eval semantics only (dropout and stochastic depth are identity), torch
LayerNorm's eps 1e-5, and the exact (erf) GELU: the one use of it in the
port; every other module takes JAX's tanh form. The model-level
``use_cls_only=True`` crashes in the reference, so :func:`reference_forward`
rejects it as JAX's does; the fusion-module cls-only variant is supported.
Plain PyTorch throughout: JAX computes this module outside any Pallas
kernel. The converters return numpy trees, as JAX's do;
:func:`params_to_torch` puts one on a device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_LN_EPS = 1e-5  # torch nn.LayerNorm's default


def _ln(p: Params, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + _LN_EPS) * p["weight"] + p["bias"]


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["weight"] + p["bias"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf): torch nn.GELU's default


def _mha(p: Params, q_in: torch.Tensor, kv_in: torch.Tensor,
         num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch nn.MultiheadAttention with a shared key = value input."""
    return _mha_kv(p, q_in, kv_in, kv_in, num_heads)


def _mha_kv(p: Params, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
            num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch nn.MultiheadAttention (batch_first, eval) with distinct
    query / key / value inputs: its packed in-projection runs on top of
    whatever the caller passes. Returns (out, head-averaged weights
    (B, Lq, Lk))."""
    B, Lq, D = q_in.shape
    H = num_heads
    d = D // H
    Lk = k_in.shape[1]
    q = (q_in @ p["wq"] + p["bq"]).reshape(B, Lq, H, d)
    k = (k_in @ p["wk"] + p["bk"]).reshape(B, Lk, H, d)
    v = (v_in @ p["wv"] + p["bv"]).reshape(B, Lk, H, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(np.sqrt(d))
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Lq, D)
    return ctx @ p["wo"] + p["bo"], attn.mean(dim=1)


def _enhancer(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """PreFusionEnhancer's eval forward."""
    x = x + p["pos_embed"][:, : x.shape[1]]
    x2, _ = _mha(p["attn"], x, x, num_heads)
    return _ln(p["norm1"], p["alpha"] * x + x2)


def cross_modal_fusion(p: Params, img_global: torch.Tensor, img_patch: torch.Tensor,
                       txt_feats: Optional[torch.Tensor], num_heads: int,
                       use_cls_only: bool = False):
    """CrossModalFusion's eval forward -> (seq (B, 1+Np+1, joint), or the
    fused vector (B, joint) with ``use_cls_only``; {txt2img, img2txt}
    head-averaged weights, plus ``patch_avg`` with ``use_cls_only``). No text
    takes the learned default token."""
    if txt_feats is None:
        B = img_global.shape[0] if img_global is not None else img_patch.shape[0]
        tok = p["default_txt_token"]
        txt_feats = tok.expand((B,) + tuple(tok.shape[1:]))
    txt_feats = _enhancer(p["txt_self_attn"], txt_feats, num_heads)
    img_global = _enhancer(p["img_global_self_attn"], img_global[:, None, :], num_heads)[:, 0]
    img_patch = _enhancer(p["img_patch_self_attn"], img_patch, num_heads)

    txt_pooled = txt_feats[:, 0:1] if use_cls_only else txt_feats
    att_t2i, w_t2i = _mha_kv(p["attn_txt2img"], _linear(p["query_txt"], txt_pooled),
                             _linear(p["key_img"], img_patch),
                             _linear(p["value_img"], img_patch), num_heads)
    att_i2t, w_i2t = _mha_kv(p["attn_img2txt"], _linear(p["query_img"], img_patch),
                             _linear(p["key_txt"], txt_pooled),
                             _linear(p["value_txt"], txt_pooled), num_heads)

    patches_fused = _linear(p["img_patch_proj"], img_patch) + att_i2t
    x1 = _ln(p["ln_img"], _linear(p["img_global_proj"], img_global) + att_t2i.mean(dim=1))
    x2 = _ln(p["ln_txt"], _linear(p["txt_proj"], txt_feats)[:, 0] + att_i2t.mean(dim=1))

    attn = {"txt2img": w_t2i, "img2txt": w_i2t}
    if use_cls_only:
        patch_avg = patches_fused.mean(dim=1)
        h = _gelu(_linear(p["comb_mlp_0"], torch.cat([x1, patch_avg, x2], dim=1)))
        attn["patch_avg"] = patch_avg
        return _linear(p["comb_mlp_3"], h), attn
    return torch.cat([x1[:, None, :], patches_fused, x2[:, None, :]], dim=1), attn


def _mlp2(p0: Params, p1: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear -> GELU -> Linear (the FFNs, the adapters, ``comb_mlp``)."""
    return _linear(p1, _gelu(_linear(p0, x)))


def reference_forward(params: Params, img_global: Optional[torch.Tensor],
                      img_patches: Optional[torch.Tensor], txt_feats: Optional[torch.Tensor],
                      *, num_heads: int, model_type: str = "multimodal",
                      use_cls_only: bool = False, use_shared_ffn: bool = True,
                      return_attention: bool = False) -> Dict[str, Any]:
    """The reference model's eval forward from the backbone features on ->
    {joint_emb, img_emb, txt_emb, logits, attn}."""
    if use_cls_only and model_type == "multimodal":
        raise NotImplementedError(
            "reference model.py:428-429 crashes for use_cls_only=True (2-D index on "
            "fused_vec); not a supported reference config")
    attn_weights: Dict[str, torch.Tensor] = {}
    img_emb = _linear(params["img_proj"], img_global) if img_global is not None else None
    if txt_feats is not None:
        txt_pool = txt_feats[:, 0] if use_cls_only else txt_feats.mean(dim=1)
        txt_emb = _linear(params["txt_proj"], txt_pool)
    else:
        txt_emb = None

    def ffn_of(i):
        return params["shared_ffn"] if use_shared_ffn else params["ffn"][i]

    if model_type == "multimodal":
        joint_emb = None
        for i, fp in enumerate(params["fusion_layers"]):
            seq, from_fusion = cross_modal_fusion(fp, img_global, img_patches, txt_feats,
                                                  num_heads, use_cls_only=use_cls_only)
            pe = params["pos_encoder_pe"]
            if seq.shape[1] > pe.shape[1]:
                raise ValueError("sequence longer than pos encoder table")
            seq = seq + pe[:, : seq.shape[1]]
            seq_out, comb_w = _mha(params["self_attn"], seq, seq, num_heads)
            if return_attention:
                attn_weights[f"layer_{i}_comb"] = comb_w
                attn_weights[f"layer_{i}_txt2img"] = from_fusion["txt2img"]
                attn_weights[f"layer_{i}_img2txt"] = from_fusion["img2txt"]
            fused = seq_out.mean(dim=1)
            if i == 0:
                x = fused
            else:  # stochastic depth at eval: x + residual
                x = _ln(params["norm1_layers"][i], joint_emb) + params["alpha"] * fused
            ffn = ffn_of(i)
            x = x + _mlp2(ffn["linear1"], ffn["linear2"], _ln(params["norm2_layers"][i], x))
            ad = params["adapters"][i]
            joint_emb = x + _mlp2(ad["0"], ad["2"], x)
    elif model_type == "image":
        g = _linear(params["img_proj"], img_global)
        pch = _linear(params["img_proj"], img_patches)
        pooled = torch.cat([g[:, None, :], pch], dim=1).mean(dim=1)
        ffn = ffn_of(0)
        joint_emb = _mlp2(ffn["linear1"], ffn["linear2"], pooled)
    elif model_type == "text":
        x = txt_feats[:, 0] if use_cls_only else txt_feats.mean(dim=1)
        ffn = ffn_of(0)
        joint_emb = _mlp2(ffn["linear1"], ffn["linear2"], _linear(params["txt_proj"], x))
    else:
        raise ValueError(model_type)

    logits = _linear(params["classifier_3"], _gelu(_linear(params["classifier_0"], joint_emb)))
    return {"joint_emb": joint_emb, "img_emb": img_emb, "txt_emb": txt_emb, "logits": logits,
            "attn": attn_weights if return_attention else None}


def params_to_torch(tree, device="cpu"):
    """A converted tree (nested dicts and lists of numpy arrays) as f32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


# ---------------------------------------------------------------------------
# torch state dict -> params
# ---------------------------------------------------------------------------


def _t(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v).astype(np.float32)


def _conv_linear(sd: Dict, prefix: str) -> Params:
    return {"weight": _t(sd[f"{prefix}.weight"]).T, "bias": _t(sd[f"{prefix}.bias"])}


def _conv_ln(sd: Dict, prefix: str) -> Params:
    return {"weight": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _conv_mha(sd: Dict, prefix: str) -> Params:
    """torch MultiheadAttention: packed in_proj (3D, D) + out_proj."""
    w = _t(sd[f"{prefix}.in_proj_weight"])
    b = _t(sd[f"{prefix}.in_proj_bias"])
    D = w.shape[0] // 3
    return {"wq": w[:D].T, "bq": b[:D], "wk": w[D:2 * D].T, "bk": b[D:2 * D],
            "wv": w[2 * D:].T, "bv": b[2 * D:],
            "wo": _t(sd[f"{prefix}.out_proj.weight"]).T, "bo": _t(sd[f"{prefix}.out_proj.bias"])}


def _conv_enhancer(sd: Dict, prefix: str) -> Params:
    return {"attn": _conv_mha(sd, f"{prefix}.self_attn"), "norm1": _conv_ln(sd, f"{prefix}.norm1"),
            "pos_embed": _t(sd[f"{prefix}.pos_embed"]), "alpha": _t(sd[f"{prefix}.alpha"])}


def convert_fusion_state(sd: Dict, prefix: str = "") -> Params:
    """CrossModalFusion.state_dict() -> params for :func:`cross_modal_fusion`."""
    p = prefix
    out = {name: _conv_enhancer(sd, f"{p}{name}") for name in
           ("txt_self_attn", "img_patch_self_attn", "img_global_self_attn")}
    out.update({name: _conv_ln(sd, f"{p}{name}") for name in ("ln_img", "ln_txt")})
    out.update({name: _conv_linear(sd, f"{p}{name}") for name in
                ("query_txt", "key_img", "value_img", "query_img", "key_txt", "value_txt",
                 "txt_proj", "img_patch_proj", "img_global_proj")})
    out.update({name: _conv_mha(sd, f"{p}{name}") for name in ("attn_txt2img", "attn_img2txt")})
    out["default_txt_token"] = _t(sd[f"{p}default_txt_token"])
    out["comb_mlp_0"] = _conv_linear(sd, f"{p}comb_mlp.0")
    out["comb_mlp_3"] = _conv_linear(sd, f"{p}comb_mlp.3")
    return out


def convert_reference_state(sd: Dict, num_fusion_layers: int,
                            use_shared_ffn: bool = True) -> Params:
    """MultiModalRetrievalModel.state_dict() -> params for
    :func:`reference_forward`. Backbone keys (``backbones.*``) are ignored:
    the backbones convert through ``models/port.py``."""
    n = range(num_fusion_layers)
    params: Params = {
        "fusion_layers": [convert_fusion_state(sd, f"fusion_layers.{i}.") for i in n],
        "self_attn": _conv_mha(sd, "self_attn"),
        "norm1_layers": [_conv_ln(sd, f"norm1_layers.{i}") for i in n],
        "norm2_layers": [_conv_ln(sd, f"norm2_layers.{i}") for i in n],
        "alpha": _t(sd["alpha"]),
        "pos_encoder_pe": _t(sd["pos_encoder.pe"]),
        "img_proj": _conv_linear(sd, "img_proj"),
        "txt_proj": _conv_linear(sd, "txt_proj"),
        "adapters": [{"0": _conv_linear(sd, f"adapters.{i}.0"),
                      "2": _conv_linear(sd, f"adapters.{i}.2")} for i in n],
        "classifier_0": _conv_linear(sd, "classifier.0"),
        "classifier_3": _conv_linear(sd, "classifier.3"),
    }
    if use_shared_ffn:
        params["shared_ffn"] = {"linear1": _conv_linear(sd, "shared_ffn.linear1"),
                                "linear2": _conv_linear(sd, "shared_ffn.linear2")}
    else:
        params["ffn"] = [{"linear1": _conv_linear(sd, f"ffn.{i}.linear1"),
                          "linear2": _conv_linear(sd, f"ffn.{i}.linear2")} for i in n]
    return params
