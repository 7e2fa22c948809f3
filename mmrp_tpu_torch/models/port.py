"""Pretrained weights: HF BERT / ClinicalBERT, Swin and MedCLIP checkpoints -> Flax-named trees.

Counterpart of ``mmrp_tpu/models/port.py``. Each converter maps a torch
``state_dict`` (``transformers.BertModel`` / ``BertForPreTraining``,
``SwinModel``, MedCLIP's vision model; the layouts of
``emilyalsentzer/Bio_ClinicalBERT``, ``microsoft/swin-*`` and MedCLIP-ViT) onto
the same Flax-named numpy tree as JAX's converter, which
``utils/convert.py::flax_to_state_dict`` then loads into the port's
``TextEncoder``, ``SwinEncoder`` or ``MedCLIPVisionEncoder``.

Layout notes:
- torch Linear stores (out, in); the Flax Dense kernels are (in, out);
- the Swin q/k/v Dense is one fused (C, 3C) kernel: the converter concatenates;
- the port's PatchMerging concatenates the 2x2 neighbours as
  [x(0,0), x(0,1), x(1,0), x(1,1)], HF as [x(0,0), x(1,0), x(0,1), x(1,1)]:
  the reduction's input rows and the norm are permuted.

:func:`load_pretrained_state` reads a checkpoint from local files only, with
torch and numpy alone (no ``transformers`` or ``safetensors`` package): a
``.pt`` / ``.bin`` / ``.pth`` file through ``torch.load(weights_only=True)``,
a ``.safetensors`` file through :func:`read_safetensors`, a directory through
its ``model.safetensors`` or ``pytorch_model.bin``. A name that is no local
path raises: nothing is fetched.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import numpy as np
import torch

from mmrp_tpu_torch.models.text_encoder import TextConfig


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def _as_np(state: Mapping) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------


def convert_hf_bert(state_dict: Mapping, num_layers: int) -> Dict:
    """HF BertModel state dict (with or without the ``bert.`` prefix; a
    pretraining head's ``cls.*`` keys are ignored) -> the TextEncoder tree."""
    sd = _as_np(state_dict)
    pfx = "bert." if any(k.startswith("bert.") for k in sd) else ""

    def dense(name):  # torch Linear (out, in) -> (in, out) kernel
        return {"kernel": _t(sd[f"{name}.weight"]), "bias": sd[f"{name}.bias"]}

    def norm(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    params: Dict = {"embeddings": {
        "word": {"embedding": sd[f"{pfx}embeddings.word_embeddings.weight"]},
        "position": {"embedding": sd[f"{pfx}embeddings.position_embeddings.weight"]},
        "token_type": {"embedding": sd[f"{pfx}embeddings.token_type_embeddings.weight"]},
        "LayerNorm_0": norm(f"{pfx}embeddings.LayerNorm"),
    }}
    for i in range(num_layers):
        lp = f"{pfx}encoder.layer.{i}"
        params[f"layer{i}"] = {
            "attention": {"query": dense(f"{lp}.attention.self.query"),
                          "key": dense(f"{lp}.attention.self.key"),
                          "value": dense(f"{lp}.attention.self.value"),
                          "out": dense(f"{lp}.attention.output.dense")},
            "attn_norm": norm(f"{lp}.attention.output.LayerNorm"),
            "ffn_in": dense(f"{lp}.intermediate.dense"),
            "ffn_out": dense(f"{lp}.output.dense"),
            "ffn_norm": norm(f"{lp}.output.LayerNorm"),
        }
    return params


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


def convert_hf_swin(state_dict: Mapping, depths) -> Dict:
    """HF SwinModel state dict (with or without the ``swin.`` prefix) -> the
    SwinEncoder tree. Head counts live in the ``rel_bias_table`` columns."""
    sd = _as_np(state_dict)
    pfx = "swin." if any(k.startswith("swin.") for k in sd) else ""

    def dense(name):
        return {"kernel": _t(sd[f"{name}.weight"]), "bias": sd[f"{name}.bias"]}

    def norm(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    params: Dict = {
        "patch_embed": {
            # torch conv (out, in, kh, kw) -> Flax (kh, kw, in, out)
            "proj": {"kernel": np.transpose(
                         sd[f"{pfx}embeddings.patch_embeddings.projection.weight"],
                         (2, 3, 1, 0)),
                     "bias": sd[f"{pfx}embeddings.patch_embeddings.projection.bias"]},
            "LayerNorm_0": norm(f"{pfx}embeddings.norm"),
        },
        "norm": norm(f"{pfx}layernorm"),
    }
    for s, depth in enumerate(depths):
        for b in range(depth):
            lp = f"{pfx}encoder.layers.{s}.blocks.{b}"
            q, k, v = (dense(f"{lp}.attention.self.{n}") for n in ("query", "key", "value"))
            params[f"stage{s}_block{b}"] = {
                "LayerNorm_0": norm(f"{lp}.layernorm_before"),
                "attn": {
                    "rel_bias_table": sd[f"{lp}.attention.self.relative_position_bias_table"],
                    "qkv": {"kernel": np.concatenate([q["kernel"], k["kernel"], v["kernel"]],
                                                     axis=1),
                            "bias": np.concatenate([q["bias"], k["bias"], v["bias"]])},
                    "proj": dense(f"{lp}.attention.output.dense"),
                },
                "LayerNorm_1": norm(f"{lp}.layernorm_after"),
                "mlp": {"Dense_0": dense(f"{lp}.intermediate.dense"),
                        "Dense_1": dense(f"{lp}.output.dense")},
            }
        dkey = f"{pfx}encoder.layers.{s}.downsample"
        if f"{dkey}.reduction.weight" in sd:
            red = _t(sd[f"{dkey}.reduction.weight"])  # (4C, 2C)
            C = red.shape[0] // 4
            # HF neighbour order [x00, x10, x01, x11] -> the port's [x00, x01, x10, x11]
            perm = np.concatenate([np.arange(0, C), np.arange(2 * C, 3 * C),
                                   np.arange(C, 2 * C), np.arange(3 * C, 4 * C)])
            params[f"merge{s}"] = {
                "LayerNorm_0": {"scale": sd[f"{dkey}.norm.weight"][perm],
                                "bias": sd[f"{dkey}.norm.bias"][perm]},
                "Dense_0": {"kernel": red[perm]},
            }
    return params


# ---------------------------------------------------------------------------
# MedCLIP (vision tower = HF SwinModel + bias-free projection head)
# ---------------------------------------------------------------------------


def convert_medclip_vit(state_dict: Mapping, depths=(2, 2, 6, 2)) -> Dict:
    """MedCLIP-ViT checkpoint -> the MedCLIPVisionEncoder tree: a full
    MedCLIPModel state dict (``vision_model.`` prefix; the text branch is
    ignored) or a bare vision-model dict (``model.`` + ``projection_head.``).
    A dict without the vision tower raises ``KeyError``."""
    sd = _as_np(state_dict)
    pfx = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    swin_sd = {k[len(pfx) + len("model."):]: v for k, v in sd.items()
               if k.startswith(f"{pfx}model.")}
    if not swin_sd:
        raise KeyError("no vision tower found: expected '[vision_model.]model.*' keys")
    return {"swin": convert_hf_swin(swin_sd, depths),
            "projection": {"kernel": _t(sd[f"{pfx}projection_head.weight"])}}


# ---------------------------------------------------------------------------
# Reading a checkpoint from local files
# ---------------------------------------------------------------------------

# safetensors dtype -> (numpy dtype of the raw buffer, returned as f32); I64
# for the int64 buffers HF checkpoints carry (position ids, Swin's
# relative_position_index)
_ST_DTYPES = {"F32": (np.float32, True), "F16": (np.float16, True),
              "BF16": (np.uint16, True), "I64": (np.int64, False)}


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: numpy array}: an 8-byte
    little-endian header length, the JSON header (dtype, shape and byte range
    of each tensor, an optional ``__metadata__``), then the raw buffers.
    F32, F16 and BF16 tensors come back as f32, I64 ones as int64."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({', '.join(_ST_DTYPES)})")
        raw, is_float = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        arr = np.frombuffer(data[start:end], dtype=np.dtype(raw).newbyteorder("<"))
        if info["dtype"] == "BF16":  # the high half of an f32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        arr = arr.astype(np.float32) if is_float else arr.astype(raw)
        out[name] = arr.reshape(info["shape"])
    return out


def load_pretrained_state(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's state dict as numpy arrays, from a ``.pt`` / ``.bin`` /
    ``.pth`` file, a ``.safetensors`` file, or an HF model directory (its
    ``model.safetensors``, else its ``pytorch_model.bin``)."""
    path = str(path)
    if os.path.isdir(path):
        for name in ("model.safetensors", "pytorch_model.bin"):
            if os.path.isfile(os.path.join(path, name)):
                return load_pretrained_state(os.path.join(path, name))
        raise FileNotFoundError(f"{path}: a directory without model.safetensors or "
                                "pytorch_model.bin")
    if os.path.splitext(path)[1] in (".pt", ".bin", ".pth"):
        return _as_np(torch.load(path, map_location="cpu", weights_only=True))
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    raise FileNotFoundError(
        f"{path}: not a local checkpoint file or directory; the port fetches nothing "
        "(download the checkpoint and name its file or directory)")


def text_config_from_state(sd: Mapping, num_heads: int = 0, **kw) -> TextConfig:
    """The TextConfig of an HF BertModel state dict: the checkpoint's vocab,
    width, depth, FFN width, positions and token types. Heads are not in the
    tensor shapes: ``hidden // 64`` unless given (every BERT-family release
    uses 64-wide heads)."""
    sd = _as_np(sd)
    pfx = "bert." if any(k.startswith("bert.") for k in sd) else ""
    emb = sd[f"{pfx}embeddings.word_embeddings.weight"]
    layers = {int(k.split(".")[3 if pfx else 2]) for k in sd
              if k.startswith(f"{pfx}encoder.layer.")}
    hidden = emb.shape[1]
    return TextConfig(
        vocab_size=emb.shape[0],
        hidden_dim=hidden,
        num_layers=max(layers) + 1,
        num_heads=num_heads or max(1, hidden // 64),
        intermediate_dim=sd[f"{pfx}encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_positions=sd[f"{pfx}embeddings.position_embeddings.weight"].shape[0],
        type_vocab_size=sd[f"{pfx}embeddings.token_type_embeddings.weight"].shape[0],
        **kw,
    )


def swin_layout_from_state(sd: Mapping):
    """(depths, num_heads) of an HF SwinModel state dict: blocks counted per
    stage, heads from each stage's relative-position-bias table."""
    sd = _as_np(sd)
    pfx = "swin." if any(k.startswith("swin.") for k in sd) else ""
    stage_blocks: Dict[int, int] = {}
    heads: Dict[int, int] = {}
    for k, v in sd.items():
        if not k.startswith(f"{pfx}encoder.layers."):
            continue
        rest = k[len(f"{pfx}encoder.layers."):]
        parts = rest.split(".")
        s = int(parts[0])
        if parts[1] == "blocks":
            stage_blocks[s] = max(stage_blocks.get(s, 0), int(parts[2]) + 1)
            if rest.endswith("relative_position_bias_table"):
                heads[s] = v.shape[1]
    n_stages = max(stage_blocks) + 1
    return (tuple(stage_blocks[s] for s in range(n_stages)),
            tuple(heads[s] for s in range(n_stages)))
