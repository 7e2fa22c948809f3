"""Weights for the port: the Flax -> state-dict bridge and a seeded init.

``flax_to_state_dict`` maps a Flax parameter tree of ``mmrp_tpu`` (a nested
dict of arrays, with or without the top-level ``"params"``), the flat
``/``-joined dict that ``mmrp_tpu/utils/checkpoint.py::save_param_tree``
writes to an npz, or a JAX ``TrainState.params`` (``{"model": ...,
"kg_proj": ...}``) onto the port's ``state_dict``. Module paths are the same
in both packages; leaves change as follows:

- Dense ``kernel`` (in, out) -> nn.Linear ``weight`` (out, in), which covers
  the ``MhaParams`` query/key/value/out kernels and the Swin ``qkv`` (C, 3C)
  kernel, whose [q | k | v] columns become rows;
- the PatchEmbed conv ``kernel`` (kh, kw, in, out) -> ``weight``
  (out, kh*kw*in), flattened in the (kh, kw, in) order of the space-to-depth
  patches;
- LayerNorm ``scale`` -> ``weight``; ``nn.Embed`` ``embedding`` -> ``weight``;
- ``bias``, ``rel_bias_table``, ``pos_embed``, ``alpha`` and the null tokens
  keep name and layout, and so does the train state's top-level ``kg_proj``
  (joint_dim, kg_dim), which is no model parameter: :func:`load_flax_params`
  returns it for the train state (``train/state.py``).

The module reads numpy arrays only; it needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mmrp_tpu_torch.models.layers import LayerNorm
from mmrp_tpu_torch.models.swin import WindowAttention


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _convert_leaf(leaf: str, arr: np.ndarray):
    if arr.dtype.kind not in "fiu":  # e.g. bfloat16 from ml_dtypes
        arr = arr.astype(np.float32)
    if leaf == "kernel":
        if arr.ndim == 4:  # (kh, kw, in, out) conv kernel of PatchEmbed
            arr = arr.reshape(-1, arr.shape[-1])
        if arr.ndim != 2:
            raise ValueError(f"unexpected kernel rank {arr.ndim}")
        return "weight", arr.T
    if leaf in ("scale", "embedding"):
        return "weight", arr
    return leaf, arr


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested or ``/``-joined flat) -> port state dict (f32)."""
    flat = _flatten(tree)
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[0] == "model":
            parts = parts[1:]
        name, arr = _convert_leaf(parts[-1], arr)
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def load_flax_params(model: nn.Module, tree_or_npz) -> Dict[str, torch.Tensor]:
    """Load a Flax tree, or the path of a ``save_param_tree`` npz, into
    ``model`` (strict: every parameter must be covered, nothing left over but
    ``kg_proj``). Values are cast to each parameter's dtype. Returns
    ``{"kg_proj": f32 tensor}`` when the tree is a train state's, else {}."""
    if isinstance(tree_or_npz, Mapping):
        tree = tree_or_npz
    else:
        with np.load(tree_or_npz) as z:
            tree = {k: z[k] for k in z.files}
    state = flax_to_state_dict(tree)
    extra = {k: state.pop(k) for k in ("kg_proj",) if k in state}
    model.load_state_dict(state, strict=True)
    return extra


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> None:
    """Seeded init on the parameters' device, in Flax-like distributions, with
    every parameter nonzero (Flax starts biases, LN offsets and ``alpha`` at
    zero, which would hide whole branches from a check):

    - nn.Linear weights lecun-normal (std 1/sqrt(fan_in)), biases N(0, 0.02^2);
    - LayerNorm weights 1 + N(0, 0.02^2), biases N(0, 0.02^2);
    - ``alpha`` U(0.25, 0.75);
    - everything else (embeddings, positional tables, relative-position
      tables, null tokens) N(0, 0.02^2).
    """
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(p, std, mean=0.0):
        p.copy_(torch.randn(p.shape, generator=gen, device=device) * std + mean)

    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, nn.Linear) and name == "weight":
                normal(p, module.in_features ** -0.5)
            elif isinstance(module, LayerNorm) and name == "weight":
                normal(p, 0.02, mean=1.0)
            elif name == "alpha":
                p.copy_(torch.rand(p.shape, generator=gen, device=device) * 0.5 + 0.25)
            else:
                normal(p, 0.02)
        if isinstance(module, WindowAttention):
            module.refresh_bias()
