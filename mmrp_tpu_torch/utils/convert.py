"""Weights for the port: the Flax <-> state-dict bridge and a seeded init.

``flax_to_state_dict`` maps a Flax parameter tree of ``mmrp_tpu`` (a nested
dict of arrays, with or without the top-level ``"params"``), the flat
``/``-joined dict that ``mmrp_tpu/utils/checkpoint.py::save_param_tree``
writes to an npz, or a JAX ``TrainState.params`` (``{"model": ...,
"kg_proj": ...}``) onto the port's ``state_dict``. Module paths are the same
in both packages; leaves change as follows:

- Dense ``kernel`` (in, out) -> nn.Linear ``weight`` (out, in), which covers
  the ``MhaParams`` query/key/value/out kernels and the Swin ``qkv`` (C, 3C)
  kernel, whose [q | k | v] columns become rows;
- the Swin PatchEmbed conv ``kernel`` (kh, kw, in, out), under ``proj`` ->
  ``weight`` (out, kh*kw*in), flattened in the (kh, kw, in) order of the
  space-to-depth patches;
- every other conv ``kernel`` (kh, kw, in / groups, out) -> nn.Conv2d
  ``weight`` (out, in / groups, kh, kw), the depthwise convs (in / groups 1)
  included (the ViT, ResNet and EfficientNet towers);
- the Flax ``nn.MultiHeadDotProductAttention`` DenseGeneral kernels:
  ``query`` / ``key`` / ``value`` (in, h, d) -> ``weight`` (h * d, in),
  ``out`` (h, d, out) -> ``weight`` (out, h * d), and their (h, d) biases
  flattened (the finetune head, ``models/finetune_head.py``);
- LayerNorm and GroupNorm ``scale`` -> ``weight``; ``nn.Embed`` ``embedding``
  -> ``weight``;
- ``bias``, ``rel_bias_table``, ``pos_embed``, ``cls_token``, ``alpha`` and
  the null tokens keep name and layout, and so does the train state's
  top-level ``kg_proj`` (joint_dim, kg_dim), which is no model parameter:
  :func:`load_flax_params` returns it for the train state (``train/state.py``).

Int8 weight caches (``ops/quant.py``): the JAX package quantizes the f32
parameters for its static Swin cache and its ``quant_dot`` GEMMs, so after a
load the caches marked ``from_master`` are rebuilt from the tree's f32 arrays
before the cast to the module's dtype can round them (a bf16-rounded weight
can move an int8 value by one step). The caches of the kernels that, in JAX,
quantize the bf16-cast weights they are given (``_qdot`` in K3, dynamic Swin)
keep the module's weight. After :func:`init_params` both are the module's
weights, bf16 in a bf16 model.

:func:`state_dict_to_flax_flat` is the inverse: a port model's weights as
the flat dict ``save_param_tree`` writes, which :func:`save_param_tree` here
writes to an npz with numpy alone (a run directory's ``joint/params.npz``,
``serve/runner.py``) and the JAX package's ``load_param_tree`` reads.

The module reads and writes numpy arrays only; it needs no JAX.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from mmrp_tpu_torch.models.layers import GroupNorm, LayerNorm, MultiHeadDotProductAttention
from mmrp_tpu_torch.models.quant_calib import build_quant_cache
from mmrp_tpu_torch.models.swin import PatchEmbed, WindowAttention


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _convert_leaf(leaf: str, arr: np.ndarray, parent: str = ""):
    if arr.dtype.kind not in "fiu":  # e.g. bfloat16 from ml_dtypes
        arr = arr.astype(np.float32)
    if leaf == "bias" and arr.ndim == 2:  # a DenseGeneral's (h, d)
        return leaf, arr.reshape(-1)
    if leaf == "kernel":
        if arr.ndim == 4 and parent != "proj":  # conv (kh, kw, in/g, out)
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 4:  # (kh, kw, in, out) conv kernel of the Swin PatchEmbed
            arr = arr.reshape(-1, arr.shape[-1])
        elif arr.ndim == 3:  # DenseGeneral: out (h, d, D), query/key/value (D, h, d)
            arr = (arr.reshape(-1, arr.shape[-1]) if parent == "out" else
                   arr.reshape(arr.shape[0], -1))
        if arr.ndim != 2:
            raise ValueError(f"unexpected kernel rank {arr.ndim}")
        return "weight", arr.T
    if leaf in ("scale", "embedding"):
        return "weight", arr
    return leaf, arr


def state_items(tree: Mapping[str, Any]):
    """(state-dict key, numpy array in the port's layout) for every leaf of a
    Flax param tree, nested or ``/``-joined flat; the arrays may be views."""
    for key, arr in _flatten(tree).items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        if parts[0] == "model":
            parts = parts[1:]
        name, arr = _convert_leaf(parts[-1], arr, parts[-2] if len(parts) > 1 else "")
        yield ".".join(parts[:-1] + [name]), arr


def flax_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested or ``/``-joined flat) -> port state dict (f32)."""
    return {key: torch.from_numpy(np.array(arr, dtype=np.float32))
            for key, arr in state_items(tree)}


def load_flax_params(model: nn.Module, tree_or_npz) -> Dict[str, torch.Tensor]:
    """Load a Flax tree, or the path of a ``save_param_tree`` npz, into
    ``model`` (strict: every parameter must be covered, nothing left over but
    ``kg_proj``). Values are cast to each parameter's dtype; the int8 caches
    that quantize f32 parameters take the tree's (module docstring). Returns
    ``{"kg_proj": f32 tensor}`` when the tree is a train state's, else {}."""
    if isinstance(tree_or_npz, Mapping):
        tree = tree_or_npz
    else:
        with np.load(tree_or_npz) as z:
            tree = {k: z[k] for k in z.files}
    state = flax_to_state_dict(tree)
    extra = {k: state.pop(k) for k in ("kg_proj",) if k in state}
    model.load_state_dict(state, strict=True)
    build_quant_cache(model, master=state, stale_only=True)
    return extra


def state_dict_to_flax_flat(model: nn.Module,
                            params: Mapping[str, torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """The model's weights (or ``params``, values under the model's parameter
    names, such as a train state's f32 masters) as the Flax parameter tree,
    flat with ``/``-joined keys (the keys ``save_param_tree`` writes for the
    model's tree), f32:
    nn.Linear ``weight`` -> ``kernel`` (in, out), PatchEmbed's as the conv
    kernel (kh, kw, in, out), nn.Conv2d ``weight`` -> the conv ``kernel``
    (kh, kw, in / groups, out), LayerNorm and GroupNorm ``weight`` ->
    ``scale``, nn.Embedding ``weight`` -> ``embedding``; every other leaf
    keeps name and layout.
    :func:`flax_to_state_dict` maps it back exactly."""
    patch = {f"{path}.proj": m.patch_size for path, m in model.named_modules()
             if isinstance(m, PatchEmbed)}
    # the DenseGeneral projections of a Flax MHA: path -> heads
    heads = {f"{path}.{lin}": m.num_heads for path, m in model.named_modules()
             if isinstance(m, MultiHeadDotProductAttention)
             for lin in ("query", "key", "value", "out")}
    names = flax_paths(model)
    flat = {}
    for path, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            key = f"{path}.{name}" if path else name
            if params is not None:
                p = params[key]
            arr = p.detach().float().cpu().numpy()
            h = heads.get(path)
            if isinstance(module, nn.Linear) and name == "weight":
                arr = arr.T
                if path in patch:
                    arr = arr.reshape(patch[path], patch[path], -1, arr.shape[-1])
                elif h and path.endswith(".out"):
                    arr = arr.reshape(h, -1, arr.shape[-1])
                elif h:
                    arr = arr.reshape(arr.shape[0], h, -1)
            elif isinstance(module, nn.Conv2d) and name == "weight":
                arr = arr.transpose(2, 3, 1, 0)
            elif h and name == "bias" and not path.endswith(".out"):
                arr = arr.reshape(h, -1)
            flat[names[key][0]] = np.array(arr, order="C")
    return flat


def flax_paths(model: nn.Module) -> Dict[str, tuple]:
    """{parameter name: (its Flax path, ``/``-joined, the key
    :func:`state_items` maps back from; whether the port's tensor is the
    transpose of the Flax array)}: the naming of
    :func:`state_dict_to_flax_flat`. Only an nn.Linear weight that is a 2-D
    Dense kernel is a plain transpose; a conv, PatchEmbed or DenseGeneral
    kernel changes rank and is marked False with its name."""
    patch = {f"{path}.proj" for path, m in model.named_modules() if isinstance(m, PatchEmbed)}
    mha = {f"{path}.{lin}" for path, m in model.named_modules()
           if isinstance(m, MultiHeadDotProductAttention)
           for lin in ("query", "key", "value", "out")}
    out = {}
    for path, module in model.named_modules():
        for name in dict(module.named_parameters(recurse=False)):
            leaf, transposed = name, False
            if isinstance(module, nn.Linear) and name == "weight":
                leaf, transposed = "kernel", path not in patch and path not in mha
            elif isinstance(module, nn.Conv2d) and name == "weight":
                leaf = "kernel"
            elif isinstance(module, (LayerNorm, GroupNorm)) and name == "weight":
                leaf = "scale"
            elif isinstance(module, nn.Embedding) and name == "weight":
                leaf = "embedding"
            key = f"{path}.{name}" if path else name
            # a parameter of the root module itself (a null token, the ViT's
            # cls token) has no path
            out[key] = ("/".join((path.split(".") if path else []) + [leaf]), transposed)
    return out


def save_param_tree(path, flat: Mapping[str, np.ndarray]) -> None:
    """A flat ``/``-joined dict -> one npz, through a temporary file, as
    ``mmrp_tpu/utils/checkpoint.py::save_param_tree`` writes it, but
    uncompressed: compressing the flagship's 1.5 GB of f32 takes minutes, and
    ``np.load`` reads either."""
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **flat)
    Path(tmp).replace(path)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> None:
    """Seeded init on the parameters' device, in Flax-like distributions, with
    every parameter nonzero (Flax starts biases, LN offsets and ``alpha`` at
    zero, which would hide whole branches from a check):

    - nn.Linear and nn.Conv2d weights lecun-normal (std 1/sqrt(fan_in), a
      conv's fan_in in / groups * kh * kw), biases N(0, 0.02^2);
    - LayerNorm and GroupNorm weights 1 + N(0, 0.02^2), biases N(0, 0.02^2);
    - ``alpha`` U(0.25, 0.75);
    - everything else (embeddings, positional tables, relative-position
      tables, null and cls tokens) N(0, 0.02^2).

    The window biases and the int8 weight caches are rebuilt from the new
    weights.
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
            elif isinstance(module, nn.Conv2d) and name == "weight":
                normal(p, p[0].numel() ** -0.5)
            elif isinstance(module, (LayerNorm, GroupNorm)) and name == "weight":
                normal(p, 0.02, mean=1.0)
            elif name == "alpha":
                p.copy_(torch.rand(p.shape, generator=gen, device=device) * 0.5 + 0.25)
            else:
                normal(p, 0.02)
        if isinstance(module, WindowAttention):
            module.refresh_bias()
    build_quant_cache(model, stale_only=True)
