"""Device mesh and placements over ``torch.distributed``.

Counterpart of ``mmrp_tpu/parallel/mesh.py``. JAX's ``Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the same axis names; a ``PartitionSpec`` is a tuple of
DTensor placements, one per mesh dimension (``Shard(d)`` where the spec names
that axis at dimension ``d``, ``Replicate()`` elsewhere).

- ``build_mesh``: the mesh over the ranks of the group (``devices`` is a list
  of ranks), one axis size of -1 filled from their number, and JAX's error
  when the sizes do not multiply to it.
- ``param_shardings`` / ``shard_params``: the tensor-parallel rules of JAX
  (``DEFAULT_TP_RULES``), matched against the Flax path of each parameter
  (``utils/convert.py::flax_paths``, the ``/``-joined name that
  ``state_items`` maps back from), falling back to replication where the
  mesh has no such axis or the axis does not divide the dimension. The rules
  are written in Flax's layout, a Dense kernel (in, out); the port's weight is
  (out, in), so ``(None, "tp")`` shards the port's dimension 0 and
  ``("tp", None)`` its dimension 1.

A placed parameter is a ``DTensor`` holding this rank's block. The kernels
take whole weights: a train step gathers each placed master
(``DTensor.full_tensor``) into the model before it runs, as GSPMD gathers the
operands of a custom call it cannot partition, and updates only its block.
Where the model calls a placed linear itself (the plain routes: the text
FFN, the classifier head), ``tensor_parallel`` runs it on the block, column-
or row-parallel with one all-reduce, as GSPMD partitions a dot.
"""

from __future__ import annotations

import contextlib
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]  # a PartitionSpec in Flax's layout

# JAX's rules: regexes over the '/'-joined Flax path; specs by Flax dimension
DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*cls_hidden/kernel$", (None, "tp")),   # (D, 4D) column-parallel
    (r".*cls_out/kernel$", ("tp", None)),      # (4D, C) row-parallel
    (r".*ffn/Dense_0/kernel$", (None, "tp")),  # fusion FFN in
    (r".*ffn/Dense_1/kernel$", ("tp", None)),  # fusion FFN out
    (r".*ffn_in/kernel$", (None, "tp")),       # text FFN in
    (r".*ffn_out/kernel$", ("tp", None)),      # text FFN out
]


def build_mesh(axis_names: Sequence[str] = ("dp",), axis_sizes: Optional[Sequence[int]] = None,
               devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` named ``axis_names`` over ``devices`` (ranks of the
    default process group, all of them by default). ``axis_sizes`` may hold
    one -1, filled with the ranks left. Every rank of the group calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh: no process group; start one with "
                           "parallel.collectives.initialize_distributed")
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    sizes = list(axis_sizes)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {tuple(sizes)} != {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(devices, dtype=torch.int64).reshape(sizes),
                      mesh_dim_names=tuple(axis_names))


def mesh_shape(mesh) -> "OrderedDict[str, int]":
    """JAX's ``mesh.shape``: axis name -> size, in order."""
    return OrderedDict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return int(mesh_shape(mesh)[axis])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX's ``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh, data_axis: str = "dp") -> tuple:
    """Placements of a batch: the leading dimension sharded over ``data_axis``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == data_axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def rows_of(x, mesh, axis: str = "dp"):
    """This rank's block of rows of ``x`` (numpy or tensor) under ``Shard(0)``
    over ``axis``; the rows must divide evenly, as JAX requires."""
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not shard over {n} devices of {axis!r}")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _flax_spec_to_port(spec: Spec, transposed: bool) -> Spec:
    """A spec by Flax dimension -> by the port tensor's dimension."""
    return tuple(reversed(spec)) if transposed else tuple(spec)


def param_shardings(params: Dict[str, torch.Tensor], mesh, model=None,
                    rules: Optional[List[Tuple[str, Spec]]] = None) -> Dict[str, tuple]:
    """{name: placements} for ``params`` (the model's parameter names, and a
    train state's ``kg_proj``): the first rule whose regex matches the Flax
    path and whose axes exist and divide the dimensions, else replicated.
    The Flax paths come from ``model`` (``utils/convert.py::flax_paths``); a
    name the model does not have (``kg_proj``) is its own path."""
    from torch.distributed.tensor import Replicate, Shard

    from mmrp_tpu_torch.utils.convert import flax_paths

    rules = DEFAULT_TP_RULES if rules is None else rules
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    sizes = mesh_shape(mesh)
    paths = flax_paths(model) if model is not None else {}

    def spec_ok(spec: Spec, shape) -> bool:
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            names = (ax,) if isinstance(ax, str) else tuple(ax)
            size = int(np.prod([sizes.get(a, 0) for a in names]))
            if size == 0 or dim >= len(shape) or shape[dim] % size != 0:
                return False
        return True

    out = {}
    for name, t in params.items():
        path, transposed = paths.get(name, (name, False))
        chosen: Spec = ()
        for pat, spec in compiled:
            port = _flax_spec_to_port(spec, transposed)
            if pat.match(path) and spec_ok(port, tuple(t.shape)):
                chosen = port
                break
        placements = [Replicate() for _ in sizes]
        for dim, ax in enumerate(chosen):
            for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
                placements[list(sizes).index(a)] = Shard(dim)
        out[name] = tuple(placements)
    return out


def is_sharded(placements) -> bool:
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) for p in placements)


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``placements`` (a copy)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.mesh.shape[i]
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, coord[i] * size, size)
    return t.contiguous().clone()


def place(t: torch.Tensor, mesh, placements):
    """The whole tensor ``t`` (the same on every rank) as a ``DTensor`` of
    ``placements`` holding this rank's block: no communication. A replicated
    placement leaves ``t`` as it is (the tensor itself, which may be shared
    with a model parameter)."""
    from torch.distributed.tensor import DTensor

    if not is_sharded(placements):
        return t
    return DTensor.from_local(local_block(t, mesh, placements), mesh, placements,
                              run_check=False)


def shard_params(params: Dict[str, torch.Tensor], mesh, model=None, rules=None):
    """Place ``params`` on the mesh (``param_shardings``): the rule-matched
    ones as ``DTensor`` blocks, the others as they are."""
    specs = param_shardings(params, mesh, model, rules)
    return {k: place(v, mesh, specs[k]) for k, v in params.items()}


def local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s block on this rank (sharing its storage), any other
    tensor itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def whole(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gathered whole on every rank (a collective: every rank
    calls it), any other tensor itself."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.full_tensor()
    return t


def shard_state(state, mesh, model, rules=None):
    """Place a train state on the mesh in place (JAX rebuilds ``opt_state``
    from the sharded params): the f32 masters by ``param_shardings``, Adam's
    ``mu`` and ``nu`` with the placement of their master. Returns ``state``."""
    specs = param_shardings(state.params, mesh, model, rules)
    for tree in (state.params, state.mu, state.nu):
        for k in list(tree):
            tree[k] = place(tree[k], mesh, specs[k])
    return state


@contextlib.contextmanager
def tensor_parallel(model, placed: Dict[str, torch.Tensor], mesh, axis: str = "tp"):
    """Within the context, every ``nn.Linear`` of ``model`` whose weight
    ``placed`` (``shard_params``) shards over ``axis`` computes on this
    rank's block of it where the model calls the module (a kernel call site
    reads the module's whole weight instead):

    - ``Shard(0)``, out features (Flax ``P(None, "tp")``), column-parallel:
      ``x @ W_blk.T + b_blk``, this rank's block of the output features;
    - ``Shard(1)``, in features (``P("tp", None)``), row-parallel: the
      input's block of features (cut here when the input is whole) times
      ``W_blk.T``, the ranks' partial products summed by one all-reduce (in
      f32), then the bias.

    A column-parallel output must reach its row-parallel layer through
    elementwise ops only, as in the FFNs and the classifier head that the
    rules name. Yields {"column": n, "row": n}, the sharded GEMMs run."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Shard

    group, r = axis_group(mesh, axis), axis_index(mesh, axis)
    dim = list(mesh_shape(mesh)).index(axis)
    calls = {"column": 0, "row": 0}

    def column(mod, w):
        n = w.shape[0]
        b = None if mod.bias is None else mod.bias[r * n:(r + 1) * n]

        def forward(x):
            calls["column"] += 1
            return F.linear(x, w, b)
        return forward

    def row(mod, w):
        n = w.shape[1]

        def forward(x):
            calls["row"] += 1
            if x.shape[-1] == mod.in_features != n:
                x = x[..., r * n:(r + 1) * n]
            y = F.linear(x, w).float()
            dist.all_reduce(y, group=group)
            y = y.to(w.dtype)
            return y if mod.bias is None else y + mod.bias
        return forward

    patched = []
    for name, mod in model.named_modules():
        t = placed.get(f"{name}.weight")
        if not isinstance(mod, torch.nn.Linear) or t is None or not hasattr(t, "placements"):
            continue
        p = t.placements[dim]
        if isinstance(p, Shard):
            mod.forward = (column if p.dim == 0 else row)(mod, local(t))
            patched.append(mod)
    try:
        yield calls
    finally:
        for mod in patched:
            del mod.forward
