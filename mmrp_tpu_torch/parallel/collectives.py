"""Collectives for metrics, and the start of the process group.

Counterpart of ``mmrp_tpu/parallel/collectives.py``: ``make_metric_psum``
sums each rank's metric numerator and denominator over a mesh axis (JAX's
``psum`` in a ``shard_map``), ``mean_over_mesh`` is the global mean of
per-sample values whose rows are sharded over that axis (padding rows count
zero), and ``initialize_distributed`` starts ``torch.distributed`` from
explicit arguments or from JAX's three variables.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mmrp_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, mesh_device

# how long a rank waits for the others (rendezvous and every collective)
# before the run fails instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def make_metric_psum(mesh, axis: str = "dp") -> Callable:
    """fn(values_shard, counts_shard) -> (global sum, global count), f32
    scalars: each rank sums its block, one all-reduce adds the ranks'."""
    group = axis_group(mesh, axis)

    def reduce_fn(v: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sums = torch.stack([v.float().sum(), c.float().sum()])
        dist.all_reduce(sums, group=group)
        return sums[0], sums[1]

    return reduce_fn


def mean_over_mesh(mesh, values: np.ndarray, axis: str = "dp") -> float:
    """Global mean of per-sample ``values`` (the same array on every rank),
    rows sharded over ``axis``: padded with zero-count rows to a multiple of
    the mesh's size, as JAX pads them."""
    values = np.asarray(values, np.float32)
    n = values.shape[0]
    n_dev = int(np.prod(mesh.mesh.shape))
    pad = (-n) % n_dev
    if pad:
        values = np.concatenate([values, np.zeros(pad, values.dtype)])
    counts = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    rows = values.shape[0] // axis_size(mesh, axis)
    r = axis_index(mesh, axis)
    dev = mesh_device(mesh)
    block = slice(r * rows, (r + 1) * rows)
    s, c = make_metric_psum(mesh, axis)(torch.from_numpy(values[block] * counts[block]).to(dev),
                                        torch.from_numpy(counts[block]).to(dev))
    return float(s) / max(float(c), 1.0)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           cpu_collectives: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group; True when it was started.

    Explicit arguments win, else ``JAX_COORDINATOR_ADDRESS`` (``host:port``
    of rank 0's rendezvous), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``;
    without a coordinator nothing starts and it returns False. The backend is
    NCCL, each rank on ``cuda:<rank % cards on this host>``, and raises
    without a card; ``cpu_collectives="gloo"`` runs the ranks on the CPU over
    gloo. ``timeout_s`` bounds the rendezvous and every collective, so that a
    lost rank fails the run instead of hanging it."""
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    if cpu_collectives not in (None, "gloo"):
        raise ValueError(f"cpu_collectives {cpu_collectives!r}: the CPU collectives are gloo's")
    if num_processes is None:
        num_processes = os.environ.get("JAX_NUM_PROCESSES", 1)
    if process_id is None:
        process_id = os.environ.get("JAX_PROCESS_ID", 0)
    world, rank = int(num_processes), int(process_id)
    backend = "gloo" if cpu_collectives else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: NCCL needs a CUDA device and "
                               "torch.cuda.is_available() is false; pass "
                               "cpu_collectives='gloo' to run the ranks on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def all_reduce_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor averaged over the ranks of ``group``, in f32 (JAX's
    ``psum`` of f32 gradients, over n): the tensors of each dtype
    concatenated, cast to f32 once, all-reduced and divided in place; the
    results are f32 views of that buffer, in order. A handful of launches
    whatever the number of tensors: the step's host time, not its bytes,
    bounds a flagship train step."""
    n = dist.get_world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]).float()
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated in rank order along
    ``dim`` (one ``all_gather_into_tensor``, which NCCL and gloo both have)."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    with warnings.catch_warnings():  # newer torch names it all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    if dim == 0:
        return out
    out = out.view((n,) + tuple(t.shape)).movedim(0, dim)
    return out.reshape(t.shape[:dim] + (n * t.shape[dim],) + t.shape[dim + 1:])


class _AllGatherRows(torch.autograd.Function):
    """Rows of every rank of ``group``, in rank order. The backward is the
    transpose JAX's ``all_gather`` has: the cotangents of every rank summed,
    this rank's rows kept (a reduce-scatter, as an all-reduce and a slice,
    which every backend has)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(rows, ...) on each rank -> (ranks * rows, ...) on every rank, with
    autograd (``_AllGatherRows``)."""
    return _AllGatherRows.apply(x, group)
