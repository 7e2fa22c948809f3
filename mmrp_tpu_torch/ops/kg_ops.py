"""Compute primitives for KG embedding models.

Counterpart of ``mmrp_tpu/ops/kg_ops.py``, in PyTorch on the tensors' device:

- :func:`ccorr`: circular correlation through ``torch.fft``,
  ``irfft(conj(rfft(a)) * rfft(b))`` (the CompGCN-paper orientation, as JAX's);
- :func:`compose`: CompGCN's composition ops (corr / sub / mult);
- :func:`compute_norm`, :func:`degree_norm` and
  :func:`segment_mean_messages`: degree-normalised scatter-add message
  passing, ``jax.ops.segment_sum`` as ``Tensor.index_add_`` into a fixed
  number of segments.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: row i of ``data`` added into row
    ``segment_ids[i]`` of a zero (num_segments, ...) tensor (ids out of range
    are an error here, where JAX drops them)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def ccorr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular correlation via rFFT: ccorr(a, b)[i] = sum_k a[k] b[k + i]."""
    d = a.shape[-1]
    fa = torch.fft.rfft(a.float(), dim=-1)
    fb = torch.fft.rfft(b.float(), dim=-1)
    return torch.fft.irfft(torch.conj(fa) * fb, n=d, dim=-1).to(a.dtype)


def compose(ent: torch.Tensor, rel: torch.Tensor, opn: str) -> torch.Tensor:
    """CompGCN composition of entity and relation embeddings."""
    if opn == "corr":
        return ccorr(ent, rel)
    if opn == "sub":
        return ent - rel
    if opn == "mult":
        return ent * rel
    raise ValueError(f"unknown composition op {opn!r}")


def compute_norm(row: torch.Tensor, col: torch.Tensor, num_nodes: int,
                 dtype=torch.float32) -> torch.Tensor:
    """CompGCN edge normalisation: deg by a scatter-add of ones over ``row``,
    then per edge deg^-1/2[row] * deg^-1/2[col] (0 for isolated nodes)."""
    deg = segment_sum(torch.ones(row.shape, dtype=dtype, device=row.device), row, num_nodes)
    deg_inv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                          torch.zeros_like(deg))
    return deg_inv[row.long()] * deg_inv[col.long()]


def degree_norm(edge_dst: torch.Tensor, num_nodes: int, dtype=torch.float32) -> torch.Tensor:
    """Per-edge 1 / in_degree(dst)."""
    deg = segment_sum(torch.ones(edge_dst.shape, dtype=dtype, device=edge_dst.device),
                      edge_dst, num_nodes)
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), torch.zeros_like(deg))
    return inv[edge_dst.long()]


def segment_mean_messages(messages: torch.Tensor, edge_dst: torch.Tensor,
                          num_nodes: int) -> torch.Tensor:
    """Degree-normalised aggregation of edge messages (E, D) into node slots."""
    norm = degree_norm(edge_dst, num_nodes, messages.dtype)
    return segment_sum(messages * norm[:, None], edge_dst, num_nodes)
