"""Knowledge-graph embedding models: TransE / TransH / RotatE / CompGCN.

Counterpart of ``mmrp_tpu/kg/models.py``, functional as JAX's: a model is
``(init_params, score)`` over a dict of f32 tensors (``ent``, ``rel``, and
TransH's ``norm`` or CompGCN's per-layer weights, under JAX's names), where
``score(params, s, r, o)`` maps index tensors to plausibility scores (higher
is more plausible: negative distances for TransE / TransH / RotatE).

- :func:`make_score_all_fn` scores (anchor, r) against every entity, in row
  groups so that no (B, E, D) tensor is built (TransE / CompGCN through
  ``torch.cdist`` at p = 1);
- CompGCN propagates the tables through its conv stack with
  ``ops/kg_ops.py`` (``torch.fft`` correlation, ``index_add_`` segment sums),
  then scores TransE-style. Its dropout masks are drawn from a
  ``torch.Generator`` (two per layer, in layer order), or passed in as
  ``drop_masks``.

:func:`init_params` draws JAX's distributions (glorot-uniform tables and
weights, RotatE's uniform ranges) from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrp_tpu_torch.ops.kg_ops import compose, compute_norm, segment_sum

Params = Dict[str, torch.Tensor]
# rows of a score-all group: (rows, E, D) elements at most per pass
_ROW_GROUP = 16


@dataclass(frozen=True)
class KGModelConfig:
    name: str  # TransE | TransH | RotatE | CompGCN
    num_entities: int
    num_relations: int
    emb_dim: int = 300
    p_norm: int = 1  # TransE/H distance norm
    gamma: float = 12.0  # RotatE margin for embedding range init
    # CompGCN
    num_layers: int = 2
    dropout: float = 0.3
    opn: str = "corr"
    # edges for CompGCN propagation (static arrays, set by the trainer)
    edge_src: Optional[np.ndarray] = None
    edge_dst: Optional[np.ndarray] = None
    edge_rel: Optional[np.ndarray] = None


def _glorot(shape, gen, device) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * limit


def init_params(cfg: KGModelConfig, generator: torch.Generator) -> Params:
    """The model's parameters in JAX's distributions, drawn from
    ``generator`` on its device."""
    dev = generator.device
    E, R, D = cfg.num_entities, cfg.num_relations, cfg.emb_dim
    if cfg.name == "RotatE":
        rng_range = cfg.gamma / D
        params = {"ent": (torch.rand((E, 2 * D), generator=generator, device=dev) * 2 - 1)
                  * rng_range,
                  "rel": (torch.rand((R, D), generator=generator, device=dev) * 2 - 1) * math.pi}
    elif cfg.name == "TransH":
        params = {"ent": _glorot((E, D), generator, dev), "rel": _glorot((R, D), generator, dev),
                  "norm": _glorot((R, D), generator, dev)}
    elif cfg.name == "CompGCN":
        params = {"ent": _glorot((E, D), generator, dev), "rel": _glorot((R, D), generator, dev)}
        for layer in range(cfg.num_layers):
            for w in ("w_in", "w_out", "w_loop", "w_rel"):
                params[f"{w}_{layer}"] = _glorot((D, D), generator, dev)
            params[f"loop_rel_{layer}"] = _glorot((1, D), generator, dev)
            params[f"bias_{layer}"] = torch.zeros(D, device=dev)
            params[f"bn_scale_{layer}"] = torch.ones(D, device=dev)
            params[f"bn_bias_{layer}"] = torch.zeros(D, device=dev)
    elif cfg.name == "TransE":
        params = {"ent": _glorot((E, D), generator, dev), "rel": _glorot((R, D), generator, dev)}
    else:
        raise ValueError(cfg.name)
    return {k: v.float() for k, v in params.items()}


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


def _transe_score(s_e, r_e, o_e, p_norm):
    diff = s_e + r_e - o_e
    if p_norm == 1:
        d = diff.abs().sum(-1)
    else:
        d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
    return -d


def _transh_project(e, w):
    w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-8)
    return e - (e * w).sum(-1, keepdim=True) * w


def _rotate_score(s_e, r_phase, o_e, gamma):
    D = r_phase.shape[-1]
    s_re, s_im = s_e[..., :D], s_e[..., D:]
    o_re, o_im = o_e[..., :D], o_e[..., D:]
    r_re, r_im = torch.cos(r_phase), torch.sin(r_phase)
    rot_re = s_re * r_re - s_im * r_im
    rot_im = s_re * r_im + s_im * r_re
    d = torch.sqrt((rot_re - o_re) ** 2 + (rot_im - o_im) ** 2 + 1e-12).sum(-1)
    return gamma - d


def draw_drop_masks(cfg: KGModelConfig, generator: torch.Generator) -> List[torch.Tensor]:
    """CompGCN's dropout keep masks for one propagation: (E, D) bool, the
    in- and out-aggregations of each layer in turn."""
    keep = 1.0 - cfg.dropout
    return [torch.rand((cfg.num_entities, cfg.emb_dim), generator=generator,
                       device=generator.device) < keep for _ in range(2 * cfg.num_layers)]


def compgcn_propagate(cfg: KGModelConfig, params: Params,
                      generator: Optional[torch.Generator] = None, training: bool = False,
                      drop_masks: Optional[Sequence[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CompGCN conv stack -> (entity table, relation table), JAX's
    ``compgcn_propagate``: per layer

        in  = segment_sum(norm_in  * compose(x[src], rel[er]) @ W_in,  dst)
        out = segment_sum(norm_out * compose(x[dst], rel[er]) @ W_out, src)
        x'  = relu(BN(drop(in) / 3 + drop(out) / 3 + compose(x, loop_rel) @ W_loop / 3 + bias))
        rel' = (concat(rel, loop_rel) @ W_rel)[:-1]

    BatchNorm on the batch statistics of the whole entity table. Dropout acts
    in training (``training`` and a rate > 0) with ``drop_masks`` or masks
    drawn from ``generator``."""
    ent, rel = params["ent"], params["rel"]
    dev = ent.device
    src = torch.as_tensor(cfg.edge_src, device=dev).long()
    dst = torch.as_tensor(cfg.edge_dst, device=dev).long()
    erel = torch.as_tensor(cfg.edge_rel, device=dev).long()
    E = cfg.num_entities
    use_dropout = training and cfg.dropout > 0.0 and (generator is not None
                                                      or drop_masks is not None)
    if use_dropout and drop_masks is None:
        drop_masks = draw_drop_masks(cfg, generator)
    keep = 1.0 - cfg.dropout

    def drop(x, mask):
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=dev))

    norm_in = compute_norm(src, dst, E)
    norm_out = compute_norm(dst, src, E)
    for layer in range(cfg.num_layers):
        loop_rel = params[f"loop_rel_{layer}"]
        msg_in = compose(ent[src], rel[erel], cfg.opn) @ params[f"w_in_{layer}"]
        agg_in = segment_sum(msg_in * norm_in[:, None].to(msg_in.dtype), dst, E)
        msg_out = compose(ent[dst], rel[erel], cfg.opn) @ params[f"w_out_{layer}"]
        agg_out = segment_sum(msg_out * norm_out[:, None].to(msg_out.dtype), src, E)
        loop = compose(ent, loop_rel.expand(ent.shape), cfg.opn) @ params[f"w_loop_{layer}"]
        if use_dropout:
            agg_in = drop(agg_in, drop_masks[2 * layer])
            agg_out = drop(agg_out, drop_masks[2 * layer + 1])
        out = (agg_in + agg_out + loop) / 3.0 + params[f"bias_{layer}"]
        mu = out.mean(0, keepdim=True)
        var = ((out - mu) ** 2).mean(0, keepdim=True)
        out = (out - mu) * torch.rsqrt(var + 1e-5)
        out = out * params[f"bn_scale_{layer}"] + params[f"bn_bias_{layer}"]
        ent = torch.relu(out)
        rel = (torch.cat([rel, loop_rel], dim=0) @ params[f"w_rel_{layer}"])[:-1]
    return ent, rel


def make_tables_fn(cfg: KGModelConfig) -> Callable:
    """tables(params, generator=None, training=False, drop_masks=None) ->
    (ent_table, rel_table); CompGCN runs its conv stack once."""

    def tables(params, generator=None, training=False, drop_masks=None):
        if cfg.name == "CompGCN":
            return compgcn_propagate(cfg, params, generator, training, drop_masks)
        return params["ent"], params["rel"]

    return tables


def score_from_tables(cfg: KGModelConfig, params, ent, rel, s, r, o) -> torch.Tensor:
    """Score triples given precomputed tables; higher = more plausible."""
    if cfg.name in ("TransE", "CompGCN"):
        return _transe_score(ent[s], rel[r], ent[o], cfg.p_norm)
    if cfg.name == "TransH":
        w = params["norm"][r]
        return _transe_score(_transh_project(ent[s], w), rel[r], _transh_project(ent[o], w),
                             cfg.p_norm)
    if cfg.name == "RotatE":
        return _rotate_score(ent[s], rel[r], ent[o], cfg.gamma)
    raise ValueError(cfg.name)


def make_score_fn(cfg: KGModelConfig) -> Callable:
    """score(params, s, r, o, generator=None, training=False) -> scores."""
    tables = make_tables_fn(cfg)

    def score(params, s, r, o, generator=None, training=False):
        ent, rel = tables(params, generator, training)
        return score_from_tables(cfg, params, ent, rel, s, r, o)

    return score


def _dist(diff: torch.Tensor, p_norm: int) -> torch.Tensor:
    if p_norm == 1:
        return -diff.abs().sum(-1)
    return -torch.sqrt((diff * diff).sum(-1) + 1e-12)


def score_rows(cfg: KGModelConfig, tails: bool, anchor_emb: torch.Tensor,
               rel_row: torch.Tensor, w_row: Optional[torch.Tensor],
               ent: torch.Tensor) -> torch.Tensor:
    """(B, E') scores of B queries against the candidate rows ``ent`` (the
    whole entity table, or one rank's block of it in ``kg/sharded_eval.py``):
    the anchor's embedding (the head for tail replacement, the tail for head
    replacement), the relation's row and TransH's unnormalized hyperplane row
    (``w_row``, else None). Only per-candidate operations touch ``ent``, so a
    block of rows scores as those rows of the whole table do."""
    if cfg.name in ("TransE", "CompGCN"):
        # tails: ||(s + r) - o'||  ==  heads: ||(o - r) - s'||
        query = anchor_emb + rel_row if tails else anchor_emb - rel_row
        if cfg.p_norm == 1:
            return -torch.cdist(query[None], ent[None], p=1)[0]
        return torch.cat([_dist(query[i:i + _ROW_GROUP, None, :] - ent[None], cfg.p_norm)
                          for i in range(0, len(query), _ROW_GROUP)])
    if cfg.name == "TransH":
        w = w_row / torch.clamp(torch.linalg.vector_norm(w_row, dim=-1, keepdim=True), min=1e-8)
        qe, qr = anchor_emb, rel_row
        out = []
        for i in range(0, len(qe), _ROW_GROUP):
            qw, e, rr = w[i:i + _ROW_GROUP], qe[i:i + _ROW_GROUP], qr[i:i + _ROW_GROUP]
            ent_p = ent[None] - (ent @ qw.T).T[:, :, None] * qw[:, None, :]  # (b, E, D)
            q_p = e - (e * qw).sum(-1, keepdim=True) * qw
            diff = ((q_p + rr)[:, None, :] - ent_p if tails else
                    ent_p + rr[:, None, :] - q_p[:, None, :])
            out.append(_dist(diff, cfg.p_norm))
        return torch.cat(out)
    if cfg.name == "RotatE":
        D = cfg.emb_dim
        re_all, im_all = ent[:, :D], ent[:, D:]
        ae, ph = anchor_emb, rel_row
        a_re, a_im = ae[:, :D], ae[:, D:]
        r_re, r_im = torch.cos(ph), torch.sin(ph)
        if tails:
            rot_re, rot_im = a_re * r_re - a_im * r_im, a_re * r_im + a_im * r_re
        else:  # inverse rotation applied to the (tail) anchor
            rot_re, rot_im = a_re * r_re + a_im * r_im, a_im * r_re - a_re * r_im
        out = []
        for i in range(0, len(ae), _ROW_GROUP):
            sl = slice(i, i + _ROW_GROUP)
            d = torch.sqrt((rot_re[sl, None, :] - re_all[None]) ** 2
                           + (rot_im[sl, None, :] - im_all[None]) ** 2 + 1e-12).sum(-1)
            out.append(cfg.gamma - d)
        return torch.cat(out)
    raise ValueError(cfg.name)


def make_score_all_fn(cfg: KGModelConfig, tails: bool = True) -> Callable:
    """score_all(params, anchor, r) -> (B, num_entities) scores against every
    entity as the tail (``tails``) or as the head. ``anchor`` is the head for
    tail replacement, the tail for head replacement."""

    def score_all(params, anchor, r):
        if cfg.name == "CompGCN":
            ent, rel = compgcn_propagate(cfg, params)
        else:
            ent, rel = params["ent"], params["rel"]
        if cfg.name not in ("TransE", "CompGCN", "TransH", "RotatE"):
            raise ValueError(cfg.name)
        w_row = params["norm"][r] if cfg.name == "TransH" else None
        return score_rows(cfg, tails, ent[anchor], rel[r], w_row, ent)

    return score_all


def final_entity_table(cfg: KGModelConfig, params) -> np.ndarray:
    """Entity table to persist: CompGCN saves the propagated embeddings,
    RotatE the complex (2D) ones."""
    with torch.no_grad():
        if cfg.name == "CompGCN":
            ent, _ = compgcn_propagate(cfg, params)
            return ent.float().cpu().numpy()
        return params["ent"].float().cpu().numpy()
