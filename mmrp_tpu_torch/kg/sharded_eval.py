"""Entity-sharded KG link-prediction evaluation over a device mesh.

Counterpart of ``mmrp_tpu/kg/sharded_eval.py``. The single-device eval
(``kg/trainer.py::KGTrainer.evaluate``) scores each chunk of triples against
the whole entity table; here the ENTITY TABLE is sharded by rows over a mesh
axis and the queries are replicated. Each rank scores the chunk against its
block (``kg/models.py::score_rows``, the expressions of
``make_score_all_fn``) and two all-reduce sums over the axis finish the
ranks:

- the target's score (the one rank whose block holds the target contributes
  it, every other rank 0);
- the count of candidates strictly above it, less the known positives
  (filtered ranking) above it: a deduplicated (row, col) pair list, padded to
  a power-of-two capacity with col = -1, each rank subtracting the pairs
  whose column lies in its block. Padding rows of the table (past
  ``n_real``) never count.

rank = 1 + count, the single-device semantics (optimistic rank among ties,
the target's score taken before any mask), so MRR and Hits equal
``KGTrainer.evaluate``'s rank for rank. Every rank of the mesh calls
``evaluate_sharded`` with the same trainer and triples.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mmrp_tpu_torch.kg.models import KGModelConfig, make_tables_fn, score_rows

def make_sharded_rank_fn(cfg: KGModelConfig, mesh, axis: str = "dp",
                         n_real: Optional[int] = None, map_batch: int = 64,
                         tails: bool = True) -> Callable:
    """fn(anchor_emb (B, De), rel_row (B, Dr), w_row (B, Dw), tgt (B,),
    pair_rows (K,), pair_cols (K,): the same on every rank; ent_shard
    (E_pad / n, De): this rank's block) -> ranks (B,) int64, the same on
    every rank. The relation fold happens inside, as in ``make_score_all_fn``;
    ``w_row`` is TransH's hyperplane row (ignored by the others). Rows are
    scored ``map_batch`` at a time."""
    from mmrp_tpu_torch.parallel.mesh import axis_group, axis_index

    group = axis_group(mesh, axis)
    shard_id = axis_index(mesh, axis)

    @torch.no_grad()
    def rank_fn(anchor_emb, rel_row, w_row, tgt, pair_rows, pair_cols, ent_shard):
        rows = ent_shard.shape[0]
        B = anchor_emb.shape[0]
        dev = ent_shard.device
        w = w_row if cfg.name == "TransH" else None
        scores = torch.cat([
            score_rows(cfg, tails, anchor_emb[i:i + map_batch], rel_row[i:i + map_batch],
                       None if w is None else w[i:i + map_batch], ent_shard)
            for i in range(0, B, map_batch)])  # (B, rows)
        ar = torch.arange(B, device=dev)

        # the target's score: from the one rank whose block holds it
        tloc = tgt - shard_id * rows
        in_range = (tloc >= 0) & (tloc < rows)
        ts = torch.where(in_range, scores[ar, tloc.clamp(0, rows - 1)],
                         torch.zeros((), dtype=scores.dtype, device=dev))
        dist.all_reduce(ts, group=group)

        grow = shard_id * rows + torch.arange(rows, device=dev)
        above = scores > ts[:, None]
        if n_real is not None:
            above &= grow[None, :] < n_real
        cnt = above.sum(1)

        # filtered ranking: the known positives in this block scoring above
        ploc = pair_cols - shard_id * rows
        p_in = (pair_cols >= 0) & (ploc >= 0) & (ploc < rows)
        pr = pair_rows.clamp(0, B - 1)
        psc = scores[pr, ploc.clamp(0, rows - 1)]
        hit_p = (p_in & (psc > ts[pr])).long()
        sub = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(0, pr, hit_p)
        count = cnt - sub
        dist.all_reduce(count, group=group)
        return 1 + count

    return rank_fn


def _pad_pairs(rows_idx: np.ndarray, cols_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate the filter pairs (a duplicated triple would be subtracted
    twice) and pad them to a power-of-two capacity, at least 256, with
    col = -1."""
    if len(rows_idx):
        key = rows_idx.astype(np.int64) * (1 << 32) + cols_idx.astype(np.int64)
        _, keep = np.unique(key, return_index=True)
        rows_idx, cols_idx = rows_idx[keep], cols_idx[keep]
    cap = max(256, 1 << int(max(len(rows_idx), 1) - 1).bit_length())
    pr = np.zeros(cap, dtype=np.int32)
    pc = np.full(cap, -1, dtype=np.int32)
    pr[: len(rows_idx)] = rows_idx
    pc[: len(cols_idx)] = cols_idx
    return pr, pc


@torch.no_grad()
def evaluate_sharded(trainer, triples: np.ndarray, mesh, axis: str = "dp",
                     ks: Tuple[int, ...] = (1, 5, 10)) -> Dict[str, float]:
    """Filtered MRR / Hits@K with the entity table sharded over ``mesh``'s
    ``axis``: ``KGTrainer.evaluate``'s protocol and numbers. ``trainer`` is a
    fitted ``KGTrainer`` whose parameters lie on the rank's device."""
    from mmrp_tpu_torch.parallel.mesh import axis_size, rows_of

    if triples is None or len(triples) == 0:
        return {"mrr": 0.0, **{f"hits@{k}": 0.0 for k in ks}}
    cfg = trainer.model_cfg
    params = trainer.params
    ent, rel = make_tables_fn(cfg)(params)  # one propagation (CompGCN) for every chunk
    ent, rel = ent.float(), rel.float()
    norm = params["norm"].float() if cfg.name == "TransH" else None
    dev = ent.device

    E = ent.shape[0]
    pad_rows = (-E) % axis_size(mesh, axis)
    ent_pad = torch.cat([ent, ent.new_zeros((pad_rows, ent.shape[1]))]) if pad_rows else ent
    ent_shard = rows_of(ent_pad, mesh, axis).contiguous()

    chunk = min(trainer.cfg.eval_chunk, len(triples))
    ranks: list = []
    for tails in (True, False):
        rank_fn = make_sharded_rank_fn(cfg, mesh, axis=axis, n_real=E, tails=tails)
        csr = trainer._known["sr" if tails else "or"]
        for start in range(0, len(triples), chunk):
            part = triples[start: start + chunk]
            b_real = len(part)
            if b_real < chunk:  # the chunk's shape, the last triple repeated
                part = np.concatenate([part, np.repeat(part[-1:], chunk - b_real, axis=0)])
            s, r, o = part[:, 0], part[:, 1], part[:, 2]
            anchor = torch.from_numpy((s if tails else o).astype(np.int64)).to(dev)
            target = torch.from_numpy((o if tails else s).astype(np.int64)).to(dev)
            rt = torch.from_numpy(r.astype(np.int64)).to(dev)
            w_row = norm[rt] if norm is not None else ent.new_zeros((chunk, 1))
            rows_idx, cols_idx = trainer._filter_rows_cols(csr, s if tails else o, r,
                                                           trainer.num_relations)
            pr, pc = _pad_pairs(np.asarray(rows_idx), np.asarray(cols_idx))
            out = rank_fn(ent[anchor], rel[rt], w_row, target,
                          torch.from_numpy(pr.astype(np.int64)).to(dev),
                          torch.from_numpy(pc.astype(np.int64)).to(dev), ent_shard)
            ranks.extend(out[:b_real].cpu().tolist())
    ranks_arr = np.asarray(ranks, dtype=np.float64)
    out = {"mrr": float(np.mean(1.0 / ranks_arr))}
    for k in ks:
        out[f"hits@{k}"] = float(np.mean(ranks_arr <= k))
    return out
