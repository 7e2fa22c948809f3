"""KG embedding trainer: self-adversarial negative sampling on the card.

Counterpart of ``mmrp_tpu/kg/trainer.py`` (``scale_confidences``,
``KGTrainerConfig``, ``KGTrainer``):

- triple loading with source-reliability scaling and 1/log1p(freq)
  down-weighting, and the seeded 90/10 train/val split (numpy, as JAX's);
- one train step: per positive, ``neg_size`` random corruptions of the head
  or the tail, softmax(neg_score / adv_temp) weights held constant,
  logsigmoid loss scaled by confidence, CompGCN dropout; ``optax.adam`` as
  :class:`train.state.Adam`; with ``use_bf16`` the scores are computed from
  bf16 casts of the f32 parameters (the reference's CUDA AMP);
- per-epoch L2 renormalisation of the entity table (not RotatE's), early
  stopping on validation MRR;
- filtered MRR / Hits@K over heads and tails: each ``eval_chunk`` of
  triples scored against every entity on the device, the known positives
  (a CSR keyed by anchor * R + rel, numpy) masked to -inf there, and
  rank = 1 + #entities scoring above the target;
- ``save``, ``ensure_label_embeddings`` and ``load_embeddings`` (numpy).

Random draws come from ``torch.Generator``s seeded from ``cfg.seed`` on the
trainer's device: the parameters' init, and per step the negatives, the
corrupted side and CompGCN's dropout masks (:meth:`KGTrainer.draw`, which a
test replaces to pass JAX's draws in). The data order and the split use
numpy's seeded generators, as JAX's do.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.kg.models import (
    KGModelConfig,
    draw_drop_masks,
    final_entity_table,
    init_params,
    make_score_all_fn,
    make_tables_fn,
    score_from_tables,
)
from mmrp_tpu_torch.train.state import Adam

SOURCE_FACTORS = {"curated": 3.0, "extracted": 0.7}


def scale_confidences(
    triples: Sequence[Tuple[int, int, int]],
    confidences: Sequence[float],
    sources: Sequence[str],
    curated_factor: float = 3.0,
) -> np.ndarray:
    """Reference confidence scaling (KG_Trainer.py:216-230)."""
    counts: Dict[Tuple[int, int, int], int] = {}
    for t in triples:
        counts[t] = counts.get(t, 0) + 1
    out = np.empty(len(triples), dtype=np.float32)
    for i, (t, c, s) in enumerate(zip(triples, confidences, sources)):
        f = curated_factor if s == "curated" else SOURCE_FACTORS.get(s, 1.0)
        out[i] = c * f / math.log1p(counts[t])
    return out


@dataclass
class KGTrainerConfig:
    model: str = "TransE"
    emb_dim: int = 300
    epochs: int = 30
    batch_size: int = 1024
    lr: float = 1e-3
    neg_size: int = 32
    adv_temp: float = 0.1
    patience: int = 5
    seed: int = 2709
    val_frac: float = 0.1
    # CompGCN
    num_layers: int = 2
    dropout: float = 0.3
    opn: str = "corr"
    eval_chunk: int = 256  # triples scored against all entities per device pass
    use_bf16: bool = False  # bf16 scoring in training (the reference's CUDA AMP);
    #                         params, optimizer and evaluation stay f32


class KGTrainer:
    def __init__(self, num_entities: int, num_relations: int,
                 cfg: Optional[KGTrainerConfig] = None, device=DEFAULT_DEVICE):
        self.cfg = cfg or KGTrainerConfig()
        self.device = resolve_device(device, "KGTrainer")
        self.num_entities = num_entities
        self.num_relations = num_relations
        self.model_cfg: Optional[KGModelConfig] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.train_arr: Optional[np.ndarray] = None
        self.val_arr: Optional[np.ndarray] = None
        self.train_conf: Optional[np.ndarray] = None
        self._known: Optional[Dict] = None
        # the mean loss of every step of the last epoch trained (host floats)
        self.step_losses: List[float] = []

    # -- data ------------------------------------------------------------------

    def load_triples(self, triples: Sequence[Tuple[int, int, int]],
                     confidences: Optional[Sequence[float]] = None,
                     sources: Optional[Sequence[str]] = None) -> None:
        n = len(triples)
        confidences = list(confidences) if confidences is not None else [1.0] * n
        sources = list(sources) if sources is not None else ["extracted"] * n
        conf = scale_confidences([tuple(t) for t in triples], confidences, sources)

        rng = np.random.default_rng(self.cfg.seed)
        order = rng.permutation(n)
        arr = np.asarray(triples, dtype=np.int32)[order]
        conf = conf[order]
        split = int((1.0 - self.cfg.val_frac) * n)
        self.train_arr, self.val_arr = arr[:split], arr[split:]
        self.train_conf = conf[:split]

        cg_kwargs = {}
        if self.cfg.model == "CompGCN":
            cg_kwargs = dict(num_layers=self.cfg.num_layers, dropout=self.cfg.dropout,
                             opn=self.cfg.opn, edge_src=self.train_arr[:, 0].copy(),
                             edge_dst=self.train_arr[:, 2].copy(),
                             edge_rel=self.train_arr[:, 1].copy())
        self.model_cfg = KGModelConfig(name=self.cfg.model, num_entities=self.num_entities,
                                       num_relations=self.num_relations,
                                       emb_dim=self.cfg.emb_dim, **cg_kwargs)
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.params = init_params(self.model_cfg, gen)
        self._known = {
            "sr": self._build_filter_csr(arr[:, 0], arr[:, 1], arr[:, 2]),
            "or": self._build_filter_csr(arr[:, 2], arr[:, 1], arr[:, 0]),
        }

    def _build_filter_csr(
        self, anchors: np.ndarray, rels: np.ndarray, targets: np.ndarray
    ):
        """-> (unique_keys sorted, indptr, targets_sorted) with
        key = anchor * num_relations + rel."""
        keys = anchors.astype(np.int64) * self.num_relations + rels.astype(np.int64)
        order = np.argsort(keys, kind="stable")
        keys_sorted = keys[order]
        targets_sorted = targets.astype(np.int64)[order]
        unique_keys, counts = np.unique(keys_sorted, return_counts=True)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return unique_keys, indptr, targets_sorted

    @staticmethod
    def _filter_rows_cols(
        csr, anchors: np.ndarray, rels: np.ndarray, num_relations: int
    ):
        """Vectorized (row, col) pairs of known positives for a chunk."""
        unique_keys, indptr, targets_sorted = csr
        keys = anchors.astype(np.int64) * num_relations + rels.astype(np.int64)
        pos = np.searchsorted(unique_keys, keys)
        pos_c = np.minimum(pos, len(unique_keys) - 1)
        found = (len(unique_keys) > 0) & (unique_keys[pos_c] == keys)
        starts = indptr[pos_c]
        counts = np.where(found, indptr[pos_c + 1] - starts, 0)
        total = int(counts.sum())
        if total == 0:
            return (np.empty(0, np.int64),) * 2
        rows = np.repeat(np.arange(len(keys), dtype=np.int64), counts)
        # ragged range gather: offsets within each run, then absolute index
        run_ends = np.cumsum(counts)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            run_ends - counts, counts
        )
        cols = targets_sorted[np.repeat(starts, counts) + within]
        return rows, cols

    # -- training -----------------------------------------------------------------

    def draw(self, B: int, generator: torch.Generator):
        """One step's draws: negative entities (B, neg_size), which side each
        positive corrupts ((B, 1) bool, True = the head), and CompGCN's
        dropout masks in training (else None)."""
        dev = self.device
        neg_ent = torch.randint(0, self.num_entities, (B, self.cfg.neg_size),
                                generator=generator, device=dev)
        corrupt_head = torch.rand((B, 1), generator=generator, device=dev) < 0.5
        masks = None
        if self.cfg.model == "CompGCN" and self.cfg.dropout > 0:
            masks = draw_drop_masks(self.model_cfg, generator)
        return neg_ent, corrupt_head, masks

    def loss(self, params, batch: torch.Tensor, conf: torch.Tensor, draws):
        """The step's loss (f32 scalar) and metrics on ``draws``."""
        cfg = self.cfg
        if cfg.use_bf16:
            params = {k: v.to(torch.bfloat16) for k, v in params.items()}
        neg_ent, corrupt_head, masks = draws
        s, r, o = batch[:, 0], batch[:, 1], batch[:, 2]
        B = s.shape[0]
        neg_s = torch.where(corrupt_head, neg_ent, s[:, None])
        neg_o = torch.where(corrupt_head, o[:, None], neg_ent)
        # one propagation per step (CompGCN): positives and negatives score
        # from the same tables, with dropout in training
        ent_t, rel_t = make_tables_fn(self.model_cfg)(params, training=True, drop_masks=masks)
        pos_score = score_from_tables(self.model_cfg, params, ent_t, rel_t, s, r, o)
        neg_score = score_from_tables(self.model_cfg, params, ent_t, rel_t, neg_s.reshape(-1),
                                      torch.repeat_interleave(r, cfg.neg_size),
                                      neg_o.reshape(-1)).reshape(B, cfg.neg_size)
        # self-adversarial weights are constants
        w = torch.softmax(neg_score / cfg.adv_temp, dim=1).detach()
        pos_term = F.logsigmoid(pos_score)
        neg_term = (w * F.logsigmoid(-neg_score)).sum(1)
        per = (-(pos_term + neg_term) * conf).float()
        return per.mean(), {"pos_score": pos_score.detach().float().mean(),
                            "neg_score": neg_score.detach().float().mean()}

    def _make_train_step(self):
        tx = Adam(self.cfg.lr)

        def train_step(params, opt_state, batch, conf, draws):
            keys = list(params)
            leaves = [params[k].detach().requires_grad_(True) for k in keys]
            loss, metrics = self.loss(dict(zip(keys, leaves)), batch, conf, draws)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = {k: g if g is not None else torch.zeros_like(p)
                     for k, g, p in zip(keys, grads, leaves)}
            tx.step(params, grads, opt_state)
            metrics["loss"] = loss.detach()
            return params, opt_state, metrics

        return tx, train_step

    @torch.no_grad()
    def _renorm_entities(self) -> None:
        """Per-epoch L2 renorm; skipped for RotatE (its complex pairs keep
        their modulus structure)."""
        if self.cfg.model == "RotatE":
            return
        ent = self.params["ent"]
        norm = torch.clamp(torch.linalg.vector_norm(ent, dim=1, keepdim=True), min=1e-8)
        self.params = dict(self.params)
        self.params["ent"] = ent / norm

    def train(self, log_every: int = 0, metric_writer=None) -> Dict[str, float]:
        cfg = self.cfg
        tx, train_step = self._make_train_step()
        opt_state = tx.init(self.params)
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        n = self.train_arr.shape[0]
        B = min(cfg.batch_size, n)
        # ceil: the final partial step wraps around, so the n mod B remainder
        # trains every epoch
        steps_per_epoch = -(-n // B)
        train_arr = torch.from_numpy(self.train_arr.astype(np.int64)).to(self.device)
        train_conf = torch.from_numpy(self.train_conf).to(self.device)

        best = {"mrr": -1.0, "epoch": -1}
        best_params = {k: v.clone() for k, v in self.params.items()}
        bad_epochs = 0
        np_rng = np.random.default_rng(cfg.seed)
        for epoch in range(cfg.epochs):
            order = np_rng.permutation(n)
            step_losses = []  # device scalars; one sync at epoch end
            for step in range(steps_per_epoch):
                idx = order[step * B: (step + 1) * B]
                if len(idx) < B:
                    idx = np.concatenate([idx, order[: B - len(idx)]])
                it = torch.from_numpy(idx).to(self.device)
                draws = self.draw(B, generator)
                self.params, opt_state, metrics = train_step(
                    self.params, opt_state, train_arr[it], train_conf[it], draws)
                step_losses.append(metrics["loss"])
            self._renorm_entities()
            self.step_losses = torch.stack(step_losses).cpu().tolist()
            epoch_loss = float(np.mean(self.step_losses))
            val = self.evaluate(self.val_arr)
            if metric_writer is not None:
                metric_writer.log({"kg/loss": epoch_loss, **{f"kg/{k}": v for k, v in val.items()}},
                                  step=epoch)
            if log_every and epoch % log_every == 0:
                print(f"[KGTrainer] epoch {epoch} loss={epoch_loss:.4f} val={val}")
            if val["mrr"] > best["mrr"]:
                best = {**val, "epoch": epoch}
                best_params = {k: v.clone() for k, v in self.params.items()}
                bad_epochs = 0
            else:
                bad_epochs += 1
                if bad_epochs >= cfg.patience:
                    break
        self.params = best_params
        return best

    # -- evaluation -----------------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, triples: np.ndarray, ks: Tuple[int, ...] = (1, 5, 10)) -> Dict[str, float]:
        """Filtered MRR / Hits@K, head + tail replacement."""
        if triples is None or len(triples) == 0:
            return {"mrr": 0.0, **{f"hits@{k}": 0.0 for k in ks}}
        chunk = self.cfg.eval_chunk
        dev = self.device
        ranks: List[torch.Tensor] = []
        for tails in (True, False):
            fn = make_score_all_fn(self.model_cfg, tails=tails)
            for start in range(0, len(triples), chunk):
                part = triples[start: start + chunk]
                s, r, o = part[:, 0], part[:, 1], part[:, 2]
                anchor = s if tails else o
                target = o if tails else s
                scores = fn(self.params, torch.from_numpy(anchor.astype(np.int64)).to(dev),
                            torch.from_numpy(r.astype(np.int64)).to(dev))  # (b, E)
                b = len(part)
                tgt = torch.from_numpy(target.astype(np.int64)).to(dev)
                tscores = scores[torch.arange(b, device=dev), tgt].clone()
                rows, cols = self._filter_rows_cols(self._known["sr" if tails else "or"],
                                                    s if tails else o, r, self.num_relations)
                if len(rows):
                    scores[torch.from_numpy(rows).to(dev),
                           torch.from_numpy(cols).to(dev)] = -float("inf")
                ranks.append(1 + (scores > tscores[:, None]).sum(1))
        ranks_arr = torch.cat(ranks).cpu().numpy().astype(np.float64)
        out = {"mrr": float(np.mean(1.0 / ranks_arr))}
        for k in ks:
            out[f"hits@{k}"] = float(np.mean(ranks_arr <= k))
        return out

    # -- persistence ---------------------------------------------------------------

    def save(self, out_dir: str, node_names: Optional[Sequence[str]] = None) -> None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        ent = final_entity_table(self.model_cfg, self.params)
        np.save(out / "node_embeddings.npy", ent)
        np.save(out / "rel_embeddings.npy", self.params["rel"].float().cpu().numpy())
        meta = {
            "model": self.cfg.model,
            "emb_dim": self.cfg.emb_dim,
            "num_entities": self.num_entities,
            "num_relations": self.num_relations,
            "entity_table_dim": int(ent.shape[1]),
            "higher_better": True,
        }
        (out / "embeddings_meta.json").write_text(json.dumps(meta, indent=1))
        if node_names is not None:
            (out / "node2id.json").write_text(
                json.dumps({n: i for i, n in enumerate(node_names)}, indent=1))

    @staticmethod
    def ensure_label_embeddings(
        kg_dir: str,
        label_names: Sequence[str],
        out_path: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """label group -> embedding vector from the trained node table, with
        a zero-vector fallback for labels missing from the graph (reference
        kg_label_create.py:38-111; npz instead of .pt)."""
        kg = Path(kg_dir)
        emb = np.load(kg / "node_embeddings.npy")
        node2id = json.loads((kg / "node2id.json").read_text())
        out: Dict[str, np.ndarray] = {}
        missing = []
        for name in label_names:
            idx = node2id.get(f"label:{name}")
            if idx is None:
                missing.append(name)
                out[name] = np.zeros(emb.shape[1], np.float32)
            else:
                out[name] = np.asarray(emb[idx], np.float32)
        if missing:
            print(f"[KGTrainer] zero-filled {len(missing)} label embeddings: "
                  f"{missing[:5]}...")
        if out_path:
            np.savez_compressed(out_path, **out)
        return out

    @staticmethod
    def load_embeddings(
        out_dir: str,
        expected_dim: Optional[int] = None,
        strict_shapes: bool = False,
        seed: int = 0,
    ) -> Tuple[np.ndarray, dict]:
        """Load node embeddings; pad/truncate on dim mismatch with
        Xavier-filled padding unless strict (KG_Trainer.py:1282-1358)."""
        out = Path(out_dir)
        emb = np.load(out / "node_embeddings.npy")
        meta = json.loads((out / "embeddings_meta.json").read_text())
        if expected_dim is not None and emb.shape[1] != expected_dim:
            if strict_shapes:
                raise ValueError(
                    f"embedding dim {emb.shape[1]} != expected {expected_dim}"
                )
            if emb.shape[1] > expected_dim:
                emb = emb[:, :expected_dim]
            else:
                rng = np.random.default_rng(seed)
                bound = math.sqrt(6.0 / (emb.shape[0] + expected_dim))
                pad = rng.uniform(
                    -bound, bound, (emb.shape[0], expected_dim - emb.shape[1])
                ).astype(emb.dtype)
                emb = np.concatenate([emb, pad], axis=1)
        return emb, meta
