"""LabelAttention: attention pooling of label embeddings -> report vector.

Counterpart of ``mmrp_tpu/kg/label_attention.py``:

- :class:`LabelAttention` (an MLP scores each label embedding, a masked
  softmax over the label set, a weighted sum) and :func:`load_label_attention`,
  which reads the npz that ``LabelAttentionTrainer.save`` writes in either
  package (``hidden_dim``, ``log_temp`` and the Flax leaves as
  ``param::params/Dense_{0,1}/{kernel,bias}``, kernels (in, out)) with numpy;
  the serving runner pools a record's label-node vectors with it
  (``serve/runner.py``);
- the trainer: pseudo positive / negative pairs by label overlap (Jaccard),
  InfoNCE with a learnable temperature + hardest-pair triplet + pairwise BCE,
  pad-and-mask batching in a numpy-seeded order, ``optax.adam`` as
  :class:`train.state.Adam`, early stopping on the epoch loss, recall@K
  retrieval eval. The initial weights are drawn from a ``torch.Generator``
  (Flax's lecun-normal kernels and zero biases); JAX's per-step keys feed no
  draw, so the step has none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.train.state import Adam


class LabelAttention(nn.Module):
    """scores = Dense(1)(tanh(Dense(hidden)(label_embs))), masked with -1e9
    where ``mask`` is 0, softmax over the labels, weighted sum. (B, L, D)
    [, (B, L)] -> (pooled (B, D), weights (B, L))."""

    def __init__(self, dim: int, hidden_dim: int = 256, dtype=torch.float32, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden_dim, dtype=dtype, device=device)
        self.Dense_1 = nn.Linear(hidden_dim, 1, dtype=dtype, device=device)

    def forward(self, label_embs: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = self.Dense_1(torch.tanh(self.Dense_0(label_embs)))[..., 0]
        if mask is not None:
            scores = torch.where(mask > 0, scores, torch.full_like(scores, -1e9))
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bl,bld->bd", w, label_embs), w


def load_label_attention(path: str, device=DEFAULT_DEVICE) -> LabelAttention:
    """The LabelAttention of a ``LabelAttentionTrainer.save`` npz, in f32 on
    ``device`` (the card unless the caller names another); each Flax Dense
    kernel (in, out) becomes an nn.Linear weight (out, in)."""
    dev = resolve_device(device, "load_label_attention")
    z = np.load(path)
    params = {key[len("param::params/"):]: z[key] for key in z.files
              if key.startswith("param::params/")}
    w0 = params["Dense_0/kernel"]
    model = LabelAttention(w0.shape[0], int(z["hidden_dim"]), device=dev)
    state = {f"{name.replace('/kernel', '.weight').replace('/bias', '.bias')}":
             torch.from_numpy(np.ascontiguousarray(v.T if name.endswith("kernel") else v))
             for name, v in params.items()}
    model.load_state_dict(state)
    return model.eval()


@dataclass
class LabelAttentionTrainerConfig:
    hidden_dim: int = 256
    batch_size: int = 128
    epochs: int = 30
    lr: float = 5e-4
    patience: int = 5
    ice_weight: float = 1.0   # InfoNCE
    tpl_weight: float = 0.5   # triplet
    bce_weight: float = 0.1   # pairwise BCE
    margin: float = 0.2
    pos_jaccard: float = 0.5  # pairs with overlap >= this are positives
    seed: int = 2709
    max_labels: int = 16      # pad-and-mask length


def _pad_label_embs(
    label_sets: Sequence[Sequence[int]],
    label_table: np.ndarray,
    max_labels: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample label index sets -> (B, Lmax, D) embeddings + (B, Lmax) mask."""
    B, D = len(label_sets), label_table.shape[1]
    embs = np.zeros((B, max_labels, D), np.float32)
    mask = np.zeros((B, max_labels), np.float32)
    for i, idxs in enumerate(label_sets):
        idxs = list(idxs)[:max_labels]
        if idxs:
            embs[i, : len(idxs)] = label_table[idxs]
            mask[i, : len(idxs)] = 1.0
    return embs, mask


def jaccard_matrix(labels: np.ndarray) -> np.ndarray:
    """(N, C) binary -> (N, N) pairwise Jaccard.

    One (N, C) @ (C, N) matmul — the broadcast form would materialize an
    (N, N, C) tensor, gigabytes at train-split scale (N~6k, C=43)."""
    lf = labels.astype(bool).astype(np.float32)
    inter = lf @ lf.T
    counts = lf.sum(axis=1)
    union = counts[:, None] + counts[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _pad_label_embs(label_sets: Sequence[Sequence[int]], label_table: np.ndarray,
                    max_labels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample label index sets -> (B, Lmax, D) embeddings + (B, Lmax) mask."""
    B, D = len(label_sets), label_table.shape[1]
    embs = np.zeros((B, max_labels, D), np.float32)
    mask = np.zeros((B, max_labels), np.float32)
    for i, idxs in enumerate(label_sets):
        idxs = list(idxs)[:max_labels]
        if idxs:
            embs[i, : len(idxs)] = label_table[idxs]
            mask[i, : len(idxs)] = 1.0
    return embs, mask


def jaccard_matrix(labels: np.ndarray) -> np.ndarray:
    """(N, C) binary -> (N, N) pairwise Jaccard, as one (N, C) @ (C, N) product."""
    lf = labels.astype(bool).astype(np.float32)
    inter = lf @ lf.T
    counts = lf.sum(axis=1)
    union = counts[:, None] + counts[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Flax's default Dense kernel init: a normal truncated at 2 std, scaled
    to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.mul_(std)


class LabelAttentionTrainer:
    def __init__(self, label_table: np.ndarray,
                 cfg: Optional[LabelAttentionTrainerConfig] = None, device=DEFAULT_DEVICE):
        self.cfg = cfg or LabelAttentionTrainerConfig()
        self.device = resolve_device(device, "LabelAttentionTrainer")
        self.label_table = np.asarray(label_table, np.float32)
        self.model: Optional[LabelAttention] = None
        self.log_temp: Optional[torch.Tensor] = None

    def init(self, generator: torch.Generator) -> None:
        D = self.label_table.shape[1]
        self.model = LabelAttention(D, self.cfg.hidden_dim, device=self.device)
        with torch.no_grad():
            for lin in (self.model.Dense_0, self.model.Dense_1):
                _lecun_normal_(lin.weight, lin.in_features, generator)
                lin.bias.zero_()
        self.log_temp = torch.tensor(np.log(0.07), dtype=torch.float32, device=self.device)

    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable tensors: the model's parameters and ``log_temp``."""
        return {**dict(self.model.named_parameters()), "log_temp": self.log_temp}

    def _tensors(self, label_sets, idx=None):
        sets = label_sets if idx is None else [label_sets[i] for i in idx]
        embs, mask = _pad_label_embs(sets, self.label_table, self.cfg.max_labels)
        return (torch.from_numpy(embs).to(self.device), torch.from_numpy(mask).to(self.device))

    @torch.no_grad()
    def pool(self, label_sets: Sequence[Sequence[int]]) -> np.ndarray:
        out, _ = self.model(*self._tensors(label_sets))
        return out.cpu().numpy()

    def loss(self, embs: torch.Tensor, mask: torch.Tensor, pos_pair: torch.Tensor):
        """The weighted loss and its terms (InfoNCE, triplet, pairwise BCE)."""
        cfg = self.cfg
        emb, _ = self.model(embs, mask)
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-8)
        sim = emb @ emb.T
        temp = torch.exp(self.log_temp)
        B = emb.shape[0]
        eye = torch.eye(B, dtype=torch.bool, device=emb.device)
        zero = torch.zeros((), device=emb.device)

        # InfoNCE over pseudo-positive pairs (multi-positive form)
        logits = sim / temp + torch.where(eye, -1e9, 0.0)
        pos_mask = pos_pair & ~eye
        log_p = torch.log_softmax(logits, dim=1)
        has_pos = pos_mask.any(1)
        n_pos = torch.clamp(has_pos.sum(), min=1)
        ice = -torch.where(has_pos, (log_p * pos_mask).sum(1)
                           / torch.clamp(pos_mask.sum(1), min=1), zero)
        ice = ice.sum() / n_pos
        # triplet: hardest positive vs hardest negative
        pos_sim = torch.where(pos_mask, sim, float("inf")).amin(1)
        neg_sim = torch.where(~pos_mask & ~eye, sim, -float("inf")).amax(1)
        ok = has_pos & torch.isfinite(pos_sim) & torch.isfinite(neg_sim)
        tpl = torch.where(ok, torch.clamp(cfg.margin + neg_sim - pos_sim, min=0.0), zero)
        tpl = tpl.sum() / n_pos
        # pairwise BCE on similarities vs pair labels (optax's form)
        x = sim / temp
        z = pos_pair.float()
        bce = torch.relu(x) - x * z + torch.log1p(torch.exp(-x.abs()))
        bce = torch.where(eye, zero, bce).mean()
        total = cfg.ice_weight * ice + cfg.tpl_weight * tpl + cfg.bce_weight * bce
        return total, {"ice": ice, "tpl": tpl, "bce": bce}

    def _make_step(self):
        tx = Adam(self.cfg.lr)

        def step(opt_state, embs, mask, pos_pair):
            params = self.params()
            for p in params.values():
                p.requires_grad_(True)
            loss, aux = self.loss(embs, mask, pos_pair)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            for p in params.values():
                p.requires_grad_(False)
            tx.step(params, grads, opt_state)
            aux = {k: v.detach() for k, v in aux.items()}
            aux["loss"] = loss.detach()
            return opt_state, aux

        return tx, step

    def train(self, label_sets: Sequence[Sequence[int]], label_vectors: np.ndarray,
              metric_writer=None) -> Dict[str, float]:
        cfg = self.cfg
        if self.model is None:
            self.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        tx, step = self._make_step()
        opt_state = tx.init(self.params())
        rng = np.random.default_rng(cfg.seed)
        N = len(label_sets)
        B = min(cfg.batch_size, N)
        jac = jaccard_matrix(label_vectors)
        best = {"loss": float("inf")}
        best_state = {k: v.detach().clone() for k, v in self.params().items()}
        bad = 0
        for epoch in range(cfg.epochs):
            order = rng.permutation(N)
            ep_loss = []
            for s in range(0, N - B + 1, B):
                idx = order[s: s + B]
                pos = torch.from_numpy(jac[np.ix_(idx, idx)] >= cfg.pos_jaccard).to(self.device)
                opt_state, aux = step(opt_state, *self._tensors(label_sets, idx), pos)
                ep_loss.append(float(aux["loss"]))
            mean_loss = float(np.mean(ep_loss)) if ep_loss else 0.0
            if metric_writer is not None:
                metric_writer.log({"la/loss": mean_loss}, step=epoch)
            if mean_loss < best["loss"] - 1e-5:
                best = {"loss": mean_loss, "epoch": epoch}
                best_state = {k: v.detach().clone() for k, v in self.params().items()}
                bad = 0
            else:
                bad += 1
                if bad >= cfg.patience:
                    break
        with torch.no_grad():
            for k, v in self.params().items():
                v.copy_(best_state[k])
        return best

    # -- retrieval eval ------------------------------------------------------------

    def eval_retrieval(self, label_sets: Sequence[Sequence[int]], label_vectors: np.ndarray,
                       ks: Tuple[int, ...] = (5, 10)) -> Dict[str, float]:
        emb = self.pool(label_sets)
        emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
        sim = emb @ emb.T
        np.fill_diagonal(sim, -np.inf)
        jac = jaccard_matrix(label_vectors)
        np.fill_diagonal(jac, 0.0)
        rel = jac >= self.cfg.pos_jaccard
        out = {}
        order = np.argsort(-sim, axis=1)
        for k in ks:
            topk = order[:, :k]
            hits = rel[np.arange(len(emb))[:, None], topk]
            n_rel = rel.sum(1)
            recall = np.where(n_rel > 0, hits.sum(1) / np.maximum(n_rel, 1), 0.0)
            out[f"recall@{k}"] = float(recall[n_rel > 0].mean()) if (n_rel > 0).any() else 0.0
        return out

    # -- persistence ----------------------------------------------------------------

    def save(self, path: str) -> None:
        """The npz of the JAX trainer's ``save``: ``hidden_dim``, ``log_temp``
        and ``param::params/Dense_{0,1}/{bias,kernel}`` (kernels (in, out))."""
        leaves = {}
        for name in ("Dense_0", "Dense_1"):
            lin = getattr(self.model, name)
            leaves[f"param::params/{name}/bias"] = lin.bias.detach().cpu().numpy()
            leaves[f"param::params/{name}/kernel"] = lin.weight.detach().cpu().numpy().T.copy()
        np.savez_compressed(path, hidden_dim=self.cfg.hidden_dim,
                            log_temp=self.log_temp.detach().cpu().numpy(), **leaves)

    @classmethod
    def from_checkpoint(cls, path: str, label_table: np.ndarray,
                        device=DEFAULT_DEVICE) -> "LabelAttentionTrainer":
        z = np.load(path)
        t = cls(label_table, LabelAttentionTrainerConfig(hidden_dim=int(z["hidden_dim"])),
                device=device)
        t.model = load_label_attention(path, device=device).train()
        t.log_temp = torch.tensor(np.asarray(z["log_temp"]), dtype=torch.float32,
                                  device=t.device)
        return t
