"""LabelAttention: attention pooling of label embeddings -> report vector.

The inference half of ``mmrp_tpu/kg/label_attention.py``: :class:`LabelAttention`
(an MLP scores each label embedding, a masked softmax over the label set, a
weighted sum) and :func:`load_label_attention`, which reads the npz that the
JAX ``LabelAttentionTrainer.save`` writes (``hidden_dim``, ``log_temp`` and
the Flax leaves as ``param::params/Dense_{0,1}/{kernel,bias}``) with numpy.
The serving runner pools a record's label-node vectors with it
(``serve/runner.py``). The trainer half (InfoNCE, triplet and pairwise-BCE
losses, retrieval eval) is not ported (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device


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
