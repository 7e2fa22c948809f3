"""High-level inference API: embed / retrieve / predict / explain.

Counterpart of ``mmrp_tpu/api.py``: ``serving_forward`` is the one serving
forward contract, and ``MMRPredictor`` composes it with an exact retrieval
engine, an optional reranker and the explanation engine
(``models/explain.py``, built at first use); ``MMRPredictor.from_run_dir``
builds all of it from a training-run directory (``serve/runner.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrp_tpu_torch.device import DEFAULT_DEVICE
from mmrp_tpu_torch.models.explain import ExplanationEngine
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.models.quant_calib import build_quant_cache
from mmrp_tpu_torch.models.text_encoder import prefix_lengths
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine


def serving_forward(model: MultiModalRetrievalModel) -> Callable[..., Dict[str, torch.Tensor]]:
    """(image, ids, mask) -> {probs, joint_emb, img_emb, txt_emb}, under
    ``torch.inference_mode()``. ``mask`` is a tensor beside ``ids``, or the
    caller's numpy array on the host, which the forward copies to ``ids``'s
    device: where every row of it is a prefix of valid tokens and the batch
    holds padding, the text then runs packed (the model's ``text_lengths``),
    planned on the host with no read of the device."""

    def fwd(image: torch.Tensor, ids: torch.Tensor, mask):
        lengths = None
        if isinstance(mask, np.ndarray):
            lengths = prefix_lengths(mask)
            mask = torch.from_numpy(np.ascontiguousarray(mask, np.int64))
            if ids.device.type == "cuda":
                mask = mask.pin_memory().to(ids.device, non_blocking=True)
        with torch.inference_mode():
            out = model(image, ids, mask, text_lengths=lengths)
            return {
                "probs": torch.sigmoid(out["logits"]),
                "joint_emb": out["joint_emb"],
                "img_emb": out["img_emb"],
                "txt_emb": out["txt_emb"],
            }

    return fwd


class MMRPredictor:
    """``reranker``, when given, reorders an over-fetched candidate pool
    (``retrieval/rerank.py::Reranker``, or any object with its
    ``rerank(query_id, cand_ids, cand_embs, query_emb, topk=K)`` returning
    ranked ``(id, score, ...)`` tuples)."""

    def __init__(
        self,
        model: MultiModalRetrievalModel,
        label_names: Sequence[str],
        retriever: Optional[RetrievalEngine] = None,
        reranker: Optional[Any] = None,
        threshold: "float | np.ndarray" = 0.5,
    ):
        # threshold: a scalar or the per-class calibrated vector
        self.model = model
        # int8_static serving: the Swin int8 weights are quantized once, here
        # at the latest (the model keeps them current across loads), so that
        # no request pays for it (mmrp_tpu/api.py:75-86)
        if model.config.swin.quant == "int8_static":
            build_quant_cache(model, stale_only=True)
        self.label_names = list(label_names)
        self.retriever = retriever
        self.reranker = reranker
        self.threshold = threshold
        self._fwd = serving_forward(model)
        self._explainer: Optional[ExplanationEngine] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- embed ----------------------------------------------------------------

    def embed(self, image: np.ndarray, input_ids: np.ndarray,
              attention_mask: np.ndarray) -> Dict[str, np.ndarray]:
        dev = self.device
        out = self._fwd(
            torch.as_tensor(np.asarray(image, np.float32)).to(dev),
            torch.as_tensor(np.asarray(input_ids, np.int64)).to(dev),
            np.asarray(attention_mask, np.int64),
        )
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    # -- retrieve ---------------------------------------------------------------

    def retrieve(self, joint_emb: np.ndarray, K: int = 5, query_id: Optional[str] = None,
                 rerank: bool = True) -> List[Tuple[str, float]]:
        if self.retriever is None:
            raise RuntimeError("no retrieval engine attached")
        # over-fetch only when a reranker will actually reorder the pool
        extra = K * 3 if (rerank and self.reranker is not None) else K
        hits = self.retriever.retrieve(joint_emb, K=extra, query_id=query_id)
        if rerank and self.reranker is not None and hits:
            cand_ids = [h[0] for h in hits]
            cand_embs = self.retriever.get_embeddings_for_ids(cand_ids)
            ranked = self.reranker.rerank(query_id or "", cand_ids, cand_embs, joint_emb,
                                          topk=K)
            return [(r[0], r[1]) for r in ranked]
        return hits[:K]

    # -- predict ----------------------------------------------------------------

    def predict(self, image: np.ndarray, input_ids: np.ndarray,
                attention_mask: np.ndarray, K: int = 5, threshold=None,
                top_k_labels: int = 5, query_id: Optional[str] = None,
                retrieve: bool = True, explain: bool = False,
                explain_targets: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        thr = np.asarray(self.threshold if threshold is None else threshold)
        out = self.embed(image, input_ids, attention_mask)
        probs = out["probs"]
        B = probs.shape[0]
        results: Dict[str, Any] = {
            "probs": probs,
            "joint_emb": out["joint_emb"],
            "predicted": [],
            "top_labels": [],
        }
        for b in range(B):
            p = probs[b]
            pred_idx = np.where(p >= thr)[0]
            order = np.argsort(-p)[:top_k_labels]
            results["predicted"].append([(self.label_names[i], float(p[i])) for i in pred_idx])
            results["top_labels"].append([(self.label_names[i], float(p[i])) for i in order])
        if retrieve and self.retriever is not None:
            # query_id names ONE gallery row: applying it to every element of
            # a batch would drop other samples' true neighbours
            qid = query_id if B == 1 else None
            results["retrieval"] = [
                self.retrieve(out["joint_emb"][b], K=K, query_id=qid) for b in range(B)
            ]
        if explain:
            targets = explain_targets
            if targets is None:
                if B == 1:
                    targets = np.argsort(-probs[0])[:top_k_labels].tolist()
                else:
                    # per-sample auto targets: one (B,) vector per rank slot, so
                    # every sample is explained for its own top-k classes
                    # (keyed "rank{j}" in per_target)
                    order = np.argsort(-probs, axis=1)[:, :top_k_labels]
                    targets = [order[:, j] for j in range(order.shape[1])]
            results["explanation"] = self.explainer.explain(image, input_ids, attention_mask,
                                                            targets)
        return results

    # -- explain ----------------------------------------------------------------

    @property
    def explainer(self) -> ExplanationEngine:
        if self._explainer is None:  # lazy, as the reference's
            self._explainer = ExplanationEngine(self.model)
        return self._explainer

    def explain(self, image: np.ndarray, input_ids: np.ndarray, attention_mask: np.ndarray,
                targets: Sequence[int], **kw) -> Dict[str, Any]:
        return self.explainer.explain(image, input_ids, attention_mask, targets, **kw)

    # -- construction from a trained run -------------------------------------

    @classmethod
    def from_run_dir(cls, run_dir: str, device=DEFAULT_DEVICE) -> "MMRPredictor":
        """The predictor of a training-run directory (weights, gallery,
        reranker inputs, thresholds) on ``device``, the card unless the
        caller names another (``serve/runner.py::build_demo_context``)."""
        from mmrp_tpu_torch.serve.runner import build_demo_context

        return build_demo_context(run_dir, device=device)["predictor"]
