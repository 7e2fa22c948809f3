"""Serving context of a trained run directory, wired into ``MMRPredictor``.

Counterpart of ``mmrp_tpu/serve/runner.py``, step for step: the run's
``config.yaml`` (``Config.load``), ``vocab.txt``, ``model_config.json`` (the
trained model's shape: ``flagship``, the text tower's dims),
``swin_act_amax.json`` for ``serve_quant="int8_static"``, the model's
weights, the gallery (``train_embeddings.npy`` + ``train_ids.json``), the
reranker's inputs (``records_cache.json``, ``kg/node_embeddings.npy`` +
``kg/node2id.json``), the calibrated thresholds (``joint/thresholds.npy``)
and the DICOM preprocessor.

Two choices differ from the JAX package's:

- **Weights** come from ``joint/params.npz``, a ``save_param_tree`` npz of
  ``{"model": tree}``: the port cannot read the orbax checkpoint under
  ``joint/ckpt/`` of a JAX run (no JAX, orbax or tensorstore on the card). A
  JAX run that has an orbax best checkpoint and no npz, or one newer than the
  npz, raises, naming the one-line conversion a JAX host runs
  (:data:`CONVERT`). A run the port trained (``train/runner.py``) writes the
  npz after its last best update; its best checkpoint is in the port's own
  format (``joint/ckpt/best/state.pt``, ``utils/checkpoint.py``), which is
  read directly where it is newer than the npz or the npz is missing (a run
  stopped inside its joint stage). A run with neither serves seeded
  ``init_params`` weights, as JAX serves its template init; weights that do
  not fit the rebuilt model raise, as JAX's do.
- **Dtype**: the model is built in bf16 on the card, the precision every
  kernel wrapper takes (they refuse f32), and in f32 on the CPU, where the
  wrappers run their plain versions, whatever ``Config.dtype_policy`` says
  (JAX only validates the field); a run with ``dtype_policy: f32`` served
  on the card says so in one line.

A run with ``label_attention.npz`` and KG embeddings pools each record's
label-node vectors with that LabelAttention model (``kg/label_attention.py``),
as JAX does.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from mmrp_tpu_torch.api import MMRPredictor
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.data.dicom import DICOMImagePreprocessor
from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.kg.label_attention import load_label_attention
from mmrp_tpu_torch.labels import LABEL_COLS
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.quant_calib import build_quant_cache
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
from mmrp_tpu_torch.retrieval.rerank import Reranker
from mmrp_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager
from mmrp_tpu_torch.utils.convert import init_params, load_flax_params

# run on a JAX host (with the JAX package) to write joint/params.npz from the
# run's orbax checkpoint: RUN is the run directory
CONVERT = (
    "python -c \"import sys; from mmrp_tpu.serve.runner import build_demo_context; "
    "from mmrp_tpu.utils.checkpoint import save_param_tree; r = sys.argv[1]; "
    "save_param_tree(r + '/joint/params.npz', "
    "{'model': build_demo_context(r)['predictor'].params['model']})\" RUN")


def _newest_mtime(path: Path) -> float:
    """The latest modification time of ``path`` and everything under it."""
    return max([path.stat().st_mtime] + [p.stat().st_mtime for p in path.rglob("*")])


def restore_best_model(ckpt_dir) -> Dict[str, torch.Tensor]:
    """The model masters of a port-trained run's best checkpoint
    (``train/pipeline.py`` saves ``{"model": {name: f32 tensor}}``)."""
    return CheckpointManager(str(ckpt_dir)).restore_best()["model"]


def load_rerank_inputs(run_dir, data_dir=None, warn=True):
    """Reranker inputs from a run: per-record labels (records_cache.json)
    and KG node embeddings, as the JAX ``load_rerank_inputs``.

    records_cache.json lives in the data pipeline's output dir: pass
    ``data_dir`` when the run dir is not nested inside it (the ``run.parent``
    fallback matches the ``cli train --data D --out D/train`` layout). A
    missing cache is warned about: with empty ``labels_by_id`` the
    reranker's label-overlap term vanishes.
    """
    run = Path(run_dir)
    candidates = [Path(data_dir)] if data_dir else [run.parent, run]
    labels_by_id: Dict[str, Any] = {}
    records_by_id: Dict[str, Any] = {}
    for c in candidates:
        p = c / "records_cache.json"
        if p.exists():
            recs = json.loads(p.read_text())["records"]
            labels_by_id = {r["id"]: np.asarray(r["labels"]) for r in recs}
            records_by_id = {r["id"]: r for r in recs}
            break
    if warn and not labels_by_id:
        print(
            "[serve] WARNING: records_cache.json not found under "
            f"{[str(c) for c in candidates]} — the reranker's label-overlap "
            "term is disabled (point --data at the data pipeline output)"
        )
    kg_kwargs: Dict[str, Any] = {}
    kg_dir = run / "kg"
    # both files or neither: an embeddings table without the id map is
    # unusable, so the KG term is left out instead
    if ((kg_dir / "node_embeddings.npy").exists()
            and (kg_dir / "node2id.json").exists()):
        kg_kwargs = dict(
            kg_node_embeddings=np.load(kg_dir / "node_embeddings.npy"),
            kg_node2id=json.loads((kg_dir / "node2id.json").read_text()),
        )
    elif (kg_dir / "node_embeddings.npy").exists():
        print(
            "[serve] WARNING: kg/node_embeddings.npy present but "
            "node2id.json missing — KG rerank term disabled"
        )
    return labels_by_id, records_by_id, kg_kwargs


def build_demo_context(run_dir: str, data_dir: str = None,
                       device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """-> {predictor, tokenizer, preprocessor, max_length, records_by_id}
    for the run in ``run_dir``, the model on ``device`` (the card unless the
    caller names another)."""
    dev = resolve_device(device, "build_demo_context")
    run = Path(run_dir)
    cfg_path = run / "config.yaml"
    cfg = Config.load(str(cfg_path)) if cfg_path.exists() else Config()
    if dev.type == "cuda" and cfg.dtype_policy == "f32":
        print(f"[serve] {cfg_path}: dtype_policy 'f32': the card computes in bf16, the "
              "precision its kernels take")

    tok = WordPieceTokenizer.from_vocab_file(str(run / "vocab.txt"))

    # the trained model's shape: config.yaml alone misses a text tower pinned
    # to a ported checkpoint and flagship=True, which training snapshots here
    text_override, flagship = None, False
    mc_path = run / "model_config.json"
    if mc_path.exists():
        mc = json.loads(mc_path.read_text())
        flagship = bool(mc.get("flagship", False))
        # the port's TextConfig fields; the JAX kernel switches
        # (use_fused_attention, use_fused_ffn) choose no route here
        names = {f.name for f in dataclasses.fields(TextConfig)} - {"quant"}
        tdict = {k: v for k, v in mc.get("text", {}).items() if k in names}
        if tdict:
            text_override = TextConfig(**tdict)
    # int8_static serving: the calibration file written next to the run
    if (cfg.serve_quant == "int8_static" and not cfg.swin_act_amax_path
            and (run / "swin_act_amax.json").exists()):
        cfg = dataclasses.replace(cfg, swin_act_amax_path=str(run / "swin_act_amax.json"))
    mm_cfg = MultiModalConfig.from_config(cfg, num_classes=len(LABEL_COLS),
                                          flagship=flagship, text_override=text_override)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = MultiModalRetrievalModel(mm_cfg, dtype=dtype, device=dev).eval()

    npz = run / "joint" / "params.npz"
    best = run / "joint" / "ckpt" / "best"
    stale = npz.exists() and best.exists() and _newest_mtime(best) > npz.stat().st_mtime
    if (best / STATE_FILE).exists() and (stale or not npz.exists()):
        # the port's own best checkpoint: the f32 masters under the model's names
        masters = restore_best_model(run / "joint" / "ckpt")
        try:
            model.load_state_dict(masters, strict=True)
        except RuntimeError as e:
            raise RuntimeError(
                f"checkpoint {best} does not match the model shape rebuilt from "
                f"{run}/config.yaml+model_config.json: {e}") from e
        build_quant_cache(model, master=masters, stale_only=True)
    elif stale:
        # the run was trained again after its npz was written: serving the
        # old weights against the new gallery and thresholds is silent garbage
        raise RuntimeError(
            f"{best} is newer than {npz}: write the npz again on a JAX host with\n  {CONVERT}")
    elif npz.exists():
        try:
            load_flax_params(model, str(npz))
        except (RuntimeError, KeyError, ValueError) as e:
            # weights EXIST but do not fit: serving other weights against a
            # trained gallery would be silent garbage
            raise RuntimeError(
                f"checkpoint {npz} does not match the model shape rebuilt from "
                f"{run}/config.yaml+model_config.json: {e}") from e
    elif best.exists():
        raise RuntimeError(
            f"{run}/joint/ckpt holds an orbax checkpoint, which the port cannot read, and "
            f"{npz} is missing: write it on a JAX host with\n  {CONVERT}")
    else:
        init_params(model, seed=0)  # no checkpoint yet: the demo still functions

    retriever = None
    reranker = None
    labels_by_id, records_by_id, kg_kwargs = load_rerank_inputs(run, data_dir=data_dir)
    emb_p, ids_p = run / "train_embeddings.npy", run / "train_ids.json"
    if emb_p.exists() and ids_p.exists():
        retriever = RetrievalEngine.from_files(str(emb_p), str(ids_p), device=dev)
        # attention pooling of label-node vectors when a LabelAttention
        # checkpoint exists
        label_pooler = None
        la_ckpt = run / "label_attention.npz"
        if la_ckpt.exists() and "kg_node_embeddings" in kg_kwargs:
            la = load_label_attention(str(la_ckpt), device=dev)

            def label_pooler(vecs):  # (k, D) -> (D,)
                embs = torch.as_tensor(np.asarray(vecs, np.float32), device=dev)[None]
                with torch.inference_mode():
                    pooled, _ = la(embs, torch.ones(embs.shape[:2], device=dev))
                return pooled[0].cpu().numpy()

        reranker = Reranker(
            alpha=cfg.rerank_alpha, beta=cfg.rerank_beta, gamma=cfg.rerank_gamma,
            labels_by_id=labels_by_id, label_names=LABEL_COLS, label_pooler=label_pooler,
            **kg_kwargs,
        )

    # per-class calibrated thresholds from the joint stage
    th_path = run / "joint" / "thresholds.npy"
    threshold = np.load(th_path) if th_path.exists() else 0.5

    predictor = MMRPredictor(model, LABEL_COLS, retriever, reranker, threshold=threshold)
    return {
        "predictor": predictor,
        "tokenizer": tok,
        "preprocessor": DICOMImagePreprocessor(output_size=(cfg.image_size, cfg.image_size)),
        "max_length": min(cfg.text_dim, 512),
        "records_by_id": records_by_id,
    }
