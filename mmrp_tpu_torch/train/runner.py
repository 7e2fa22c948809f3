"""Staged end-to-end training runner: a run directory, trained on the card.

Counterpart of ``mmrp_tpu/train/runner.py``, stage for stage and in JAX's
order, each stage skipped when its artifact already exists:

  stage 0: tokenizer -- corpus-trained WordPiece, or ``cfg.pretrained_vocab``
           (``vocab.txt``)
  stage 1: Swin finetune            -> <out>/swin/  (``swin_backbone.npz``,
           ``thresholds.npy``, ``best_swin_finetune_metrics.json``)
  stage 2: KG build + KGE training  -> <out>/kg/
           + LabelAttention pooling -> <out>/label_attention.npz
  stage 3: joint model              -> <out>/joint/ (vision tower warm-started
           from stage 1 and/or ``cfg.pretrained_swin``, text tower from
           ``cfg.pretrained_bert``; ``cfg.resume`` continues from its last
           full state)
  stage 4: embedding dumps + label-overlap GT + retrieval eval
           (``pipeline_summary.json``)

The run directory is what the port's ``serve/runner.py`` (and JAX's) serve:
``config.yaml`` as flat YAML that both packages' ``Config.load`` read,
``model_config.json``, and the best joint model as ``joint/params.npz`` (the
flat Flax names ``load_flax_params`` and JAX's ``load_param_tree`` read),
written after the joint stage's last best update. The joint checkpoints under
``joint/ckpt`` are the port's own (``utils/checkpoint.py``), not orbax.

The models run on ``device`` (the card unless the caller asks for the CPU):
in bf16 on the card, the precision the kernels take, with f32 master weights
in the optimizers; in f32 on the CPU, where each kernel wrapper runs its plain
version. The train-time model takes ``use_pallas_attention =
cfg.train_use_pallas_attention`` as JAX's does: the validation and dump
forwards run the Swin routes that gives (``model_routes``), while
``config.yaml`` keeps the serving setting.

The pretrained bootstrap, as JAX's: ``cfg.pretrained_vocab`` (the
checkpoint's own ``vocab.txt``, copied into the run), ``cfg.pretrained_bert``
(an HF BERT checkpoint: the text tower is built at its dims, written to
``model_config.json``, and starts from its weights) and ``cfg.pretrained_swin``
(an HF Swin checkpoint of the configured variant: the Swin finetune starts
from it, and the joint Swin tower from the finetuned weights, else from it).
Each names a local file or directory (``models/port.py``); nothing is fetched.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mmrp_tpu_torch.config import Config, dump_flat_yaml
from mmrp_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mmrp_tpu_torch.labels import LABEL_COLS


def _model_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _load_pretrained_backbones(cfg: Config, mm_swin_cfg, tok):
    """``cfg.pretrained_bert`` / ``cfg.pretrained_swin`` -> (the TextConfig of
    the BERT checkpoint, its converted tree, the converted Swin tree), each
    None where not configured, with JAX's checks: the vocab file must be the
    checkpoint's, the Swin layout the configured variant's."""
    from mmrp_tpu_torch.models import port

    text_override, bert_params, swin_params = None, None, None
    if cfg.pretrained_bert:
        sd = port.load_pretrained_state(cfg.pretrained_bert)
        text_override = port.text_config_from_state(sd)
        if text_override.vocab_size != len(tok.vocab):
            raise ValueError(
                f"pretrained_vocab has {len(tok.vocab)} tokens but the BERT "
                f"embedding table has {text_override.vocab_size} rows — the "
                "vocab file must be the checkpoint's own vocab.txt")
        bert_params = port.convert_hf_bert(sd, text_override.num_layers)
    if cfg.pretrained_swin:
        sd = port.load_pretrained_state(cfg.pretrained_swin)
        depths, heads = port.swin_layout_from_state(sd)
        if tuple(depths) != tuple(mm_swin_cfg.depths):
            raise ValueError(
                f"pretrained_swin depths {depths} != configured "
                f"image_backbone depths {tuple(mm_swin_cfg.depths)} — set "
                "image_backbone to the checkpoint's variant")
        if tuple(heads) != tuple(mm_swin_cfg.num_heads):
            raise ValueError(
                f"pretrained_swin heads {heads} != configured "
                f"image_backbone heads {tuple(mm_swin_cfg.num_heads)} — "
                "same depths but a different variant (e.g. Swin-S vs -B)")
        swin_params = port.convert_hf_swin(sd, depths)
    return text_override, bert_params, swin_params


def _warm_start(subtrees):
    """fn(masters) copying each {tower: Flax tree} onto the masters named
    ``backbones.<tower>.*``: each tree must cover its tower, leaf for leaf
    and shape for shape (JAX's tree_map over the two), else it raises."""
    from mmrp_tpu_torch.utils.convert import flax_to_state_dict

    warm = {f"backbones.{tower}.{k}": v for tower, tree in subtrees.items()
            for k, v in flax_to_state_dict(tree).items()}
    prefixes = tuple(f"backbones.{tower}." for tower in subtrees)

    def warm_start(params):
        missing = [k for k in params if k.startswith(prefixes) and k not in warm]
        if missing:
            raise ValueError(f"warm start: the pretrained weights lack {missing[:3]} "
                             f"({len(missing)} parameters)")
        with torch.no_grad():
            for k, v in warm.items():
                have = tuple(params[k].shape) if k in params else "no such parameter"
                if have != tuple(v.shape):
                    raise ValueError(f"warm start: {k} {tuple(v.shape)} does not fit the "
                                     f"model ({have})")
                params[k].copy_(v)
    return warm_start


def _run_swin_finetune_stage(cfg: Config, out: Path, split_recs, mm_cfg, tok, writer,
                             device: torch.device, pretrained_swin_params=None):
    """Stage 1: label-aware Swin finetune on a balanced subset, from
    ``pretrained_swin_params`` (a Flax tree) where given; cached as a
    Flax-named npz of the backbone + metrics JSON. Returns the backbone's
    flat Flax tree (f32 masters)."""
    from mmrp_tpu_torch.utils.checkpoint import load_param_tree, save_param_tree

    swin_dir = out / "swin"
    params_path = swin_dir / "swin_backbone.npz"
    if params_path.exists():
        return load_param_tree(str(params_path))

    from mmrp_tpu_torch.data.dataset import (
        ChestXRDataset,
        build_dataloader,
        pos_weight_from_labels,
    )
    from mmrp_tpu_torch.models.finetune_head import SwinForFinetune
    from mmrp_tpu_torch.train.swin_finetune import (
        SwinFinetuneConfig,
        build_finetune_subset,
        finetune,
    )
    from mmrp_tpu_torch.utils.convert import state_dict_to_flax_flat

    swin_dir.mkdir(parents=True, exist_ok=True)
    sub = build_finetune_subset(split_recs["train"], seed=cfg.seed)
    # image-only stage: text length 8 keeps the (unused) token batching cheap
    train_ds = ChestXRDataset(sub, tok, max_length=8, image_size=cfg.image_size)
    val_ds = ChestXRDataset(split_recs["val"], tok, max_length=8, image_size=cfg.image_size)
    train_loader = build_dataloader(train_ds, cfg.batch_size, weighted=True, seed=cfg.seed,
                                    num_workers=cfg.data_workers)
    val_loader = build_dataloader(val_ds, cfg.batch_size, shuffle=False,
                                  num_workers=cfg.data_workers)
    labels = np.stack([np.asarray(r["labels"], np.float32) for r in sub])
    pw = pos_weight_from_labels(labels, clamp_max=5.0)

    ft_cfg = SwinFinetuneConfig(lr=cfg.swin_finetune_lr, epochs=cfg.swin_finetune_epochs,
                                seed=cfg.seed)
    model = SwinForFinetune(mm_cfg.swin, num_classes=len(LABEL_COLS),
                            num_heads=mm_cfg.num_heads, dtype=_model_dtype(device),
                            device=device)
    res = finetune(model, ft_cfg, train_batches=lambda: iter(train_loader),
                   val_batches=lambda: iter(val_loader), base_pos_weight=pw,
                   metric_writer=writer, class_names=LABEL_COLS,
                   init_backbone=pretrained_swin_params)
    swin_params = {k[len("swin."):]: v for k, v in res["params"].items()
                   if k.startswith("swin.")}
    swin_flat = state_dict_to_flax_flat(model.swin, swin_params)
    save_param_tree(str(params_path), swin_flat)
    np.save(swin_dir / "thresholds.npy", res["thresholds"])
    (swin_dir / "best_swin_finetune_metrics.json").write_text(json.dumps(
        {"best_epoch": res["best_epoch"], "temperature": res["temperature"],
         "macro_f1": res["report"]["macro_f1"], "macro_auroc": res["report"]["macro_auroc"]},
        indent=1, default=float))
    print(f"[runner] Swin finetune done: epoch {res['best_epoch']}, "
          f"macro_f1 {res['report']['macro_f1']:.4f}")
    del model, res
    return swin_flat


def _run_label_attention_stage(cfg: Config, out: Path, split_recs, node_emb, node2id,
                               writer, device: torch.device):
    """The LabelAttention pooling head: trains on per-record label-node sets
    over the KG embedding table and writes the ``label_attention.npz`` the
    serving reranker reads."""
    la_path = out / "label_attention.npz"
    if la_path.exists():
        return
    from mmrp_tpu_torch.kg.label_attention import (
        LabelAttentionTrainer,
        LabelAttentionTrainerConfig,
    )

    label_sets, vecs = [], []
    for r in split_recs["train"]:
        idxs = [node2id.get(f"label:{g}") for g, on in zip(LABEL_COLS, r["labels"]) if on]
        label_sets.append([i for i in idxs if i is not None])
        vecs.append(np.asarray(r["labels"], np.float32))
    la_cfg = LabelAttentionTrainerConfig(
        hidden_dim=cfg.la_hidden_dim, batch_size=cfg.la_batch_size, epochs=cfg.la_epochs,
        lr=cfg.la_lr, patience=cfg.la_patience, ice_weight=cfg.la_ice_weight,
        tpl_weight=cfg.la_tpl_weight, bce_weight=cfg.la_bce_weight, seed=cfg.seed)
    la = LabelAttentionTrainer(node_emb, la_cfg, device=device)
    best = la.train(label_sets, np.stack(vecs), metric_writer=writer)
    rec = la.eval_retrieval(label_sets, np.stack(vecs))
    la.save(str(la_path))
    (out / "best_label_attention_metrics.json").write_text(
        json.dumps({**best, **rec}, indent=1, default=float))
    print(f"[runner] LabelAttention stage done: {best} {rec}")


def run_training_pipeline(
    cfg: Config,
    data_dir: str,
    out_dir: str,
    flagship: bool = False,
    max_records: Optional[int] = None,
    device=DEFAULT_DEVICE,
):
    """Train the run directory ``out_dir`` from the OpenI-format ``data_dir``
    (``records_cache.json``, ``splits/{train,val,test}_ids.json``) and return
    the summary written to ``pipeline_summary.json``."""
    from mmrp_tpu_torch.data.dataset import ChestXRDataset, build_dataloader
    from mmrp_tpu_torch.data.tokenizer import load_or_train_tokenizer
    from mmrp_tpu_torch.eval.gt import build_label_overlap_gt
    from mmrp_tpu_torch.eval.retrieval_eval import dual_gallery_eval
    from mmrp_tpu_torch.kg.builder import KGBuilder
    from mmrp_tpu_torch.kg.trainer import KGTrainer, KGTrainerConfig
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
    from mmrp_tpu_torch.train.pipeline import dump_embeddings, run_joint_training
    from mmrp_tpu_torch.utils.checkpoint import save_param_tree
    from mmrp_tpu_torch.utils.convert import state_dict_to_flax_flat
    from mmrp_tpu_torch.utils.logging import MetricWriter

    dev = resolve_device(device, "run_training_pipeline")
    data = Path(data_dir)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    # snapshot the config so serving can rebuild the exact model shape
    dump_flat_yaml(cfg.to_dict(), str(out / "config.yaml"))
    writer = MetricWriter(str(out), cfg.run_name, cfg.to_dict())

    records = json.loads((data / "records_cache.json").read_text())["records"]
    if max_records:
        records = records[:max_records]
    splits = {name: json.loads((data / "splits" / f"{name}_ids.json").read_text())
              for name in ("train", "val", "test")}
    by_id = {r["id"]: r for r in records}
    split_recs = {name: [by_id[i] for i in ids if i in by_id] for name, ids in splits.items()}
    for name, recs in split_recs.items():
        if not recs:  # fail fast, before hours of training
            raise ValueError(f"split {name!r} has no records in records_cache.json"
                             + (f" (max_records={max_records} truncation?)"
                                if max_records else ""))

    # ---- stage 0: tokenizer -------------------------------------------------
    if cfg.pretrained_vocab:
        # a pinned vocab.txt, copied every run so that an earlier run's
        # corpus-trained vocab in the same out_dir cannot shadow it
        shutil.copyfile(cfg.pretrained_vocab, out / "vocab.txt")
        tok = load_or_train_tokenizer(str(out / "vocab.txt"))
    else:
        tok = load_or_train_tokenizer(str(out / "vocab.txt"),
                                      corpus=(r["report_text"] for r in records))

    # train-time model config: JAX's train_use_pallas_attention; serving
    # rebuilds from config.yaml, which keeps the serving setting (same
    # parameters either way)
    train_cfg = dataclasses.replace(cfg, use_pallas_attention=cfg.train_use_pallas_attention)
    mm_cfg0 = MultiModalConfig.from_config(train_cfg, num_classes=len(LABEL_COLS),
                                           flagship=flagship)
    # ---- pretrained bootstrap --------------------------------------------------
    text_override, bert_params, swin_pre_params = _load_pretrained_backbones(
        cfg, mm_cfg0.swin, tok)

    # ---- stage 1: Swin finetune ----------------------------------------------
    swin_ft_params = None
    if cfg.run_swin_finetune and mm_cfg0.vision_backbone == "swin":
        swin_ft_params = _run_swin_finetune_stage(cfg, out, split_recs, mm_cfg0, tok, writer,
                                                  dev, swin_pre_params)

    # ---- stage 2: KG (before joint so alignment targets exist) -------------
    kg_dir = out / "kg"
    if not (kg_dir / "node_embeddings.npy").exists():
        builder = KGBuilder(out_dir=str(kg_dir), mode=cfg.kg_mode)
        builder = builder.ensure_exists(
            lambda b: b.build_from_records(split_recs["train"], LABEL_COLS))
        arr, conf, src = builder.triple_arrays()
        kg_cfg = KGTrainerConfig(
            model=cfg.kg_model, emb_dim=cfg.kg_emb_dim, epochs=cfg.kg_epochs, lr=cfg.kg_lr,
            neg_size=cfg.kg_neg_size, adv_temp=cfg.kg_adv_temp,
            use_bf16=cfg.kg_use_amp and dev.type == "cuda", seed=cfg.seed,
            **(dict(num_layers=cfg.kg_num_layers, dropout=cfg.kg_dropout, opn=cfg.kg_opn)
               if cfg.kg_model == "CompGCN" else {}))
        kgt = KGTrainer(len(builder.nodes), len(builder.relations), kg_cfg, device=dev)
        kgt.load_triples(arr.tolist(), conf.tolist(), src)
        best = kgt.train()
        kgt.save(str(kg_dir), node_names=list(builder.nodes))
        print(f"[runner] KG stage done: {best}")
    node_emb = np.load(kg_dir / "node_embeddings.npy")
    node2id = json.loads((kg_dir / "node2id.json").read_text())

    if cfg.run_label_attention:
        _run_label_attention_stage(cfg, out, split_recs, node_emb, node2id, writer, dev)

    # per-record KG targets for the alignment loss
    def kg_target_for(rec):
        idx = node2id.get(f"report:{rec['id']}")
        if idx is not None:
            return node_emb[idx], 1.0
        rows = [node2id.get(f"label:{g}") for g, on in zip(LABEL_COLS, rec["labels"]) if on]
        rows = [r for r in rows if r is not None]
        if rows:
            return node_emb[np.asarray(rows)].mean(0), 1.0
        return np.zeros(node_emb.shape[1], np.float32), 0.0

    # ---- stage 3: joint model -----------------------------------------------
    mm_cfg = MultiModalConfig.from_config(train_cfg, num_classes=len(LABEL_COLS),
                                          flagship=flagship, text_override=text_override)
    model = MultiModalRetrievalModel(mm_cfg, dtype=_model_dtype(dev), device=dev)
    # the resolved model shape, which serving rebuilds from, as JAX writes it:
    # its text tower's kernel switches at the values its from_config leaves
    # (the port's text tower takes its route from ``quant`` alone)
    (out / "model_config.json").write_text(json.dumps({
        "flagship": flagship,
        "vision_backbone": mm_cfg.vision_backbone,
        "text": {**{k: v for k, v in dataclasses.asdict(mm_cfg.text).items()
                    if k not in ("quant", "remat")},
                 "use_fused_ffn": False, "use_fused_attention": True},
    }, indent=1))

    # the joint towers start from the finetuned Swin (before the raw
    # checkpoint) and the ported BERT, never from random init where given
    warm_subtrees = {}
    vision_warm = swin_ft_params if swin_ft_params is not None else swin_pre_params
    if vision_warm is not None and mm_cfg.vision_backbone == "swin":
        warm_subtrees["swin"] = vision_warm
    if bert_params is not None:
        warm_subtrees["text"] = bert_params
    warm_start = _warm_start(warm_subtrees) if warm_subtrees else None

    class KGDataset(ChestXRDataset):
        def __getitem__(self, idx):
            s = super().__getitem__(idx)
            tgt, valid = kg_target_for(self.records[idx])
            s["kg_target"] = np.asarray(tgt, np.float32)
            s["kg_target_valid"] = np.float32(valid)
            return s

    train_ds = KGDataset(split_recs["train"], tok, max_length=cfg.text_dim,
                         image_size=cfg.image_size)
    val_ds = KGDataset(split_recs["val"], tok, max_length=cfg.text_dim,
                       image_size=cfg.image_size)
    train_loader = build_dataloader(train_ds, cfg.batch_size, weighted=True, seed=cfg.seed,
                                    num_workers=cfg.data_workers)
    val_loader = build_dataloader(val_ds, cfg.batch_size, shuffle=False,
                                  num_workers=cfg.data_workers)
    result = run_joint_training(cfg, model, train_loader, val_loader, str(out / "joint"),
                                kg_dim=node_emb.shape[1], class_names=LABEL_COLS,
                                metric_writer=writer, warm_start=warm_start)
    # the best joint model for serving, written after the last best update
    save_param_tree(str(out / "joint" / "params.npz"),
                    {"model": state_dict_to_flax_flat(model, result.state.params)})

    # ---- stage 4: embedding dumps + GT + retrieval eval ----------------------
    test_ds = KGDataset(split_recs["test"], tok, max_length=cfg.text_dim,
                        image_size=cfg.image_size)
    test_loader = build_dataloader(test_ds, cfg.batch_size, shuffle=False,
                                   num_workers=cfg.data_workers)
    dump_embeddings(model, test_loader, str(out / "test"))
    # NOT train_loader: the weighted sampler draws with replacement, which
    # would put duplicate rows in (and drop rows from) the gallery dump
    train_dump_loader = build_dataloader(train_ds, cfg.batch_size, shuffle=False,
                                         num_workers=cfg.data_workers)
    dump_embeddings(model, train_dump_loader, str(out / "train"))

    test_emb = np.load(out / "test_embeddings.npy")
    test_ids = json.loads((out / "test_ids.json").read_text())
    train_emb = np.load(out / "train_embeddings.npy")
    train_ids = json.loads((out / "train_ids.json").read_text())

    def lbl(ids):
        return np.stack([by_id[i]["labels"] for i in ids])

    gt_test = build_label_overlap_gt(test_ids, lbl(test_ids), test_ids, lbl(test_ids))
    gt_train = build_label_overlap_gt(test_ids, lbl(test_ids), train_ids, lbl(train_ids))
    ret = dual_gallery_eval(RetrievalEngine(test_emb, test_ids, device=dev),
                            RetrievalEngine(train_emb, train_ids, device=dev),
                            test_emb, test_ids, gt_test, gt_train,
                            out_dir=str(out / "retrieval_eval"))
    summary = {"joint": result.best_metrics, "retrieval": ret}
    (out / "pipeline_summary.json").write_text(json.dumps(summary, indent=1, default=float))
    writer.close()
    return summary
