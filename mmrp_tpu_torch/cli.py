"""Command-line entry points of the port.

Counterpart of ``mmrp_tpu/cli.py``: ``python -m mmrp_tpu_torch.cli`` has
every subcommand of ``python -m mmrp_tpu.cli``, with its flags:

    data        parse + label + verify + split (data_run.py:31-62)
    train       staged training: swin finetune -> KG -> joint (train.py:209)
    eval-cls    classification eval on a split (eval_on_test.py)
    eval-ret    dual-gallery retrieval eval (retrieval_eval.py)
    parity      the reference's full evaluation protocol (eval/parity.py)
    kg-probe    KG embedding health checks (kg_check/diagnose/probe)
    mapper      label -> ontology mapping (mapper_runner.py)
    serve       web demo (web/app.py)
    stream      streaming embed + retrieve + predict over a split
    calibrate   int8_static activation calibration (models/quant_calib.py)
    export-serving  a serving artifact of a run (serve/exported.py), cuda and/or cpu programs
    bench       not ported: exits 2 (ROADMAP.md Queue 1 item 1)

The subcommands that run a model or a gallery (train, eval-ret, parity,
serve, stream, calibrate) take one flag JAX's do not, ``--device`` (default
``cuda``), the port's counterpart of ``JAX_PLATFORMS``: it goes to every
entry point that takes a device, so they run on the card unless given
``--device cpu``. The others run on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from mmrp_tpu_torch.device import DEFAULT_DEVICE


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--out", default="runs/default", help="output directory")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the model and gallery (default: the card)")


def cmd_data(args) -> int:
    from mmrp_tpu_torch.data.openi import parse_openi_xml
    from mmrp_tpu_torch.data.splits import train_val_test_split
    from mmrp_tpu_torch.data.verify import LabelVerifier, apply_verdicts
    from mmrp_tpu_torch.eval.eda import drop_zero_label_records, eda_before_split
    from mmrp_tpu_torch.labels import LABEL_COLS

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    records = parse_openi_xml(
        args.xml_dir, args.dicom_dir, cache_path=str(out / "records_cache.json")
    )
    print(f"[data] parsed {len(records)} records")
    # the live rotating-key Gemini client activates when GEMINI_KEYS is
    # set (data/verify.py::gemini_client_from_env); otherwise complete is
    # None and verification is the offline cached/Unknown pass-through
    from mmrp_tpu_torch.data.verify import gemini_client_from_env

    verifier = LabelVerifier(cache_path=str(out / "verify_cache.json"),
                             complete=gemini_client_from_env())
    records = apply_verdicts(records, verifier.verify(records))
    eda_before_split(records, LABEL_COLS, str(out / "eda_before_split.json"))
    records = drop_zero_label_records(records)
    splits = train_val_test_split(records, seed=args.seed, out_dir=str(out / "splits"))
    print(f"[data] splits: { {k: len(v) for k, v in splits.items()} }")

    # per-split distribution check + phrase-match spot check (data_run.py stages)
    from mmrp_tpu_torch.data.labeler import PhraseLabeler
    from mmrp_tpu_torch.eval.eda import eda_after_split, phrase_match_check

    by_id = {r["id"]: r for r in records}
    eda_after_split(splits, by_id, LABEL_COLS, str(out / "eda_after_split.json"))
    checks = phrase_match_check(records, PhraseLabeler(), n_samples=10)
    (out / "phrase_check.json").write_text(json.dumps(checks, indent=1))

    # visual diagnostics (dataEDAnLabeledCheck.py, data_phrase_check.py:61-110);
    # the PNGs where matplotlib imports (eval/eda.py::pyplot)
    import numpy as np

    from mmrp_tpu_torch.eval.eda import (
        dicom_debug_plots, label_distribution_plot, mesh_label_stats,
    )

    eda_dir = out / "eda"
    mesh_label_stats(args.xml_dir, out_dir=str(eda_dir))
    if records:
        dicom_debug_plots(records[0]["dicom_path"], str(eda_dir))
        label_distribution_plot(
            np.stack([r["labels"] for r in records]), LABEL_COLS,
            str(eda_dir / "label_distribution.png"),
        )
    return 0


def cmd_train(args) -> int:
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.train.runner import run_training_pipeline

    cfg = Config.load(args.config) if args.config else Config()
    if args.resume:
        cfg = cfg.replace(resume=True)
    run_training_pipeline(cfg, data_dir=args.data, out_dir=args.out, device=args.device)
    return 0


def cmd_eval_cls(args) -> int:
    import numpy as np

    from mmrp_tpu_torch.eval.classification import evaluate_classification
    from mmrp_tpu_torch.labels import LABEL_COLS

    probs = np.load(args.probs)
    labels = np.load(args.labels)
    th = np.load(args.thresholds) if args.thresholds else None
    rep = evaluate_classification(probs, labels, LABEL_COLS, th, args.out)
    print(json.dumps({k: v for k, v in rep.items() if k != "per_class"}, indent=1))
    return 0


def cmd_eval_ret(args) -> int:
    import numpy as np

    from mmrp_tpu_torch.eval.retrieval_eval import dual_gallery_eval
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine

    test_eng = RetrievalEngine.from_files(args.test_emb, args.test_ids, device=args.device)
    train_eng = RetrievalEngine.from_files(args.train_emb, args.train_ids, device=args.device)
    q_embs = np.load(args.test_emb).astype(np.float32)  # JAX's raw_embeddings
    q_ids = test_eng.ids
    gt_test = json.loads(Path(args.gt_test).read_text())
    gt_train = json.loads(Path(args.gt_train).read_text())
    res = dual_gallery_eval(
        test_eng, train_eng, q_embs, q_ids, gt_test, gt_train,
        k=args.k, out_dir=args.out,
    )
    if args.variants:
        # reranker ablations + paired significance vs baseline (reference
        # retrieval_eval_variants.py:31-153; significance is advertised in
        # the reference README.md:82 but implemented only here)
        from mmrp_tpu_torch.eval.retrieval_eval import variant_eval
        from mmrp_tpu_torch.labels import LABEL_COLS
        from mmrp_tpu_torch.retrieval.rerank import Reranker
        from mmrp_tpu_torch.serve.runner import load_rerank_inputs

        labels_by_id, kg_kwargs = {}, {}
        if args.run_dir:
            labels_by_id, _, kg_kwargs = load_rerank_inputs(
                args.run_dir, data_dir=args.data
            )

        def factory(a, b, c):
            return Reranker(alpha=a, beta=b, gamma=c,
                            labels_by_id=labels_by_id,
                            label_names=LABEL_COLS, **kg_kwargs)

        res["variants"] = variant_eval(
            test_eng, q_embs, q_ids, gt_test, factory, k=args.k,
            out_path=str(Path(args.out) / "variants.json"),
        )
    print(json.dumps(res, indent=1))
    return 0


def cmd_parity(args) -> int:
    from mmrp_tpu_torch.eval.parity import run_parity

    rep = run_parity(args.data, args.run_dir, out_dir=args.out, k=args.k,
                     explain_queries=args.explain_n, device=args.device)
    out = args.out or str(Path(args.run_dir) / "parity")
    print(json.dumps(
        {"report": str(Path(out) / "PARITY_RESULTS.md"),
         "n_test": rep["n_test"], "wall_s": rep["wall_s"]}, indent=1))
    return 0


def cmd_kg_probe(args) -> int:
    from mmrp_tpu_torch.eval.kg_probe import full_probe
    from mmrp_tpu_torch.labels import LABEL_COLS

    rep = full_probe(args.kg_dir, LABEL_COLS, out_path=args.out_file)
    print(json.dumps(rep["health"], indent=1))
    return 0


def cmd_mapper(args) -> int:
    from mmrp_tpu_torch.kg.ontology import run_mapper

    written = run_mapper(args.out)
    print(json.dumps(written, indent=1))
    return 0


def cmd_serve(args) -> int:
    from mmrp_tpu_torch.serve.app import serve
    from mmrp_tpu_torch.serve.runner import build_demo_context

    serve(lambda: build_demo_context(args.run_dir, data_dir=args.data, device=args.device),
          port=args.port)
    return 0


def cmd_stream(args) -> int:
    from mmrp_tpu_torch.serve.stream import run_stream

    stats = run_stream(args.run_dir, args.data, split=args.split,
                       out_dir=args.out_dir, K=args.k,
                       batch_size=args.batch_size, device=args.device)
    print(json.dumps(stats, indent=1))
    return 0


def cmd_calibrate(args) -> int:
    """Post-training activation calibration for serve_quant="int8_static":
    run the trained Swin tower over real preprocessed DICOMs from the run's
    records cache and write the per-block abs-max artifact that
    build_demo_context picks up (serve/runner.py). The port's
    ``calibrate_swin_act_amax`` takes the Swin encoder itself and runs it in
    f32 on its device, with no kernel."""
    import numpy as np

    from mmrp_tpu_torch.models.quant_calib import calibrate_swin_act_amax, save_act_amax
    from mmrp_tpu_torch.serve.runner import build_demo_context

    ctx = build_demo_context(args.run_dir, data_dir=args.data, device=args.device)
    predictor, pp = ctx["predictor"], ctx["preprocessor"]
    encoder = getattr(predictor.model.backbones, "swin", None)
    if encoder is None:
        print("run's model has no Swin tower — nothing to calibrate",
              file=sys.stderr)
        return 2
    recs = [r for r in ctx["records_by_id"].values() if r.get("dicom_path")]
    recs = recs[: args.n]
    if not recs:
        print("no records with dicom_path in records_cache.json — run "
              "`cli data` first (or pass --data)", file=sys.stderr)
        return 2
    images = np.stack([
        np.transpose(pp.load(r["dicom_path"]), (1, 2, 0)) for r in recs
    ]).astype(np.float32)
    amax = calibrate_swin_act_amax(encoder, images, batch_size=args.batch_size)
    out = args.out or str(Path(args.run_dir) / "swin_act_amax.json")
    save_act_amax(out, amax)
    print(json.dumps({"artifact": out, "blocks": len(amax),
                      "images": len(recs)}))
    return 0


def _not_ported(what: str, item: str) -> int:
    print(f"{what} is not ported to mmrp_tpu_torch yet (ROADMAP.md Queue 1 {item})",
          file=sys.stderr)
    return 2


def cmd_export_serving(args) -> int:
    from mmrp_tpu_torch.serve.exported import export_run

    meta = export_run(
        args.run_dir, args.out_path,
        batch_sizes=tuple(int(b) for b in args.batches.split(",")),
        platforms=tuple(args.platforms.split(",")),
        data_dir=args.data,
    )
    print(json.dumps({"artifact": args.out_path, **meta}, indent=1))
    return 0


def cmd_bench(args) -> int:
    return _not_ported("bench (the port's benchmark, mmrp_tpu_torch/bench.py)", "item 1")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mmrp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("data", help="run the data pipeline")
    p.add_argument("--xml-dir", required=True)
    p.add_argument("--dicom-dir", required=True)
    p.add_argument("--seed", type=int, default=2709)
    _add_common(p)
    p.set_defaults(fn=cmd_data)

    p = sub.add_parser("train", help="staged training pipeline")
    p.add_argument("--data", required=True, help="data pipeline output dir")
    p.add_argument("--resume", action="store_true",
                   help="resume the joint stage from its last full-state ckpt")
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval-cls", help="classification eval")
    p.add_argument("--probs", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--thresholds", default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_eval_cls)

    p = sub.add_parser("eval-ret", help="retrieval eval (dual gallery)")
    p.add_argument("--test-emb", required=True)
    p.add_argument("--test-ids", required=True)
    p.add_argument("--train-emb", required=True)
    p.add_argument("--train-ids", required=True)
    p.add_argument("--gt-test", required=True)
    p.add_argument("--gt-train", required=True)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--data", default=None,
                   help="data pipeline output dir (records_cache.json) for "
                        "the reranker's label-overlap term; defaults to the "
                        "run dir's parent")
    p.add_argument("--variants", action="store_true",
                   help="also run reranker ablations + paired significance")
    p.add_argument("--run-dir", default=None,
                   help="trained run dir supplying reranker inputs (labels/KG)")
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_eval_ret)

    p = sub.add_parser(
        "parity",
        help="run the reference's FULL eval protocol (classification + "
             "dual-gallery retrieval + variants/significance + explain "
             "alignment + diversity + KG probes) and write "
             "PARITY_RESULTS.md",
    )
    p.add_argument("--data", required=True,
                   help="data pipeline output dir (records_cache.json)")
    p.add_argument("--run-dir", required=True, help="trained run dir")
    p.add_argument("--out", default=None,
                   help="report dir (default: <run-dir>/parity)")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--explain-n", type=int, default=8,
                   help="queries for the explain-alignment/diversity pass")
    _add_device(p)
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("kg-probe", help="KG embedding health checks")
    p.add_argument("--kg-dir", required=True)
    p.add_argument("--out-file", default=None)
    p.set_defaults(fn=cmd_kg_probe)

    p = sub.add_parser("mapper", help="label -> ontology mapping runner")
    p.add_argument("--out", default="runs/ontology")
    p.set_defaults(fn=cmd_mapper)

    p = sub.add_parser("serve", help="web demo")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--data", default=None,
                   help="data pipeline output dir (records_cache.json); "
                        "defaults to the run dir's parent")
    p.add_argument("--port", type=int, default=8000)
    _add_device(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "stream",
        help="streaming embed+retrieve+predict over a split (high batch)")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--data", required=True, help="data pipeline output dir")
    p.add_argument("--split", default="test")
    p.add_argument("--out-dir", default=None)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=None)
    _add_device(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser(
        "calibrate",
        help="int8_static activation calibration over run DICOMs "
             "(writes swin_act_amax.json into the run dir)",
    )
    p.add_argument("--run-dir", required=True)
    p.add_argument("--data", default=None, help="data pipeline output dir")
    p.add_argument("-n", type=int, default=64, help="calibration images")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="artifact path (default RUN/swin_act_amax.json)")
    _add_device(p)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser(
        "export-serving",
        help="package a trained run into a serialized serving artifact "
             "(torch.export; loading needs the op library, no model code)",
    )
    p.add_argument("--run-dir", required=True)
    p.add_argument("--out-path", required=True, help="artifact .npz path")
    p.add_argument("--data", default=None, help="data pipeline output dir")
    p.add_argument("--batches", default="1,8,32", help="batch buckets")
    p.add_argument("--platforms", default="cuda",
                   help="comma list of cuda (the kernels, traced on the card: the "
                        "default, where JAX's is cpu) and cpu (the plain versions)")
    p.set_defaults(fn=cmd_export_serving)

    p = sub.add_parser("bench", help="benchmark (not ported: exits 2, ROADMAP.md Queue 1 item 1)")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
