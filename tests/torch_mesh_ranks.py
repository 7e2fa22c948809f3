"""Rank programs of the port's multi-rank tests (test_torch_mesh.py,
test_torch_sharded.py, test_torch_train_dp.py).

``mmrp_tpu_torch.parallel.dryrun.start_ranks`` starts each function here in
fresh interpreters, ranks of one gloo group on the CPU; each function runs
every port-side check of its test module once and returns JSON (arrays go
to npz files under ``out``, written by rank 0). Nothing here imports JAX:
the test modules hold the results against JAX in the pytest process.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from mmrp_tpu_torch.parallel import mesh as M


def placements_str(placements) -> list:
    """("R" | "S<dim>") per mesh dimension."""
    return [f"S{p.dim}" if hasattr(p, "dim") else "R" for p in placements]


def micro_mm_config(**text_kw):
    """``__graft_entry__.py::dryrun_multichip``'s model."""
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig

    text = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=2, intermediate_dim=64,
                max_positions=64)
    text.update(text_kw)
    return MultiModalConfig(
        swin=SwinConfig(img_size=56, embed_dim=16, depths=(2, 1), num_heads=(2, 2), window_size=7),
        text=TextConfig.small(**text), joint_dim=32, num_fusion_layers=2, num_heads=4,
        num_classes=43, max_text_len=16)


# -- test_torch_mesh.py: 4 ranks -------------------------------------------------

def mesh_checks(values: list) -> dict:
    """Placements of the dry run's model (text FFN 63 wide: no 2-way split)
    on a dp mesh and a dp=2,tp=2 mesh, the meshes' shapes and errors, and
    ``mean_over_mesh`` of ``values`` on both."""
    from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
    from mmrp_tpu_torch.parallel.collectives import make_metric_psum, mean_over_mesh

    model = MultiModalRetrievalModel(micro_mm_config(intermediate_dim=63), device="meta")
    params = dict(model.named_parameters())  # the placements read names and shapes
    out = {"shapes": {}, "placements": {}, "mean": {}}
    for label, names, sizes in (("dp", ("dp",), None), ("dp_tp", ("dp", "tp"), (-1, 2))):
        mesh = M.build_mesh(names, sizes)
        out["shapes"][label] = str(M.mesh_shape(mesh))
        out["placements"][label] = {k: placements_str(v) for k, v in
                                    M.param_shardings(params, mesh, model).items()}
        out["mean"][label] = mean_over_mesh(mesh, np.asarray(values, np.float32))
        v = torch.arange(4.0) + dist.get_rank()
        s, c = make_metric_psum(mesh, "dp")(v, torch.ones(4))
        out.setdefault("psum", {})[label] = [float(s), float(c)]
    try:
        M.build_mesh(("dp",), (3,))
    except ValueError as e:
        out["error"] = str(e)
    # a placed master: its block on this rank, whole again after the gather
    mesh = M.build_mesh(("dp", "tp"), (2, 2))
    w = torch.randn(params["cls_hidden.weight"].shape,
                    generator=torch.Generator().manual_seed(0))  # the same on every rank
    placed = M.shard_params({"cls_hidden.weight": w}, mesh, model)["cls_hidden.weight"]
    out["block_shape"] = list(M.local(placed).shape)
    out["whole_equal"] = bool(torch.equal(M.whole(placed), w))
    return out


# -- test_torch_sharded.py: 2 ranks -----------------------------------------------

def sharded_checks(out: str) -> dict:
    """Top-K (make_sharded_topk and the engine), entity-sharded KG eval for
    the four models, the stream and the artifact on a 2-rank mesh, each with
    its single-device counterpart."""
    from mmrp_tpu_torch.kg.sharded_eval import evaluate_sharded
    from mmrp_tpu_torch.kg.trainer import KGTrainer, KGTrainerConfig
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine, make_sharded_topk

    outp = Path(out)
    mesh = M.build_mesh(("dp",))
    main = dist.get_rank() == 0
    res: dict = {}
    arrays: dict = {}

    # top-K over a gallery of duplicated rows that two shards do not divide
    z = np.load(outp / "topk_inputs.npz")
    gallery, queries = z["gallery"], z["queries"]
    padded = np.concatenate([gallery, np.zeros((1, gallery.shape[1]), np.float32)])
    g_shard = torch.from_numpy(M.rows_of(padded, mesh, "dp").copy())
    for k in (5, 25, 37):
        s, i = make_sharded_topk(mesh, "dp", k, n_real=len(gallery))(torch.from_numpy(queries),
                                                                    g_shard)
        arrays[f"topk_s{k}"], arrays[f"topk_i{k}"] = s.numpy(), i.numpy()
    ids = [f"g{i}" for i in range(len(gallery))]
    eng = RetrievalEngine(gallery, ids, mesh=mesh)
    single = RetrievalEngine(gallery, ids, device="cpu")
    for k in (5, 37):
        for label, e in (("mesh", eng), ("single", single)):
            s, i = e.retrieve_batch(queries, k=k)
            arrays[f"eng_{label}_s{k}"], arrays[f"eng_{label}_i{k}"] = s, i
    res["retrieve"] = eng.retrieve(gallery[3], K=5, query_id="g3")

    # entity-sharded KG evaluation: JAX's parameters, written by the test
    kg = json.loads((outp / "kg.json").read_text())
    res["kg"] = {}
    for name, spec in kg.items():
        tr = KGTrainer(spec["E"], spec["R"], KGTrainerConfig(**spec["cfg"]), device="cpu")
        tr.load_triples([tuple(t) for t in spec["triples"]])
        with np.load(outp / f"kg_{name}.npz") as p:
            tr.params = {k: torch.from_numpy(p[k]) for k in p.files}
        first = evaluate_sharded(tr, tr.val_arr, mesh)
        res["kg"][name] = {"sharded": first, "single": tr.evaluate(tr.val_arr),
                           "again": evaluate_sharded(tr, tr.val_arr, mesh)}
    res["stream"] = _stream_checks(mesh, arrays)
    res["artifact"] = _artifact_checks(mesh, outp, arrays)
    if main:
        np.savez(outp / "sharded_out.npz", **arrays)
    return res


def _serving_model():
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig
    from mmrp_tpu_torch.utils.convert import init_params

    model = MultiModalRetrievalModel(MultiModalConfig(
        swin=SwinConfig.micro(), text=TextConfig.small(), joint_dim=32, num_fusion_layers=1,
        num_heads=2, num_classes=7, max_text_len=12), device="cpu").eval()
    init_params(model, seed=4)
    return model


def _requests(n, seed, uint8=False):
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 256, (n, 28, 28)).astype(np.uint8) if uint8 else
           rng.random((n, 28, 28, 3)).astype(np.float32))
    ids = rng.integers(0, 8192, (n, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < rng.integers(4, 13, (n, 1))).astype(np.int32)
    return img, ids, mask


def _stream_checks(mesh, arrays) -> dict:
    """``StreamingPipeline`` over 3 batches of 4 (uint8 and f32 images, a
    padded row) with the mesh and a sharded gallery, and without either."""
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
    from mmrp_tpu_torch.serve.stream import StreamingPipeline

    model = _serving_model()
    gallery = np.random.default_rng(5).standard_normal((41, 32)).astype(np.float32)
    ids = [f"g{i}" for i in range(41)]

    def batches():
        for b in range(3):
            img, tok, mask = _requests(4, 10 + b, uint8=b == 1)
            yield {"image": img, "input_ids": tok, "attention_mask": mask,
                   "valid": np.array([1, 1, 1, 0 if b == 2 else 1], np.float32),
                   "ids": [f"r{b}_{j}" for j in range(4)]}

    labels = [f"c{j}" for j in range(7)]
    out = {}
    for label, m, eng in (("mesh", mesh, RetrievalEngine(gallery, ids, mesh=mesh)),
                          ("single", None, RetrievalEngine(gallery, ids, device="cpu"))):
        pipe = StreamingPipeline(model, eng, labels, threshold=0.5, K=5, mesh=m)
        rows = list(pipe.run(batches(), depth=2))
        arrays[f"stream_{label}_probs"] = np.concatenate([r["probs"] for r in rows])
        arrays[f"stream_{label}_emb"] = np.concatenate([r["joint_emb"] for r in rows])
        out[label] = {"ids": [r["ids"] for r in rows], "predicted": [r["predicted"] for r in rows],
                      "retrieval": [r["retrieval"] for r in rows], "mesh": pipe.stats["mesh"]}
    return out


def _artifact_checks(mesh, outp: Path, arrays) -> dict:
    """A data-parallel cpu artifact at bucket 4 (2 rows a rank), written by
    rank 0 and loaded by both, against the single-device result (the live
    ``serving_forward``, which the single-device artifact equals:
    ``tests/test_torch_exported.py``) at n = 3 and 6 (chunked), and its
    refusals."""
    from mmrp_tpu_torch.api import serving_forward
    from mmrp_tpu_torch.serve import exported as EX

    model = _serving_model()
    kw = dict(image_size=28, text_len=12, batch_sizes=(4,), platforms=("cpu",))
    path = outp / "dp.npz"
    if dist.get_rank() == 0:
        EX.save_artifact(path, EX.export_serving_programs(model, mesh=mesh, **kw),
                         EX.serving_state(model), {})
    dist.barrier()
    pred = EX.ExportedPredictor.load(path, platform="cpu", mesh=mesh)
    live = serving_forward(model)
    for n in (3, 6):
        img, tok, mask = _requests(n, 20 + n)
        for key, v in pred.call(img, tok, mask).items():
            arrays[f"art_mesh_{n}_{key}"] = v
        with torch.inference_mode():
            for key, v in live(torch.from_numpy(img), torch.from_numpy(tok).long(),
                               torch.from_numpy(mask).long()).items():
                arrays[f"art_single_{n}_{key}"] = v.numpy()
    res = {}
    with np.load(path) as z:
        res["keys"] = sorted(k.split("::", 1)[1] for k in z.files if k.startswith("prog::"))
    try:
        EX.ExportedPredictor.load(path, platform="cpu")
    except ValueError as e:
        res["unmeshed_error"] = str(e)
    try:
        EX.export_serving_programs(model, mesh=mesh, **dict(kw, batch_sizes=(3,)))
    except ValueError as e:
        res["bucket_error"] = str(e)
    return res


# -- test_torch_train_dp.py: 2 ranks ----------------------------------------------

def train_dp_checks(out: str) -> dict:
    """``make_train_step_dp`` from JAX's weights (``params_{kg}.npz``) on
    ``batch_{kg}.npz``, with and without kg_dim: two steps on a 2-rank
    mesh, and two of ``make_train_step`` on the whole batch; then a third dp
    step."""
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step, make_train_step_dp
    from mmrp_tpu_torch.train.pipeline import device_batch
    from mmrp_tpu_torch.utils.convert import load_flax_params

    outp = Path(out)
    mesh = M.build_mesh(("dp",))
    main = dist.get_rank() == 0
    cfg = Config(lr=1e-3, batch_size=16)
    mm = MultiModalConfig(
        swin=SwinConfig(img_size=28, embed_dim=16, depths=(1,), num_heads=(2,), window_size=7,
                        drop_path_rate=0.0),
        text=TextConfig.small(vocab_size=64, hidden_dim=16, num_layers=1, num_heads=2,
                              intermediate_dim=32, max_positions=16, dropout=0.0),
        joint_dim=16, num_fusion_layers=1, num_heads=2, num_classes=43, max_text_len=8,
        dropout=0.0, drop_path=0.0)
    res = {}
    for tag in ("nokg", "kg"):
        kg_dim = 12 if tag == "kg" else None
        with np.load(outp / f"batch_{tag}.npz") as z:
            batch = {k: z[k] for k in z.files}
        arrays, metrics = {}, {}
        for label in ("dp", "plain"):
            model = MultiModalRetrievalModel(mm, device="cpu")
            extra = load_flax_params(model, str(outp / f"params_{tag}.npz"))
            state = init_train_state(model, cfg, total_steps=50, kg_dim=kg_dim)
            if kg_dim:
                state.params["kg_proj"].copy_(extra["kg_proj"])
            if label == "dp":
                step = make_train_step_dp(model, cfg, mesh, core_kernel=False)
                rows = device_batch({k: M.rows_of(v, mesh) for k, v in batch.items()}, "cpu")
            else:
                step = make_train_step(model, cfg)
                rows = device_batch(batch, "cpu")
            grads = {}
            state.tx = _SpyTx(state.tx, grads)
            for i in (1, 2):  # the first update's rate is 0 (warmup), the second's is not
                state, m = step(state, rows)
                arrays.update({f"grad_{label}{i}/{k}": v for k, v in grads.items()})
                metrics[f"{label}{i}"] = m
                arrays.update({f"{label}{i}/{k}": v.numpy().copy()
                               for k, v in state.params.items()})
            if label == "dp":  # one more step: the masters move, the loss stays finite
                first = {k: torch.from_numpy(arrays[f"dp1/{k}"]) for k in state.params}
                state, m = step(state, rows)
                res[f"{tag}_moved"] = max(float((state.params[k] - first[k]).abs().max())
                                          for k in first)
                res[f"{tag}_loss3"] = m["loss/total"]
        res[tag] = metrics
        if main:
            np.savez(outp / f"out_{tag}.npz", **arrays)
    res["pipeline"] = _pipeline_checks(mm, outp)
    return res


class _SpyTx:
    """An optimizer that keeps the gradients each update takes."""

    def __init__(self, tx, grads: dict):
        self.tx, self.grads = tx, grads

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def apply(self, state, grads, **kw):
        self.grads.update({k: v.detach().float().numpy().copy() for k, v in grads.items()})
        return self.tx.apply(state, grads, **kw)


class _Killed(Exception):
    """A run stopped from outside between two steps."""


class _Loader:
    """What ``run_joint_training`` reads of a loader: batches, ``len``,
    ``ds.records`` (the labels' pos_weight) and ``_epoch``."""

    def __init__(self, batches, records):
        self.batches, self.ds, self._epoch = batches, type("DS", (), {"records": records}), 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _pipeline_checks(mm, outp: Path) -> dict:
    """``run_joint_training`` on a dp=1, tp=2 mesh (both ranks run the whole
    batch; the masters of the TP rules are DTensor blocks) for 2 epochs, the
    same run killed after epoch 0 and resumed under the mesh, and (rank 0)
    the run without a mesh: rank 0 writes ``pipeline.npz`` (each run's
    returned masters and thresholds) and lists the files each run wrote."""
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
    from mmrp_tpu_torch.train import joint
    from mmrp_tpu_torch.train.pipeline import run_joint_training

    rng = np.random.default_rng(21)

    def batches(n, first):
        out = []
        for b in range(n):
            out.append({"image": rng.random((4, 28, 28, 3)).astype(np.float32),
                        "input_ids": rng.integers(0, 64, (4, 8)).astype(np.int32),
                        "attention_mask": np.ones((4, 8), np.int32),
                        "labels": (rng.random((4, 43)) < 0.3).astype(np.float32),
                        "valid": np.array([1, 1, 1, 0 if b == n - 1 else 1], np.float32),
                        "ids": [f"r{first + 4 * b + j}" for j in range(4)]})
        return out

    train, val = batches(3, 0), batches(2, 100)
    records = [{"labels": row} for b in train for row in b["labels"]]
    mesh = M.build_mesh(("dp", "tp"), (1, 2))
    cfg = Config(epochs=2, patience=10, lr=1e-3, seed=5, batch_size=4)
    labels = ["mesh", "resumed"] + (["single"] if dist.get_rank() == 0 else [])
    arrays, files = {}, {}
    for label in labels:
        m = None if label == "single" else mesh
        out = outp / f"pipe_{label}"
        if label == "resumed":  # killed in epoch 1's first step, after epoch 0's checkpoint
            real = joint.make_train_step_dp

            def killed(*a, **kw):
                step, n = real(*a, **kw), [0]

                def run(state, batch):
                    n[0] += 1
                    if n[0] > len(train):
                        raise _Killed
                    return step(state, batch)
                return run

            joint.make_train_step_dp = killed
            try:
                run_joint_training(cfg, MultiModalRetrievalModel(mm, device="cpu"),
                                   _Loader(train, records), _Loader(val, []), str(out), mesh=m)
            except _Killed:
                pass
            finally:
                joint.make_train_step_dp = real
            c = cfg.replace(resume=True)
        else:
            c = cfg
        res = run_joint_training(c, MultiModalRetrievalModel(mm, device="cpu"),
                                 _Loader(train, records), _Loader(val, []), str(out), mesh=m)
        arrays.update({f"{label}/{k}": v.numpy().copy() for k, v in res.state.params.items()})
        arrays[f"{label}/thresholds"] = res.thresholds
        files[label] = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
    if dist.get_rank() == 0:
        np.savez(outp / "pipeline.npz", **arrays)
    return {"files": files}
