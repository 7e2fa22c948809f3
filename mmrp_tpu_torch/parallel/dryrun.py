"""The multi-rank dry run, and the launcher of rank processes.

``dryrun_multichip(n)`` is the port's ``__graft_entry__.py::
dryrun_multichip``: it starts ``n`` fresh processes (``start_ranks``), one NCCL
rank per card when ``n`` cards are present, else gloo ranks on the CPU, and
each runs JAX's sections on JAX's tiny configs over a ``dp x tp`` mesh
(``n / 2 x 2`` when ``n`` >= 4 and even, else ``dp``):

1. the data-parallel train step with the masters placed by the
   tensor-parallel rules (``parallel/mesh.py::shard_state``): a finite loss;
2. the int8 serving forward (W8A8 fusion stack and text tower) on each
   rank's rows: finite;
3. sharded-gallery retrieval: the query's own id excluded from its top 5;
   with ``MMRP_DRYRUN_SECTIONS=boot`` the run stops here, as JAX's does;
4. entity-sharded KG evaluation (51 entities, which the ranks do not
   divide) against ``KGTrainer.evaluate``: MRR within 1e-6;
5. with a ``tp`` axis, the mid-size forward (joint 256, 128-wide text),
   rows sharded over ``dp``, the text FFNs and the classifier head
   tensor-parallel over ``tp`` on the placed blocks (``parallel/mesh.py::
   tensor_parallel``: a column- and a row-parallel GEMM and one all-reduce
   each; the kernel call sites take whole weights), against the whole batch
   on one rank without it: f32 within 2e-4, bf16 within 5% of the largest
   logit; the rules must have sharded ``cls_hidden``, the fusion FFN's
   ``Dense_0`` and the text FFN's ``ffn_in``;
6. the data-parallel step with the core on (``core_kernel=True``), dropout
   0, against ``make_train_step`` on the whole batch: loss within 1e-4.

A failed section raises in its rank, naming the section, and the launcher
raises with that rank's error. Run it with
``python -c "from mmrp_tpu_torch.parallel.dryrun import dryrun_multichip;
dryrun_multichip(4)"`` or ``python -m mmrp_tpu_torch.parallel.dryrun 4``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
_RESULT = "MMRP_RANK_RESULT "


def free_port() -> int:
    """A TCP port on localhost that the OS reports free."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


class Ranks:
    """Rank processes started by ``start_ranks``; ``wait`` collects them
    while the caller may have worked beside them."""

    def __init__(self, procs, files, target: str, timeout_s: float):
        self.procs, self.files, self.target, self.timeout_s = procs, files, target, timeout_s
        self.deadline = time.monotonic() + timeout_s + 60

    def wait(self) -> List[Any]:
        def text(f):
            f.seek(0)
            return f.read().decode("utf-8", "replace")

        n, outs = len(self.procs), []
        try:
            for rank, p in enumerate(self.procs):
                try:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"rank {rank} of {n} ({self.target}) passed "
                                       f"{self.timeout_s:.0f} s")
            failed = [(rank, p.returncode, *(text(f) for f in self.files[rank]))
                      for rank, p in enumerate(self.procs) if p.returncode != 0]
            if failed:  # every failed rank: the first to fail takes the others down
                raise RuntimeError(f"ranks of {n} ({self.target}) failed:\n" + "\n".join(
                    f"-- rank {rank} exited {rc}:\n{out[-1500:]}\n{err[-4000:]}"
                    for rank, rc, out, err in failed))
            outs = [text(f[0]) for f in self.files]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for pair in self.files:
                for f in pair:
                    f.close()
        results = []
        for rank, out in enumerate(outs):
            lines = [ln for ln in out.splitlines() if ln.startswith(_RESULT)]
            if not lines:
                raise RuntimeError(f"rank {rank} of {n} ({self.target}) returned nothing:\n"
                                   f"{out[-2000:]}")
            results.append(json.loads(lines[-1][len(_RESULT):]))
        return results


def start_ranks(n: int, target: str, kwargs: Optional[Dict[str, Any]] = None,
                backend: str = "gloo", timeout_s: float = 600.0,
                sys_path: Sequence[str] = (), threads: Optional[int] = None) -> Ranks:
    """Start ``target`` (``"module:function"``) in ``n`` fresh interpreters,
    ranks 0..n-1 of one process group over ``backend`` on a free localhost
    port, each calling ``function(**kwargs)`` once the group has started;
    ``.wait()`` returns each rank's return value (JSON). A rank that fails,
    or a run that passes ``timeout_s``, kills every rank and raises."""
    port = free_port()
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join([str(REPO), *sys_path,
                                           os.environ.get("PYTHONPATH", "")]))
    procs, files = [], []
    for rank in range(n):
        spec = dict(target=target, kwargs=kwargs or {}, rank=rank, world=n, port=port,
                    backend=backend, timeout_s=timeout_s, threads=threads,
                    sys_path=list(sys_path))
        # output to files, not pipes: a rank blocked on a full pipe would
        # stall the others in their next collective
        files.append((tempfile.TemporaryFile(), tempfile.TemporaryFile()))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mmrp_tpu_torch.parallel.dryrun", "--worker",
             json.dumps(spec)], cwd=str(REPO), env=env, stdout=files[-1][0],
            stderr=files[-1][1]))
    return Ranks(procs, files, target, timeout_s)


def _worker(spec: Dict[str, Any]) -> None:
    import torch
    import torch.distributed as dist

    from mmrp_tpu_torch.parallel.collectives import initialize_distributed

    sys.path[:0] = spec["sys_path"]
    torch.set_num_threads(spec["threads"])
    initialize_distributed(f"localhost:{spec['port']}", spec["world"], spec["rank"],
                           cpu_collectives="gloo" if spec["backend"] == "gloo" else None,
                           timeout_s=spec["timeout_s"])
    try:
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(**spec["kwargs"])
        print(_RESULT + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, backend: Optional[str] = None,
                     timeout_s: float = 900.0) -> Dict[str, Any]:
    """The dry run (module docstring) over ``n_devices`` ranks; prints and
    returns rank 0's summary. ``backend``: "nccl" (one rank per card, which
    needs that many cards) or "gloo" (CPU ranks); by default NCCL when the
    machine has ``n_devices`` cards, else gloo."""
    import torch

    if backend is None:
        backend = ("nccl" if torch.cuda.is_available() and
                   torch.cuda.device_count() >= n_devices else "gloo")
    sections = os.environ.get("MMRP_DRYRUN_SECTIONS", "all")
    res = start_ranks(n_devices, "mmrp_tpu_torch.parallel.dryrun:dryrun_rank",
                      {"sections": sections}, backend=backend, timeout_s=timeout_s).wait()
    print(res[0]["line"])
    return res[0]


def example_batch(B: int, img: int, L: int, vocab: int, num_classes: int = 43,
                  kg_dim: Optional[int] = None, seed: int = 0) -> Dict[str, np.ndarray]:
    """``__graft_entry__.py::_example_batch``: the dry run's seeded batch."""
    rng = np.random.default_rng(seed)
    batch = {
        "image": rng.random((B, img, img, 3), dtype=np.float32),
        "input_ids": rng.integers(0, vocab, (B, L)).astype(np.int32),
        "attention_mask": np.ones((B, L), dtype=np.int32),
        "labels": (rng.random((B, num_classes)) < 0.1).astype(np.float32),
        "valid": np.ones((B,), dtype=np.float32),
    }
    if kg_dim:
        batch["kg_target"] = rng.standard_normal((B, kg_dim)).astype(np.float32)
        batch["kg_target_valid"] = np.ones((B,), dtype=np.float32)
    return batch


@contextlib.contextmanager
def _section(name: str):
    try:
        yield
    except Exception as e:  # noqa: BLE001 - re-raised with the section's name
        raise RuntimeError(f"dryrun_multichip section {name!r} failed: {e}") from e


def dryrun_rank(sections: str = "all") -> Dict[str, Any]:
    """One rank of the dry run (module docstring)."""
    import torch
    import torch.distributed as dist

    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.kg.sharded_eval import evaluate_sharded
    from mmrp_tpu_torch.kg.trainer import KGTrainer, KGTrainerConfig
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
    from mmrp_tpu_torch.models.swin import SwinConfig
    from mmrp_tpu_torch.models.text_encoder import TextConfig
    from mmrp_tpu_torch.parallel import mesh as M
    from mmrp_tpu_torch.parallel.collectives import all_gather_cat
    from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine
    from mmrp_tpu_torch.train.joint import init_train_state, make_train_step, make_train_step_dp
    from mmrp_tpu_torch.train.pipeline import device_batch
    from mmrp_tpu_torch.utils.convert import init_params

    n = dist.get_world_size()
    if n >= 4 and n % 2 == 0:
        mesh = M.build_mesh(("dp", "tp"), (n // 2, 2))
    else:
        mesh = M.build_mesh(("dp",), (n,))
    dp = M.axis_size(mesh, "dp")
    dev = M.mesh_device(mesh)
    group = M.axis_group(mesh, "dp")
    f32 = torch.float32

    def rows(batch):  # this rank's rows, as a train step takes them
        return device_batch({k: M.rows_of(v, mesh, "dp") for k, v in batch.items()}, dev)

    def gathered(t):
        return all_gather_cat(t, group)

    def forward(model, batch):  # the serving routes' deterministic forward
        with torch.inference_mode():
            return model(*(torch.as_tensor(batch[k]).to(dev) if k == "image" else
                           torch.as_tensor(batch[k]).long().to(dev)
                           for k in ("image", "input_ids", "attention_mask")))

    swin = SwinConfig(img_size=56, embed_dim=16, depths=(2, 1), num_heads=(2, 2), window_size=7)
    text = TextConfig.small(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=2,
                            intermediate_dim=64, max_positions=64)
    mm_cfg = MultiModalConfig(swin=swin, text=text, joint_dim=32, num_fusion_layers=2,
                              num_heads=4, num_classes=43, max_text_len=16)
    cfg = Config(batch_size=2 * dp, epochs=1)
    kg_dim = 24

    with _section("train step, tensor-parallel masters"):
        model = MultiModalRetrievalModel(mm_cfg, dtype=f32, device=dev)
        init_params(model, seed=0)
        batch_np = example_batch(2 * dp, 56, 16, 512, kg_dim=kg_dim, seed=3)
        state = init_train_state(model, cfg, seed=0, total_steps=100, kg_dim=kg_dim)
        M.shard_state(state, mesh, model)
        step = make_train_step_dp(model, cfg, mesh, pos_weight=np.ones(43, np.float32))
        state, metrics = step(state, rows(batch_np))
        loss = metrics["loss/total"]
        assert np.isfinite(loss), f"non-finite loss {loss}"

    with _section("int8 forward"):
        q_cfg = dataclasses.replace(mm_cfg, quant="int8",
                                    text=dataclasses.replace(text, quant="int8"))
        q_model = MultiModalRetrievalModel(q_cfg, dtype=f32, device=dev)
        q_model.load_state_dict(model.state_dict())
        q_out = forward(q_model, {k: M.rows_of(v, mesh, "dp") for k, v in batch_np.items()})
        assert torch.isfinite(q_out["joint_emb"]).all(), "non-finite int8 joint_emb"

    with _section("sharded retrieval"):
        gallery = np.random.default_rng(0).standard_normal((64 * dp, 32)).astype(np.float32)
        ids = [f"g{i}" for i in range(gallery.shape[0])]
        eng = RetrievalEngine(gallery, ids, mesh=mesh, shard_axis="dp")
        hits = eng.retrieve(gallery[3], K=5, query_id="g3")
        assert len(hits) == 5 and hits[0][0] != "g3", hits

    shape = dict(M.mesh_shape(mesh))
    if sections == "boot":
        line = (f"[dryrun_multichip] n={n} mesh={shape} loss={loss:.4f} "
                f"retrieval_top1={hits[0][0]} sections=boot OK")
        return {"line": line, "loss": loss, "top1": hits[0][0], "mesh": shape}

    with _section("entity-sharded KG evaluation"):
        kg_rng = np.random.default_rng(1)
        triples = np.unique(np.stack([kg_rng.integers(0, 51, 160), kg_rng.integers(0, 4, 160),
                                      kg_rng.integers(0, 51, 160)], axis=1).astype(np.int32),
                            axis=0)
        tr = KGTrainer(51, 4, KGTrainerConfig(model="TransE", emb_dim=12, eval_chunk=16),
                       device=dev)
        tr.load_triples([tuple(t) for t in triples])
        kg_ref = tr.evaluate(tr.val_arr)
        kg_got = evaluate_sharded(tr, tr.val_arr, mesh, axis="dp")
        assert abs(kg_got["mrr"] - kg_ref["mrr"]) < 1e-6, (kg_got, kg_ref)

    tp_checked, tp_line = False, "tp_numerics=n/a"
    if "tp" in shape and shape["tp"] > 1:
        with _section("mid-size tensor-parallel forward"):
            from torch.distributed.tensor import Shard

            mid_cfg = MultiModalConfig(
                swin=SwinConfig(img_size=56, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                                window_size=7, drop_path_rate=0.0, dropout=0.0),
                text=TextConfig.small(vocab_size=512, hidden_dim=128, num_layers=2,
                                      num_heads=4, intermediate_dim=512, max_positions=64,
                                      dropout=0.0),
                joint_dim=256, num_fusion_layers=2, num_heads=8, num_classes=43,
                max_text_len=16, dropout=0.0, drop_path=0.0)
            mb = example_batch(2 * dp, 56, 16, 512, seed=5)
            mb_rows = {k: M.rows_of(v, mesh, "dp") for k, v in mb.items()}
            tp_dim = list(shape).index("tp")
            worst = {}
            for dtype, tol in ((f32, None), (torch.bfloat16, 0.05)):
                ref_model = MultiModalRetrievalModel(mid_cfg, dtype=dtype, device=dev)
                init_params(ref_model, seed=1)
                ref = forward(ref_model, mb)["logits"].float()
                placed = M.shard_params(dict(ref_model.named_parameters()), mesh, ref_model)
                for name in ("cls_hidden.weight", "fusion_layer0.ffn.Dense_0.weight",
                             "backbones.text.layer0.ffn_in.weight"):  # Flax P(None, "tp")
                    got_pl = getattr(placed[name], "placements", None)
                    assert got_pl is not None and got_pl[tp_dim] == Shard(0), (name, got_pl)
                # whole weights for the kernel call sites; the text FFNs and the
                # classifier head column- and row-parallel on the placed blocks
                sh_model = MultiModalRetrievalModel(mid_cfg, dtype=dtype, device=dev)
                sh_model.load_state_dict({k: M.whole(v) for k, v in placed.items()},
                                         strict=False)
                with M.tensor_parallel(sh_model, placed, mesh) as tp_gemms:
                    got = gathered(forward(sh_model, mb_rows)["logits"].float())
                want_gemms = mid_cfg.text.num_layers + 1
                assert tp_gemms == {"column": want_gemms, "row": want_gemms}, tp_gemms
                err = float((got - ref).abs().max())
                if tol is None:
                    assert torch.allclose(got, ref, rtol=2e-4, atol=2e-4), err
                else:
                    scale = max(float(ref.abs().max()), 1.0)
                    assert err / scale < tol, ("bf16 tensor-parallel forward", err, scale)
                worst[str(dtype).split(".")[-1]] = err
            tp_checked = True
            tp_line = ("tp_numerics=ok(" + ", ".join(f"{k} d{v:.1e}" for k, v in worst.items())
                       + ")")

    with _section("data-parallel step, core on"):
        dp_mesh = M.build_mesh(("dp",), (n,))
        d0_cfg = dataclasses.replace(
            mm_cfg, dropout=0.0, drop_path=0.0,
            swin=dataclasses.replace(swin, drop_path_rate=0.0, dropout=0.0),
            text=dataclasses.replace(text, dropout=0.0))
        d0_np = example_batch(2 * n, 56, 16, 512, kg_dim=kg_dim, seed=7)
        m_plain = MultiModalRetrievalModel(d0_cfg, dtype=f32, device=dev)
        m_dp = MultiModalRetrievalModel(d0_cfg, dtype=f32, device=dev)
        for m in (m_plain, m_dp):
            init_params(m, seed=2)
        s_plain = init_train_state(m_plain, cfg, seed=2, total_steps=100, kg_dim=kg_dim)
        s_dp = init_train_state(m_dp, cfg, seed=2, total_steps=100, kg_dim=kg_dim)
        _, met_plain = make_train_step(m_plain, cfg)(s_plain, device_batch(d0_np, dev))
        _, met_dp = make_train_step_dp(m_dp, cfg, dp_mesh, core_kernel=True)(
            s_dp, device_batch({k: M.rows_of(v, dp_mesh, "dp") for k, v in d0_np.items()},
                               dev))
        dp_core_diff = abs(met_dp["loss/total"] - met_plain["loss/total"])
        assert dp_core_diff < 1e-4, ("data-parallel core step loss diverged",
                                     met_dp["loss/total"], met_plain["loss/total"])

    line = (f"[dryrun_multichip] n={n} mesh={shape} loss={loss:.4f} "
            f"retrieval_top1={hits[0][0]} kg_mrr={kg_got['mrr']:.4f} "
            f"{tp_line} dp_core=ok(d{dp_core_diff:.1e}) OK")
    return {"line": line, "loss": loss, "top1": hits[0][0], "mesh": shape,
            "kg_mrr": kg_got["mrr"], "kg_mrr_ref": kg_ref["mrr"], "tp_checked": tp_checked,
            "tp_worst": worst if tp_checked else None,
            "dp_core_diff": dp_core_diff}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(json.loads(sys.argv[2]))
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
