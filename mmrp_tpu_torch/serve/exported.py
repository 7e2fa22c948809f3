"""Portable serialized serving programs (torch.export): deployment packaging.

Counterpart of ``mmrp_tpu/serve/exported.py``: the serving forward
(``api.py::serving_forward``, the function the live predictor runs) is traced
with ``torch.export``, serialized together with the model's parameters,
buffers and int8 weight caches and a JSON ``meta`` into ONE ``.npz`` file, and
loaded anywhere without model code: ``ExportedPredictor.load`` and ``call``
import the op registrations (``mmrp_tpu_torch.ops``) and nothing of
``mmrp_tpu_torch.models``, ``train`` or ``serve.runner``.

- **Bucketed batches**: one program per batch bucket (default 1/8/32); the
  loader pads a request up to the smallest bucket that fits (padded mask
  rows are ones, as JAX pads them), chunks an oversize request through the
  largest bucket, and trims the outputs.
- **Per-platform programs**: ``cuda`` programs are traced on the card, where
  every wrapper calls its kernel's op (``torch.ops.mmrp.*``,
  ``ops/_build.py::kernel_op``), so the loaded program launches the
  hand-written kernels, counted as the live path counts them; ``cpu``
  programs hold each wrapper's plain version in aten ops. The default is
  ``cuda``, as every entry point of the port runs on the card unless asked
  otherwise (JAX's default is ``cpu``). Exporting ``cuda`` without a card
  raises: a ``cuda`` key never holds a plain-version program. ``tpu``
  raises.
- **Data-parallel programs**: with a one-axis ``mesh`` (``parallel/
  mesh.py``) each bucket's program is traced at the per-rank batch
  (bucket / mesh size; buckets the size does not divide are refused, as
  JAX refuses them) and its key records the replica count,
  ``{platform}::{batch}::{replicas}``. ``ExportedPredictor.load`` refuses a
  multi-replica artifact without a mesh, and a mesh of another size; under a
  mesh every rank calls ``call`` with the whole request, runs its block of
  the padded rows and all-gathers the outputs.
- **Weights once**: a program takes the model's state (parameters and
  buffers by name) as its first input, as JAX's takes ``params``; the file
  holds each tensor once under ``p::<name>`` whatever the number of
  programs, and the loader puts each on the device once for all buckets.
  numpy has no bfloat16: such tensors are stored as their 16-bit patterns,
  with the dtypes in the ``dtypes`` entry.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

import mmrp_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)

_SEP = "::"  # artifact key namespacing, as JAX's
PLATFORMS = ("cuda", "cpu")
OUTPUTS = ["probs", "joint_emb", "img_emb", "txt_emb"]


def serving_state(model) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers (int8 caches and ``bias_full``
    included) by name: the first input of every serving program."""
    return {**{k: v.detach() for k, v in model.named_parameters()},
            **{k: v for k, v in model.named_buffers()}}


class _Serving(torch.nn.Module):
    """``serving_forward(model)`` as a module."""

    def __init__(self, model):
        from mmrp_tpu_torch.api import serving_forward

        super().__init__()
        self.model = model
        self.fwd = serving_forward(model)  # ONE definition with the live predictor

    def forward(self, image, ids, mask):
        return self.fwd(image, ids, mask)


class _Program(torch.nn.Module):
    """The serving forward as a function of the model's state,
    ``forward(state, image, ids, mask)``. The model is no submodule of it,
    so that the exported program owns no copy of the state."""

    def __init__(self, model):
        super().__init__()
        self._serving = (_Serving(model),)

    def forward(self, state, image, ids, mask):
        return torch.func.functional_call(
            self._serving[0], {f"model.{k}": v for k, v in state.items()}, (image, ids, mask))


def _mesh_size(mesh) -> int:
    """The size of a one-axis mesh (JAX's ``(axis,) = mesh.axis_names``)."""
    if len(mesh.mesh_dim_names) != 1:
        raise ValueError(f"a data-parallel artifact takes a one-axis mesh, not "
                         f"{mesh.mesh_dim_names}")
    return int(mesh.size())


def _check_platforms(platforms: Sequence[str]) -> None:
    for plat in platforms:
        if plat not in PLATFORMS:
            raise ValueError(f"platform {plat!r}: the port exports {list(PLATFORMS)} "
                             "programs (no TPU)")


def export_serving_programs(model, *, image_size: int, text_len: int,
                            batch_sizes: Sequence[int] = (1, 8, 32),
                            platforms: Sequence[str] = ("cuda",),
                            mesh=None) -> Dict[str, bytes]:
    """Trace and serialize the serving forward per (platform, batch bucket):
    ``{"{platform}::{batch}": bytes}``. A ``cuda`` program needs the model
    on the card (bf16, the kernels' precision); a ``cpu`` program is traced
    on CPU stand-ins of the same state, dtypes included, so that both
    platforms take the one state the artifact stores. ``mesh``: one program
    per bucket at the per-rank batch, keyed ``{platform}::{batch}::{replicas}``
    (module docstring)."""
    _check_platforms(platforms)
    replicas = 1 if mesh is None else _mesh_size(mesh)
    if mesh is not None:
        bad = [b for b in batch_sizes if b % replicas]
        if bad:
            raise ValueError(f"batch buckets {bad} not divisible by mesh size {replicas}")
    state = serving_state(model)
    prog = _Program(model)
    out: Dict[str, bytes] = {}
    for plat in platforms:
        if plat == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("export for 'cuda': no CUDA device here "
                                   "(torch.cuda.is_available() is false)")
            if any(t.device.type != "cuda" for t in state.values()):
                raise ValueError("export for 'cuda': build the model on the card")
            dev = next(iter(state.values())).device
            example = state
        else:
            dev = torch.device("cpu")
            example = {k: v if v.device.type == "cpu" else torch.empty_like(v, device=dev)
                       for k, v in state.items()}
        for b in sorted(set(int(x) for x in batch_sizes)):
            rows = b // replicas
            args = (example, torch.zeros((rows, image_size, image_size, 3), device=dev),
                    torch.zeros((rows, text_len), dtype=torch.long, device=dev),
                    torch.ones((rows, text_len), dtype=torch.long, device=dev))
            ep = torch.export.export(prog, args, strict=False)
            ep._example_inputs = None  # the state is stored once, beside the programs
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            key = f"{plat}{_SEP}{b}" + ("" if mesh is None else f"{_SEP}{replicas}")
            out[key] = buf.getvalue()
    return out


def save_artifact(path, programs: Dict[str, bytes], state: Dict[str, torch.Tensor],
                  meta: Dict[str, Any]) -> None:
    """One-file artifact: programs + state + metadata."""
    arrays: Dict[str, np.ndarray] = {
        f"prog{_SEP}{k}": np.frombuffer(v, dtype=np.uint8) for k, v in programs.items()}
    dtypes = {}
    for k, v in state.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            v = v.view(torch.int16)
        arrays[f"p{_SEP}{k}"] = v.numpy()
    arrays["dtypes"] = np.frombuffer(json.dumps(dtypes).encode("utf-8"), dtype=np.uint8)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = Path(str(path) + ".tmp.npz")
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    tmp.replace(path)


def _json(z, key: str):
    return json.loads(bytes(z[key].tobytes()).decode("utf-8"))


def _check_replicas(replicas, mesh) -> None:
    if set(replicas) - {1} and mesh is None:
        raise ValueError(f"artifact programs span {sorted(replicas)} devices — pass a "
                         "same-size mesh to load()")
    if mesh is not None and set(replicas) != {_mesh_size(mesh)}:
        raise ValueError(f"mesh size {_mesh_size(mesh)} does not match the artifact's "
                         f"program device count {sorted(replicas)}")


class ExportedPredictor:
    """Load an artifact and serve embed + predict without any model code.

    ``call`` pads the request to the smallest batch bucket that fits (the
    largest bucket, chunked, for oversize requests) and trims the outputs
    back to the true row count."""

    def __init__(self, programs, state, meta, device: torch.device, replicas=frozenset({1}),
                 mesh=None):
        self._programs = programs  # {batch: callable(state, image, ids, mask)}
        self._state = state
        self.meta = meta
        self.device = device
        self.batch_sizes = sorted(programs)
        self._mesh = mesh
        _check_replicas(replicas, mesh)

    @classmethod
    def load(cls, path, platform: Optional[str] = None, mesh=None) -> "ExportedPredictor":
        """The programs of ``platform`` (default ``cuda``; ``cpu`` runs the
        plain versions) and the state on its device, once for all buckets;
        with ``mesh``, on this rank's device (the mesh's)."""
        plat = platform or "cuda"
        _check_platforms((plat,))
        if plat == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ExportedPredictor.load: no CUDA device here "
                               "(torch.cuda.is_available() is false); pass platform='cpu' "
                               "for an artifact with cpu programs")
        with np.load(path, allow_pickle=False) as z:
            meta = _json(z, "meta")
            dtypes = _json(z, "dtypes")
            arrays, blobs = {}, {}
            for k in z.files:
                if k.startswith(f"p{_SEP}"):
                    arrays[k[len(f"p{_SEP}"):]] = z[k]
                elif k.startswith(f"prog{_SEP}"):
                    blobs[k[len(f"prog{_SEP}"):]] = z[k].tobytes()
        avail = sorted({k.split(_SEP)[0] for k in blobs})
        matching = {k: v for k, v in blobs.items() if plat in k.split(_SEP)[0].split("+")}
        if not matching:
            raise ValueError(f"artifact has no programs for platform {plat!r} "
                             f"(available: {avail}); re-export with --platforms {plat}")
        # "{platform}::{batch}[::{replicas}]"
        replicas = {int(k.split(_SEP)[2]) if k.count(_SEP) == 2 else 1 for k in matching}
        _check_replicas(replicas, mesh)  # before anything is deserialized
        dev = torch.device(plat)
        if mesh is not None:
            from mmrp_tpu_torch.parallel.mesh import mesh_device

            dev = mesh_device(mesh)
            if dev.type != plat:
                raise ValueError(f"platform {plat!r} on a mesh of {dev.type} devices")
        state = {}
        for k, a in arrays.items():
            t = torch.from_numpy(a)
            if dtypes.get(k) == "bfloat16":
                t = t.view(torch.bfloat16)
            state[k] = t.to(dev)
        programs = {int(k.split(_SEP)[1]): torch.export.load(io.BytesIO(v)).module()
                    for k, v in matching.items()}
        return cls(programs, state, meta, dev, replicas, mesh)

    def _run_bucket(self, b: int, image, ids, mask) -> Dict[str, np.ndarray]:
        n = image.shape[0]
        pad = b - n
        if pad:
            image = np.concatenate([image, np.zeros((pad,) + image.shape[1:], image.dtype)])
            ids = np.concatenate([ids, np.zeros((pad,) + ids.shape[1:], ids.dtype)])
            mask = np.concatenate([mask, np.ones((pad,) + mask.shape[1:], mask.dtype)])
        dev = self.device
        if self._mesh is not None:  # this rank's block of the padded rows
            from mmrp_tpu_torch.parallel.mesh import rows_of

            axis = self._mesh.mesh_dim_names[0]
            image, ids, mask = (rows_of(x, self._mesh, axis) for x in (image, ids, mask))
        with torch.inference_mode():
            outs = self._programs[b](self._state, torch.from_numpy(image).to(dev),
                                     torch.from_numpy(ids).to(dev),
                                     torch.from_numpy(mask).to(dev))
            if self._mesh is not None:
                outs = {k: self._gather(v) for k, v in outs.items()}
        return {k: v.float().cpu().numpy()[:n] for k, v in outs.items()}

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order."""
        from mmrp_tpu_torch.parallel.collectives import all_gather_cat

        return all_gather_cat(t, self._mesh.get_group())

    def call(self, image, ids, mask) -> Dict[str, np.ndarray]:
        image = np.asarray(image, np.float32)
        ids = np.asarray(ids, np.int64)
        mask = np.asarray(mask, np.int64)
        n = image.shape[0]
        fit = [b for b in self.batch_sizes if b >= n]
        if fit:
            return self._run_bucket(fit[0], image, ids, mask)
        # oversize request: chunk through the largest bucket
        b = self.batch_sizes[-1]
        parts = [self._run_bucket(b, image[i:i + b], ids[i:i + b], mask[i:i + b])
                 for i in range(0, n, b)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def run_meta(predictor, batch_sizes: Sequence[int], platforms: Sequence[str]) -> Dict[str, Any]:
    """JAX's ``meta`` of an artifact of ``predictor`` (an ``MMRPredictor``)."""
    cfg = predictor.model.config
    return {
        "label_names": list(predictor.label_names),
        "threshold": np.asarray(predictor.threshold).tolist(),
        "image_size": cfg.swin.img_size,
        "text_len": cfg.max_text_len,
        "batch_sizes": sorted(set(int(b) for b in batch_sizes)),
        "platforms": list(platforms),
        "outputs": list(OUTPUTS),
    }


def export_run(run_dir: str, out_path: str, *, batch_sizes: Sequence[int] = (1, 8, 32),
               platforms: Sequence[str] = ("cuda",),
               data_dir: Optional[str] = None) -> Dict[str, Any]:
    """Package a trained run directory into a serving artifact: the model
    rebuilt as serving builds it (``serve/runner.py::build_demo_context``:
    bf16 on the card when ``cuda`` is asked for, else f32 on the CPU), its
    programs per platform, its state once, JAX's ``meta``."""
    from mmrp_tpu_torch.serve.runner import build_demo_context

    _check_platforms(platforms)
    predictor = build_demo_context(run_dir, data_dir=data_dir,
                                   device="cuda" if "cuda" in platforms else "cpu")["predictor"]
    meta = run_meta(predictor, batch_sizes, platforms)
    programs = export_serving_programs(predictor.model, image_size=meta["image_size"],
                                       text_len=meta["text_len"], batch_sizes=batch_sizes,
                                       platforms=platforms)
    save_artifact(out_path, programs, serving_state(predictor.model), meta)
    return meta
