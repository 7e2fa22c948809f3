"""Checkpointing: full train-state save/restore + best-metric tracking.

Counterpart of ``mmrp_tpu/utils/checkpoint.py`` with its API and layout, in
the port's own format (the card has no orbax):

- :func:`save_param_tree` / :func:`load_param_tree`: a nested dict of arrays
  as one npz of ``/``-joined keys, the form ``utils/convert.py`` writes and
  the JAX package's ``load_param_tree`` reads;
- :class:`CheckpointManager`: ``save(step, state)`` writes
  ``<dir>/steps/<step>/state.pt`` (keeping the newest ``max_to_keep``),
  ``restore`` reads the latest (or a given) step, ``update_best`` writes
  ``<dir>/best/state.pt`` through ``best.tmp`` and a swap so that a crash
  mid-save keeps the previous best, and ``best_metrics.json`` holds the
  best's metrics with ``_best_value``. A state is a flat or nested dict of
  tensors, numpy arrays and Python scalars, stored with ``torch.save`` (CPU
  copies) and read with ``torch.load(weights_only=True)``. A full train state
  of the joint stage (``train/pipeline.py``) holds the f32 masters, Adam's
  ``mu`` / ``nu`` and count, the step generator's seed, and ``step``,
  ``epoch`` and ``bad``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mmrp_tpu_torch.utils.convert import _flatten
from mmrp_tpu_torch.utils.convert import save_param_tree as _save_flat

# the file of one checkpoint inside its directory; serve/runner.py reads a
# run's joint/ckpt/best through it
STATE_FILE = "state.pt"


def save_param_tree(path: str, tree: Mapping[str, Any]) -> None:
    """Nested (or already ``/``-joined flat) dict of arrays -> one npz of
    ``/``-joined keys, written through a temporary file."""
    _save_flat(path, _flatten(tree))


def load_param_tree(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_param_tree`: npz -> nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            d = tree
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[key]
    return tree


def _to_cpu(state: Any) -> Any:
    if isinstance(state, Mapping):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, np.ndarray):
        return torch.from_numpy(np.array(state))
    return state


def _check_like(template: Any, got: Any, path: str = "") -> None:
    """Raise unless ``got`` has the keys, and the tensors the shapes, of
    ``template`` (the JAX restore's template check)."""
    if isinstance(template, Mapping):
        if not isinstance(got, Mapping) or set(template) != set(got):
            keys = sorted(got) if isinstance(got, Mapping) else type(got)
            raise ValueError(f"checkpoint {path or '/'}: keys {keys} != template "
                             f"{sorted(template)}")
        for k in template:
            _check_like(template[k], got[k], f"{path}/{k}")
    elif (isinstance(template, (torch.Tensor, np.ndarray))
          and tuple(template.shape) != tuple(got.shape)):
        raise ValueError(f"checkpoint {path}: shape {tuple(got.shape)} != template "
                         f"{tuple(template.shape)}")


def _write(path: Path, state: Any) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(_to_cpu(state), tmp)
    tmp.replace(path)


def _read(path: Path, template: Any = None) -> Any:
    got = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        _check_like(template, got)
    return got


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.dir = Path(ckpt_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.steps_dir = self.dir / "steps"
        self.max_to_keep = max_to_keep
        self._best_metric: Optional[float] = None
        best_file = self.dir / "best_metrics.json"
        if best_file.exists():
            try:
                self._best_metric = json.loads(best_file.read_text()).get("_best_value")
            except (json.JSONDecodeError, OSError):
                pass

    def _steps(self):
        if not self.steps_dir.exists():
            return []
        return sorted(int(p.name) for p in self.steps_dir.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def save(self, step: int, state: Any) -> None:
        _write(self.steps_dir / str(step) / STATE_FILE, state)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.steps_dir / str(old))

    def restore(self, state_template: Any = None, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default: the latest) as CPU tensors;
        with ``state_template``, its keys and tensor shapes must match."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return _read(self.steps_dir / str(step) / STATE_FILE, state_template)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    # -- best tracking (composite-metric early stopping support) -------------

    def update_best(self, value: float, state: Any, metrics: Dict[str, Any],
                    higher_better: bool = True) -> bool:
        """Save as best when the metric improves; persist the metric payload
        (``best_metrics.json``)."""
        better = (self._best_metric is None
                  or (value > self._best_metric if higher_better else value < self._best_metric))
        if not better:
            return False
        # write-then-swap: the previous best stays on disk (and
        # self._best_metric unchanged) until the new checkpoint is complete
        best_dir = self.dir / "best"
        tmp_dir = self.dir / "best.tmp"
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        _write(tmp_dir / STATE_FILE, state)
        if best_dir.exists():
            shutil.rmtree(best_dir)
        tmp_dir.replace(best_dir)
        (self.dir / "best_metrics.json").write_text(
            json.dumps({"_best_value": value, **metrics}, indent=1, default=float))
        self._best_metric = value
        return True

    def restore_best(self, state_template: Any = None) -> Any:
        return _read(self.dir / "best" / STATE_FILE, state_template)

    def best_metrics(self) -> Optional[Dict[str, Any]]:
        p = self.dir / "best_metrics.json"
        return json.loads(p.read_text()) if p.exists() else None
