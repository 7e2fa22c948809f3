"""Structured metric logging + run tracking.

Copy of ``mmrp_tpu/utils/logging.py``: a JSONL metric stream and a
run-config snapshot per run directory (``MetricWriter``, with an optional
wandb passthrough where the package exists), ``TeeLogger`` (print + append
to a report file) and ``StepTimer`` (per-step wall clock, moving average,
ETA). Metric names keep the JAX namespaces (swin/, kg/, la/, val/).
:func:`start_profiler` / :func:`stop_profiler` trace with
``torch.profiler`` (CPU and, where there is one, the card) and write a
Chrome trace into the log directory.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional


class MetricWriter:
    def __init__(self, run_dir: str, run_name: str = "", config: Optional[Mapping] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / "metrics.jsonl"
        self._fh = self.path.open("a", encoding="utf-8")
        self._step = 0
        self._wandb = None
        if config is not None:
            (self.run_dir / "run_config.json").write_text(
                json.dumps({"run_name": run_name, **dict(config)}, indent=1, default=str)
            )
        try:  # optional passthrough; absent in this environment
            import wandb  # type: ignore

            if os.environ.get("WANDB_MODE", "disabled") != "disabled":
                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "mmrp-tpu"),
                    name=run_name or None,
                    config=dict(config or {}),
                )
        except ImportError:
            pass

    def log(self, metrics: Mapping[str, Any], step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class TeeLogger:
    """Print + append to a report file (reference log_and_print,
    helper.py:614-626)."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, msg: str) -> None:
        print(msg)
        with self.path.open("a", encoding="utf-8") as fh:
            fh.write(msg + "\n")


class StepTimer:
    """Per-step wall-clock timing with moving average + ETA — the reference's
    KG batch timers (KG_Trainer.py:534-537, 651-696) generalized."""

    def __init__(self, total_steps: int, alpha: float = 0.1):
        self.total = total_steps
        self.alpha = alpha
        self.avg = None
        self._last = None
        self.done = 0

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            dt = now - self._last
            self.avg = dt if self.avg is None else (1 - self.alpha) * self.avg + self.alpha * dt
            self.done += 1
            out = {
                "step_time_s": dt,
                "avg_step_time_s": self.avg,
                "eta_s": max(self.total - self.done, 0) * self.avg,
            }
        self._last = now
        return out


_PROFILE: Dict[str, Any] = {}


def start_profiler(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the CPU and, where there is one,
    the card; :func:`stop_profiler` writes it to ``log_dir/trace.json``."""
    import torch

    if _PROFILE:
        raise RuntimeError("a profiler trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _PROFILE.update(prof=prof, dir=log_dir)


def stop_profiler() -> None:
    prof = _PROFILE.pop("prof")
    prof.__exit__(None, None, None)
    out = Path(_PROFILE.pop("dir"))
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
