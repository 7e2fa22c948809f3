"""What every cell shares: finding its files by name, building the program's
model from a configuration file, and the context a driver runs in.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the widths, the source, ``assumed`` and
  ``reduced``, and ``program``, how the port's own entry point
  (``MultiModalConfig.from_config``) builds the model;
- ``traffic/<traffic>.json``: the generator's parameters and ``driver``,
  the name of the file in ``drivers/`` that drives the entry point the
  window times;
- ``metrics/<metric>.py``: a reader, ``read(data) -> float | None``;
- ``vision/<kind>.py``: a vision tower's widths as the program holds them,
  its work and weight bytes, and its plain reference, for the configuration
  files whose ``vision.kind`` it is;
- ``limits/<workload>.json``: the limit of every number the check compares.

A configuration file's ``program.config`` is the port's ``Config`` as it is
run, its serving precision (``serve_quant``) and calibration paths
included; nothing the harness does changes a key of it. The file's
``control`` block names the keys its control sets instead
(``run.py``'s docstring: the control).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: Mapping, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: Mapping, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits_file(cell: str, base: Path = HERE) -> dict:
    return load_json(base / "limits" / f"{cell}.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE):
    return _module(base / "drivers" / f"{name}.py", f"mmrp_bench_driver_{name}")


def metric_reader(name: str, base: Path = HERE) -> Callable[[Mapping], Optional[float]]:
    return _module(base / "metrics" / f"{name}.py", f"mmrp_bench_metric_{name}").read


@functools.lru_cache(maxsize=None)
def vision_kind(kind: str, base: Path = HERE):
    """The file of a configuration's ``vision.kind``."""
    return _module(base / "vision" / f"{kind}.py", f"mmrp_bench_vision_{kind}")


@dataclass
class Ctx:
    """One run of one cell."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = "cuda"
    t_start: float = field(default_factory=time.perf_counter)
    variant: Optional[str] = None  # None, or "control": the configuration's control
    log: Callable[[str], None] = print

    def phase(self, name: str) -> None:
        """Logs the seconds since the process started, at the end of a phase
        of set-up."""
        self.log(f"set-up: {name} at {time.perf_counter() - self.t_start:.3f} s")


# --- the program's model ---------------------------------------------------

def _replace(obj, key: str, value):
    head, _, rest = key.partition(".")
    if rest:
        return dataclasses.replace(obj, **{head: _replace(getattr(obj, head), rest, value)})
    if isinstance(getattr(obj, head), tuple):
        value = tuple(value)
    return dataclasses.replace(obj, **{head: value})


def _resolve(keys: Mapping) -> dict:
    """The ``*_path`` keys of a program block, relative to the checkout."""
    return {k: str(ROOT / v) if k.endswith("_path") and v and not Path(v).is_absolute() else v
            for k, v in keys.items()}


def program_keys(cfg: Mapping, variant: Optional[str] = None) -> dict:
    """The port's ``Config`` keys of the configuration file: ``program.config``
    as it stands, or with the keys of the file's ``control.program`` for the
    control."""
    keys = dict(cfg["program"]["config"])
    if variant == "control":
        keys.update(cfg["control"]["program"])
    elif variant is not None:
        raise ValueError(f"unknown variant {variant!r}")
    return _resolve(keys)


PRECISION = ("quant", "text.quant", "swin.quant", "swin.act_amax")


def program_config(cfg: Mapping, overrides: Optional[Mapping] = None,
                   variant: Optional[str] = None):
    """The ``MultiModalConfig`` the port's ``from_config`` builds from the
    configuration file's program keys (:func:`program_keys`), with
    ``overrides`` (dotted fields of it and of its ``swin`` / ``text`` parts)
    applied, checked against the file's widths. An override may name no key
    of the program block and change no precision (:data:`PRECISION`): those
    are the file's."""
    from mmrp_tpu_torch.config import Config
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig

    prog = cfg["program"]
    keys = program_keys(cfg, variant)
    mc = MultiModalConfig.from_config(Config(**keys), num_classes=cfg["num_classes"],
                                      flagship=prog["flagship"])
    overrides = {**prog.get("overrides", {}), **(overrides or {})}
    clash = sorted(k for k in overrides if k.split(".")[0] in keys or k in PRECISION)
    if clash:
        raise ValueError(f"overrides {clash} would change keys the configuration file sets")
    for key, value in overrides.items():
        mc = _replace(mc, key, value)
    check_widths(cfg, mc)
    return mc


def check_widths(cfg: Mapping, mc) -> None:
    v, t, f = cfg["vision"], cfg["text"], cfg["fusion"]
    kind = vision_kind(v["kind"])
    got = {**{f"vision.{k}": x for k, x in kind.program_widths(mc).items()},
           "text.vocab_size": mc.text.vocab_size, "text.hidden_dim": mc.text.hidden_dim,
           "text.num_layers": mc.text.num_layers, "text.num_heads": mc.text.num_heads,
           "text.intermediate_dim": mc.text.intermediate_dim,
           "text.max_positions": mc.text.max_positions,
           "fusion.joint_dim": mc.joint_dim, "fusion.num_fusion_layers": mc.num_fusion_layers,
           "fusion.num_heads": mc.num_heads, "fusion.max_text_len": mc.max_text_len,
           "num_classes": mc.num_classes}
    want = {**{f"vision.{k}": v[k] for k in kind.KEYS},
            **{f"text.{k}": t[k] for k in ("vocab_size", "hidden_dim", "num_layers",
                                           "num_heads", "intermediate_dim", "max_positions")},
            **{f"fusion.{k}": f[k] for k in ("joint_dim", "num_fusion_layers", "num_heads",
                                             "max_text_len")},
            "num_classes": cfg["num_classes"]}
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"the program's model differs from the configuration file: {bad}")


def dtype_of(name: str):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def schema(model) -> List[Tuple[str, Tuple[int, ...], Any]]:
    return [(n, tuple(p.shape), p.dtype) for n, p in model.named_parameters()]


def build_model(ctx: Ctx, overrides: Optional[Mapping] = None):
    """The port's model of the configuration, in its served dtype on the
    device, holding the benchmark's weights for the seed. Returns (model,
    weights): the weights as the benchmark made them, in the served type."""
    import torch

    from mmrp_bench import gen
    from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel

    mc = program_config(ctx.config, overrides, ctx.variant)
    model = MultiModalRetrievalModel(mc, dtype=dtype_of(ctx.config["serve_dtype"]),
                                     device=ctx.device)
    w = gen.weights(schema(model), ctx.seed, ctx.device)
    missing, unexpected = model.load_state_dict(w, strict=False)
    params = dict(model.named_parameters())
    if unexpected or any(k in params for k in missing):
        raise RuntimeError(f"weights do not fit the model: {missing} {unexpected}")
    if mc.quant != "none":  # the program's own int8 caches, from the weights it now holds
        from mmrp_tpu_torch.models.quant_calib import build_quant_cache

        build_quant_cache(model)
    model.eval()
    if ctx.device != "cpu" and torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    return model, w
