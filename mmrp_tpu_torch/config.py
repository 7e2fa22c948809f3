"""Settings of the served model and of the joint train step.

Counterpart of the fields of ``mmrp_tpu/config.py::Config`` that
``MultiModalConfig.from_config``, ``train/joint.py``, ``train/state.py``,
``serve/runner.py`` and ``serve/stream.py`` read, under the same names,
defaults and validation. :meth:`Config.load` reads the JAX
package's flat YAML files (``configs/config.yaml``) without PyYAML.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Config:
    lr: float = 2e-5
    seed: int = 2709
    # the model (MultiModalConfig.from_config)
    num_fusion_layers: int = 5
    image_backbone: str = "swin"  # swin | swin_small | swin_tiny | swin_micro | medclip (a Swin-Tiny)
    modality: str = "multimodal"  # multimodal | image | text
    joint_dim: int = 1024
    num_heads: int = 8
    text_dim: int = 512  # longest text sequence
    use_shared_ffn: bool = False  # not ported: raises where the model is built
    use_cls_only: bool = False  # not ported: raises where the model is built
    image_size: int = 224
    use_pallas_attention: bool = True  # False: every Swin step on its plain version
    remat_backbone: bool = False  # served as any run; the train step raises
    # serving precision (MultiModalConfig.from_config): "none" = bf16; "int8" = W8A8 in the text tower (K3's
    # in-kernel form and the FFN) and the fusion stack; "int8_static" = that
    # and static W8A8 in the Swin whole-block kernels, with the calibrated
    # activation abs-max of swin_act_amax_path (models/quant_calib.py), or
    # per-row activation scales without one. Training is full precision.
    serve_quant: str = "none"
    swin_act_amax_path: Optional[str] = None
    # classification loss: hybrid (1 - focal_ratio) * BCE + focal_ratio * focal
    use_hybrid: bool = True
    use_focal: bool = False
    focal_ratio: float = 0.3
    gamma_focal: float = 1.0
    # contrastive: InfoNCE(img, txt) + w_img * InfoNCE(img, joint) + w_txt * InfoNCE(txt, joint)
    temperature: float = 0.125
    cls_weight: float = 3.0
    cont_weight: float = 0.3
    weight_img_joint: float = 0.5
    weight_text_joint: float = 0.5
    # KG alignment of joint @ kg_proj to per-sample KG vectors: cosine | mse
    kg_weight: float = 0.1
    kg_method: str = "cosine"
    adam_mu_bf16: bool = True  # Adam's first moment stored in bf16
    augment: bool = False  # on-device rotation / flip of the train step's images
    batch_size: int = 32  # the batch of a stream (serve/stream.py::run_stream)
    # the reranker's weights of embedding cosine, label Jaccard and KG cosine
    rerank_alpha: float = 0.6
    rerank_beta: float = 0.25
    rerank_gamma: float = 0.15
    # bf16 | f32: serve/runner.py serves bf16 on the card, where no kernel
    # takes f32 (it refuses "f32" there), and f32 on the CPU
    dtype_policy: str = "bf16"

    def __post_init__(self):
        if not (isinstance(self.batch_size, int) and self.batch_size > 0):
            raise ValueError(f"batch_size must be > 0, got {self.batch_size!r}")
        if self.modality not in ("multimodal", "image", "text"):
            raise ValueError(f"invalid modality: {self.modality!r}")
        if self.dtype_policy not in ("bf16", "f32"):
            raise ValueError(f"invalid dtype_policy: {self.dtype_policy!r}")

    @staticmethod
    def load(path: str) -> "Config":
        """A config file of flat ``key: value`` lines (``#`` comments, quoted
        strings, bools, ints and floats such as ``2.0e-5``), as
        ``mmrp_tpu.config.Config.load`` reads it: values coerced to the field
        types, omitted fields at their defaults, and a warning for every key
        that is not a field here (the JAX package's fields this port does not
        have yet among them)."""
        raw = parse_flat_yaml(path)
        field_map = {f.name: f for f in fields(Config)}
        unknown = sorted(set(raw) - set(field_map))
        if unknown:
            print(f"[WARN] Unknown keys in config file (ignored): {unknown}")
        data: Dict[str, Any] = {}
        used_defaults = []
        for name, fld in field_map.items():
            if name in raw:
                data[name] = _coerce(raw[name], fld.type)
            else:
                used_defaults.append(name)
        if used_defaults:
            print("Using default values for:", ", ".join(used_defaults))
        return Config(**data)


def _coerce(raw: Any, target_type: Any) -> Any:
    """``mmrp_tpu.config._coerce``: a parsed scalar to the annotated field type
    (best effort; a value that does not convert is kept as it is)."""
    if raw is None:
        return None
    target = target_type
    try:
        if target in ("float", float):
            return float(raw)
        if target in ("int", int):
            return int(raw)
        if target in ("bool", bool):
            if isinstance(raw, bool):
                return raw
            if isinstance(raw, str):
                return raw.strip().lower() in ("true", "1", "yes", "y")
            return bool(raw)
        if target in ("str", str):
            return str(raw)
    except (TypeError, ValueError):
        return raw
    return raw


def _scalar(text: str) -> Any:
    """One YAML scalar as ``yaml.safe_load`` reads the forms these files use:
    quoted strings, true / false, null, ints, floats, else a bare string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_flat_yaml(path: str) -> Dict[str, Any]:
    """``key: value`` per line, ``#`` comments (outside quotes) and blank
    lines skipped; a value of its own line is a scalar (:func:`_scalar`)."""
    out: Dict[str, Any] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for n, line in enumerate(fh, 1):
            body, quote = [], None
            for ch in line.rstrip("\n"):
                if quote is None and ch == "#":
                    break
                if ch in "\"'":
                    quote = None if quote == ch else (ch if quote is None else quote)
                body.append(ch)
            text = "".join(body).strip()
            if not text:
                continue
            if line[:1].isspace() or ":" not in text:
                raise ValueError(f"{path}:{n}: expected a flat 'key: value' line, got {line!r}")
            key, _, value = text.partition(":")
            out[key.strip()] = _scalar(value.strip())
    return out
