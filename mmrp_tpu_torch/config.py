"""Settings of the served model and of the training pipeline.

Counterpart of the fields of ``mmrp_tpu/config.py::Config`` that
``MultiModalConfig.from_config``, ``train/`` (the joint step, the Swin
finetune, the staged runner), ``kg/``, ``serve/runner.py`` and
``serve/stream.py`` read, under the same names, defaults and validation, and
its derived ``run_name``, with the device mesh's ``mesh_shape`` and
``parse_mesh_shape`` (``parallel/mesh.py`` builds the mesh). The benchmark's
text length, which belongs to the port's benchmark, and the fields no code
reads (``gallery_shard_axis``, ``fusion_type``, ``project_name``) are left out.
:meth:`Config.load` reads the JAX package's flat YAML files
(``configs/config.yaml``) without PyYAML, and :func:`dump_flat_yaml` writes
one that both packages' ``Config.load`` read (a run directory's
``config.yaml``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import asdict, dataclass, fields
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class Config:
    # training (train/pipeline.py)
    epochs: int = 50
    patience: int = 10
    lr: float = 2e-5
    seed: int = 2709
    data_workers: int = 4  # host decode threads + prefetch
    # the model (MultiModalConfig.from_config)
    num_fusion_layers: int = 5
    # swin | swin_small | swin_tiny | swin_micro | medclip (a Swin-Tiny) | vit | resnet50 |
    # efficientnet
    image_backbone: str = "swin"
    modality: str = "multimodal"  # multimodal | image | text
    joint_dim: int = 1024
    num_heads: int = 8
    text_dim: int = 512  # longest text sequence
    use_shared_ffn: bool = False  # one FFN shared by the fusion layers (their plain routes)
    use_cls_only: bool = False  # each fusion layer pools its first token
    image_size: int = 224
    use_pallas_attention: bool = True  # False: every Swin step on its plain version
    remat_backbone: bool = False  # activation checkpointing of the towers in training
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
    # the knowledge graph (kg/): model, embedding training, CompGCN settings
    kg_model: str = "TransE"  # TransE | TransH | RotatE | CompGCN
    kg_emb_dim: int = 300
    kg_epochs: int = 30
    kg_mode: str = "hybrid"  # dataset | ontology | hybrid
    kg_neg_size: int = 32
    kg_adv_temp: float = 0.1
    kg_use_amp: bool = True  # bf16 scoring in KG training on the card
    kg_lr: float = 1e-3
    kg_num_layers: int = 2
    kg_dropout: float = 0.3
    kg_opn: str = "corr"  # sub | mult | corr
    # the LabelAttention head (kg/label_attention.py)
    la_hidden_dim: int = 256
    la_batch_size: int = 128
    la_epochs: int = 30
    la_lr: float = 5e-4
    la_patience: int = 5
    la_ice_weight: float = 1.0
    la_tpl_weight: float = 0.5
    la_bce_weight: float = 0.1
    # the staged pipeline (train/runner.py)
    run_swin_finetune: bool = True
    swin_finetune_epochs: int = 12
    swin_finetune_lr: float = 1e-4
    run_label_attention: bool = True
    # pretrained bootstrap (train/runner.py, models/port.py): a BERT vocab.txt,
    # required with pretrained_bert; HF BERT / Swin checkpoints as local files
    # or directories (.bin / .pt / .pth / .safetensors)
    pretrained_vocab: str = ""
    pretrained_bert: str = ""
    pretrained_swin: str = ""
    resume: bool = False  # resume the joint stage from its last full-state checkpoint
    pos_weight_clamp_max: float = 1.0
    # the Swin routes of the train-time model (eval and dumps): False sends
    # every Swin step to its plain version, as JAX's default sends it to XLA
    train_use_pallas_attention: bool = False
    adam_mu_bf16: bool = True  # Adam's first moment stored in bf16
    augment: bool = False  # on-device rotation / flip of the train step's images
    batch_size: int = 32  # the batch of a stream (serve/stream.py::run_stream)
    # the galleries of eval/parity.py: exact (gallery.py's top-K) | dls
    # (retrieval/dls.py, the reference's walk)
    retrieval_backend: str = "exact"
    # the reranker's weights of embedding cosine, label Jaccard and KG cosine
    rerank_alpha: float = 0.6
    rerank_beta: float = 0.25
    rerank_gamma: float = 0.15
    # bf16 | f32: serve/runner.py serves bf16 on the card, where no kernel
    # takes f32 (it refuses "f32" there), and f32 on the CPU
    dtype_policy: str = "bf16"
    # the device mesh: "auto" (every device on "dp") | "dp=8" | "dp=4,tp=2" ...
    # (parse_mesh_shape)
    mesh_shape: str = "auto"

    def __post_init__(self):
        if not (isinstance(self.lr, (int, float)) and self.lr >= 0.0):
            raise ValueError(f"lr must be non-negative, got {self.lr!r}")
        if not (isinstance(self.batch_size, int) and self.batch_size > 0):
            raise ValueError(f"batch_size must be > 0, got {self.batch_size!r}")
        if not (isinstance(self.epochs, int) and self.epochs > 0):
            raise ValueError(f"epochs must be > 0, got {self.epochs!r}")
        if not (isinstance(self.temperature, (int, float)) and self.temperature > 0.0):
            raise ValueError(f"temperature must be > 0, got {self.temperature!r}")
        if self.modality not in ("multimodal", "image", "text"):
            raise ValueError(f"invalid modality: {self.modality!r}")
        if self.kg_model not in ("TransE", "TransH", "RotatE", "CompGCN"):
            raise ValueError(f"invalid kg_model: {self.kg_model!r}")
        if self.kg_mode not in ("dataset", "ontology", "hybrid"):
            raise ValueError(f"invalid kg_mode: {self.kg_mode!r}")
        if self.kg_opn not in ("sub", "mult", "corr"):
            raise ValueError(f"invalid kg_opn: {self.kg_opn!r}")
        if self.dtype_policy not in ("bf16", "f32"):
            raise ValueError(f"invalid dtype_policy: {self.dtype_policy!r}")
        if self.retrieval_backend not in ("exact", "dls"):
            raise ValueError(f"invalid retrieval_backend: {self.retrieval_backend!r}")
        if self.pretrained_bert and not self.pretrained_vocab:
            raise ValueError(
                "pretrained_bert requires pretrained_vocab: the corpus-trained "
                "WordPiece ids are incompatible with a ported embedding table")

    @property
    def run_name(self) -> str:
        """The JAX ``Config.run_name`` over this config's fields: the loss
        method, the KG model (and CompGCN's composition), then every other
        field as ``name=value`` (floats ``%.0e`` for learning rates, else
        ``%.4f``)."""
        method = ("hybrid(bce_focal)" if self.use_hybrid else
                  "focal" if self.use_focal else "bce")
        parts = [f"method={method}", f"kg_model={self.kg_model}"]
        if self.kg_model == "CompGCN":
            parts.append(f"kg_opn={self.kg_opn}")
        for fld in fields(self):
            if fld.name in ("kg_model", "kg_opn"):
                continue
            v = getattr(self, fld.name)
            if isinstance(v, float):
                parts.append(f"{fld.name}={v:.0e}" if "lr" in fld.name
                             else f"{fld.name}={v:.4f}")
            else:
                parts.append(f"{fld.name}={v}")
        return "_".join(parts)

    def parse_mesh_shape(self, n_devices: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
        """Resolve ``mesh_shape`` into (axis_names, axis_sizes) for n_devices."""
        if self.mesh_shape == "auto":
            return ("dp",), (n_devices,)
        names, sizes = [], []
        for part in self.mesh_shape.split(","):
            k, _, v = part.partition("=")
            names.append(k.strip())
            sizes.append(int(v))
        total = 1
        for s in sizes:
            total *= s
        if total != n_devices:
            raise ValueError(
                f"mesh_shape {self.mesh_shape!r} wants {total} devices, have {n_devices}")
        return tuple(names), tuple(sizes)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

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
    if len(text) >= 2 and text[0] == text[-1] == '"':
        try:
            return json.loads(text)
        except ValueError:
            return text[1:-1]
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    low = text.lower()
    if low in (".inf", "+.inf", "-.inf", ".nan"):
        return float(low.replace(".", ""))
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


def _yaml_scalar(value: Any) -> str:
    """One value as a YAML 1.1 scalar that ``yaml.safe_load`` and
    :func:`_scalar` read back as the same Python value."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mant, e, exp = text.partition("e")
        if e and "." not in mant:  # YAML 1.1 reads a float only with a dot
            text = f"{mant}.0e{exp}"
        return text
    return json.dumps(str(value))


def dump_flat_yaml(values: Mapping[str, Any], path: str) -> None:
    """``key: value`` lines, one per entry, in order: the flat YAML that
    :func:`parse_flat_yaml` here and PyYAML (the JAX ``Config.load``) read
    back to the same values (strings double-quoted, floats with a dot)."""
    lines = [f"{key}: {_yaml_scalar(val)}" for key, val in values.items()]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
