"""Settings of the joint train step and of the served model.

Counterpart of the fields of ``mmrp_tpu/config.py::Config`` that
``train/joint.py``, ``train/state.py`` and ``MultiModalConfig.from_config``
read, under the same names and defaults. Loading a YAML file is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Config:
    lr: float = 2e-5
    seed: int = 2709
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
    augment: bool = False

    def __post_init__(self):
        if self.augment:
            raise NotImplementedError(
                "augment=True needs ops/preprocess.py::augment_batch, which is not ported "
                "(ROADMAP.md Queue 1 item 5)")
