"""Training settings of the joint step.

Counterpart of the fields of ``mmrp_tpu/config.py::Config`` that
``train/joint.py`` and ``train/state.py`` read, under the same names and
defaults. Loading a YAML file is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    lr: float = 2e-5
    seed: int = 2709
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
