"""MedCLIP's vision tower (Wang et al. 2022, arXiv:2210.10163): a Swin
tower, then one bias-free projection to ``proj_dim`` applied to the patches
and to the pooled vector. For a configuration file whose ``vision.kind`` is
``medclip``; what each name gives is in ``swin.py``."""

from __future__ import annotations

from typing import Mapping

from mmrp_bench.vision import swin

KEYS = swin.KEYS + ("proj_dim",)
PREFIX = "backbones.medclip"


def program_widths(mc) -> dict:
    from mmrp_tpu_torch.models.multimodal import vision_dims

    return {**swin.program_widths(mc), "proj_dim": vision_dims(mc)[1]}


def out(v: Mapping):
    patches, _ = swin.out(v)
    return patches, v["proj_dim"]


def flops(v: Mapping) -> int:
    patches, width = swin.out(v)
    return swin.flops(v) + 2 * (patches + 1) * width * v["proj_dim"]


def param_bytes(v: Mapping, dtype_bytes: int = 2) -> int:
    return swin.param_bytes(v, dtype_bytes) + swin.features(v) * v["proj_dim"] * dtype_bytes


def reference(ref, image):
    patches, glob = ref.swin(image, f"{PREFIX}.swin")
    proj = f"{PREFIX}.projection"
    return ref.lin(patches, proj, bias=False), ref.lin(glob, proj, bias=False)
