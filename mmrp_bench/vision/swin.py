"""The Swin vision tower (Liu et al. 2021, arXiv:2103.14030), for a
configuration file whose ``vision.kind`` is ``swin``.

A vision kind is one file here, found by that name. It gives:

- ``KEYS``: the widths of the file's ``vision`` block;
- ``program_widths(mc)``: the same widths as the port's ``MultiModalConfig``
  holds them, checked against the file before a run;
- ``out(v)``: (patches, width) of the tower's output;
- ``flops(v)``: forward FLOPs of one image, 2 per multiply-add, every token
  counted (an image has no padding);
- ``param_bytes(v, dtype_bytes)``: the bytes of the weights one call reads;
- ``reference(ref, image)``: the plain float32 forward, (patches (B, Np, F),
  global (B, F)), on :class:`mmrp_bench.reference.model.Ref`'s primitives.
"""

from __future__ import annotations

from typing import Mapping

KEYS = ("img_size", "patch_size", "in_chans", "embed_dim", "depths", "num_heads",
        "window_size", "mlp_ratio")
PREFIX = "backbones.swin"


def program_widths(mc) -> dict:
    s = mc.swin
    return {"img_size": s.img_size, "patch_size": s.patch_size, "in_chans": s.in_chans,
            "embed_dim": s.embed_dim, "depths": list(s.depths), "num_heads": list(s.num_heads),
            "window_size": s.window_size, "mlp_ratio": s.mlp_ratio}


def features(v: Mapping) -> int:
    """The last stage's width."""
    return v["embed_dim"] * 2 ** (len(v["depths"]) - 1)


def out(v: Mapping):
    res = v["img_size"] // v["patch_size"]
    for _ in v["depths"][1:]:
        res = (res + 1) // 2
    return res * res, features(v)


def flops(v: Mapping) -> int:
    """Patch embedding, blocks and merges."""
    res = v["img_size"] // v["patch_size"]
    C = v["embed_dim"]
    total = 2 * res * res * v["patch_size"] ** 2 * v["in_chans"] * C
    for stage, depth in enumerate(v["depths"]):
        T = res * res
        ws = min(v["window_size"], res)
        N = ws * ws
        hidden = int(C * v["mlp_ratio"])
        # qkv 6 T C^2, proj 2 T C^2, MLP 4 T C hidden, scores and p.v 4 T N C
        total += depth * (8 * T * C * C + 4 * T * C * hidden + 4 * T * N * C)
        if stage < len(v["depths"]) - 1:
            res = (res + 1) // 2
            total += 2 * res * res * 4 * C * 2 * C
            C *= 2
    return total


def param_bytes(v: Mapping, dtype_bytes: int = 2) -> int:
    C, total = v["embed_dim"], v["patch_size"] ** 2 * v["in_chans"] * v["embed_dim"]
    for stage, depth in enumerate(v["depths"]):
        total += depth * (4 * C * C + 2 * C * int(C * v["mlp_ratio"]))
        if stage < len(v["depths"]) - 1:
            total += 8 * C * C
            C *= 2
    return total * dtype_bytes


def reference(ref, image):
    return ref.swin(image, PREFIX)
