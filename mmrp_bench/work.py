"""The yardstick's arithmetic: peaks, operations and bytes from shapes, and
kernel kinds by name.

Frozen here so that a change to the program cannot move it:

- ``PEAK_FLOPS``, ``PEAK_BYTES``, ``PEAK_INT8`` and the ``*_launch_work`` /
  ``attn_flops`` functions are the bound arithmetic of the repository's
  ``chip_smoke.py``;
- ``KINDS`` is the kernel-name classifier of
  ``mmrp_tpu_torch/profile_forward.py``, which sorts the breakdown of a
  trace. Whether a kernel is the port's own is read from its name's C++
  namespace, ``mmrp::``, where every kernel under ``mmrp_tpu_torch/csrc``
  lives (:func:`is_port_kernel`), so a kernel a later change adds or renames
  is classed without a list of names.

On top of them, the useful work of one image-report pair through the model
(:func:`pair_work`): matrix-multiply FLOPs (2 per multiply-add) of every
GEMM and of the attention products (q k^T and p v), counted at the text
positions some output depends on. The text tower and every text-side
product of the fusion stack run over the padded 512 positions, but a padded
position is masked as a key everywhere and is never pooled as a query, so no
output depends on it: those terms are counted at the pair's valid length.
The image side has no padding: its 3,136 / 784 / 196 / 49 tokens are all
counted. Elementwise work (LayerNorm, softmax, GELU, residuals) is not
counted. The gallery top-K is not model work and is not counted either.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

# one H100 SXM at its 700 W limit (NVIDIA data sheet): dense bf16 tensor-core
# rate, HBM3 rate, dense int8 tensor-core rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12


def mlp_launch_work(M: int, C: int, blocks: int, int8: bool):
    """(bf16 FLOPs, int8 ops, bytes) of the whole-block call's MLP launch(es)
    over M rows of width C: proj, FC1 and FC2, 18 M C^2 operations a block;
    the context and the residual read once, the weights read once (int8: one
    byte each), the output written once."""
    ops = 18 * M * C * C * blocks
    nbytes = blocks * (3 * M * C * 2 + 9 * C * C * (1 if int8 else 2))
    return (0, ops, nbytes) if int8 else (ops, 0, nbytes)


def attn_launch_work(M: int, C: int, heads: int, nW: int, blocks: int = 1,
                     int8: bool = False, N: int = 49):
    """(bf16 FLOPs, int8 ops, bytes) of the K1 or whole-block call's attention
    launch(es) over M rows of width C in nW windows of N tokens: the qkv GEMM,
    6 C^2 a row, and the scores and P.V, 4 N C a row; the rows read and the
    context written once, W_qkv and b_qkv read once, and the (nW, heads, N, N)
    f32 bias."""
    gemm, att = 6 * M * C * C * blocks, 4 * M * N * C * blocks
    wbytes = 3 * C * C + 3 * C * 4 if int8 else 3 * C * C * 2
    nbytes = blocks * (2 * M * C * 2 + wbytes + 3 * C * 2 + nW * heads * N * N * 4)
    return (att, gemm, nbytes) if int8 else (gemm + att, 0, nbytes)


def proj_launch_work(M: int, C: int):
    """(bf16 FLOPs, int8 ops, bytes) of K1's projection launch: 2 M C^2 FLOPs;
    the context and the residual read, W_o and b_o read, the output written
    once."""
    return 2 * M * C * C, 0, 3 * M * C * 2 + C * C * 2 + C * 2


def attn_flops(M: int, Nk: int, C: int, kv_rows: int) -> int:
    """q and out projections over M query rows, k and v over kv_rows key
    rows, and q k^T plus p v (4 M Nk C over all heads)."""
    return 4 * M * C * C + 4 * kv_rows * C * C + 4 * M * Nk * C


KINDS = (  # (kind, test on the kernel name), first match wins
    ("wattn core forward (C-F)", lambda n: "core_fwd_" in n),
    ("wattn core backward (C-B)", lambda n: "core_bwd_" in n or "sum_chunks_kernel" in n),
    ("swin attention phase", lambda n: "window_attn_wgmma" in n),
    ("K3 q/k/v GEMM", lambda n: "qkv_kernel<" in n),
    ("K3 attention tile", lambda n: "attn_kernel<" in n),
    ("K3 output GEMM + epilogue", lambda n: "out_kernel<" in n),
    ("K1 projection epilogue", lambda n: "k1_proj_wgmma" in n),
    ("K2 ln_mlp", lambda n: "ln_mlp_kernel" in n),
    ("whole-block MLP epilogue, int8", lambda n: "block_mlp" in n
     and "block_mlp_kernel<false" not in n),
    ("whole-block MLP epilogue", lambda n: "block_mlp_kernel" in n),
    ("NCCL collectives", lambda n: "nccl" in n.lower()),
    ("library GEMMs", lambda n: any(k in n.lower() for k in ("gemm", "cutlass", "xmma",
                                                             "nvjet", "sm90_", "cublas"))),
    ("other (copies, casts, elementwise)", lambda n: True),
)
PORT_NAMESPACE = "mmrp::"


def kind_of(name: str) -> str:
    return next(kind for kind, match in KINDS if match(name))


def is_port_kernel(name: str) -> bool:
    """A kernel of the port's own: its demangled name is in ``mmrp::``."""
    return PORT_NAMESPACE in name


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()


# --- useful work of the model, from the configuration file's widths -------

def _vision(cfg: Mapping):
    from mmrp_bench.harness import vision_kind

    return vision_kind(cfg["vision"]["kind"])


def vision_out(cfg: Mapping):
    """(patches, width) of the vision tower's output."""
    return _vision(cfg).out(cfg["vision"])


def vision_flops(cfg: Mapping) -> int:
    """Forward FLOPs of one image through the vision tower (``vision/<kind>.py``)."""
    return _vision(cfg).flops(cfg["vision"])


def text_flops(cfg: Mapping, L: int) -> int:
    """The BERT tower over L valid tokens."""
    t = cfg["text"]
    H, I = t["hidden_dim"], t["intermediate_dim"]
    return t["num_layers"] * (8 * L * H * H + 4 * L * H * I + 4 * L * L * H)


def fusion_flops(cfg: Mapping, L: int) -> int:
    """The fusion layers over L valid text tokens and the image's patches."""
    f = cfg["fusion"]
    D = f["joint_dim"]
    Np, _ = vision_out(cfg)
    S = Np + 2
    layer = (attn_flops(L, L, D, L)            # text enhancer
             + attn_flops(Np, Np, D, Np)       # image enhancer
             + attn_flops(L, Np, D, Np)        # text queries over patches
             + attn_flops(Np, L, D, L)         # patch queries over text
             + 2 * 2 * D * D                   # cls projection
             + attn_flops(S, S, D, S)          # self-attention over [cls, patches, text]
             + 16 * S * D * D                  # FFN
             + S * D * D)                      # adapter down and up (D / 4)
    return f["num_fusion_layers"] * layer


def glue_flops(cfg: Mapping, L: int) -> int:
    """Projections into the joint space, the joint init and the head."""
    f = cfg["fusion"]
    D = f["joint_dim"]
    Np, F_img = vision_out(cfg)
    H = cfg["text"]["hidden_dim"]
    return (2 * (Np + 1) * F_img * D + 2 * (L + 1) * H * D + 2 * 2 * D * D
            + 2 * D * 4 * D + 2 * 4 * D * cfg["num_classes"])


def pair_work(cfg: Mapping, L: int) -> Dict[str, int]:
    """Useful forward FLOPs of one pair with L valid text tokens, by layer."""
    return {"vision": vision_flops(cfg), "text": text_flops(cfg, L),
            "fusion": fusion_flops(cfg, L), "glue": glue_flops(cfg, L)}


def batch_flops(cfg: Mapping, lengths: Iterable[int], parts=None) -> int:
    """Useful forward FLOPs of a batch with these valid lengths, summed over
    ``parts`` (all layers by default)."""
    total = 0
    for L in lengths:
        w = pair_work(cfg, int(L))
        total += sum(v for k, v in w.items() if parts is None or k in parts)
    return total


def layer_param_bytes(cfg: Mapping, part: str, dtype_bytes: int = 2) -> int:
    """Bytes of the weights a layer reads once per call: the text tower (its
    layers; the embedding rows gathered are counted with the inputs), the
    fusion layers, or the vision tower (``vision/<kind>.py``)."""
    if part == "text":
        t = cfg["text"]
        H, I = t["hidden_dim"], t["intermediate_dim"]
        return t["num_layers"] * (4 * H * H + 2 * H * I) * dtype_bytes
    if part == "fusion":
        f = cfg["fusion"]
        D = f["joint_dim"]
        per = 4 * 4 * D * D + 2 * D * D + 4 * D * D + 8 * D * D + D * D // 2
        return f["num_fusion_layers"] * per * dtype_bytes
    return _vision(cfg).param_bytes(cfg["vision"], dtype_bytes)


def roofline_ms(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak, in ms."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def share_pct(name: str, value: float) -> float:
    """A share of a roofline or of the peak, in %. Above 100% the operations
    or bytes are counted too high, or the time leaves out part of the work:
    an error, never clipped."""
    if value > 100.0:
        raise ValueError(f"{name} reads {value:.3f}% > 100%: the work is counted too high "
                         "or the device time misses part of it")
    return value
