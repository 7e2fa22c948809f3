"""K3: fused sequence attention — [LN] + q/k/v + masked softmax + proj [+ res] [+ LN].

Counterpart of ``mmrp_tpu/ops/fused_attention.py``. Forms, selected by ``ln_mode``:
  "pre":  y = [x +] alpha * proj(attn(LN(x + pos)))      (fusion self-attn, enhancers)
  "post": y = LN(x + pos + alpha * proj(attn(x + pos)))  (BERT layer, cross-attn)
  "none": y = [x +] alpha * proj(attn(x + pos))
with optional cross input ``kv``, additive (B, Nk) f32 ``key_mask`` and the
residual from raw x (``residual_from_raw``) instead of x + pos.

``quant=True`` runs the four projections as W8A8, the JAX ``_qdot``: int8
weights per output channel, the bf16 GEMM inputs (``qin``, ``kin``, the
context) quantized per row, int32 accumulation dequantized as ``acc * sx *
sw``, then the bias in f32. The weights are the float ones, quantized here as
the TPU kernel quantizes them per program, or their int8 copies with
``wscales`` (``ops/quant.py``'s caches), which hold the same numbers.

On a CUDA tensor :func:`fused_attention` launches the hand-written kernels in
``csrc/seq_attention.cu`` (the projections on ``csrc/gemm_sm90.cuh``, the
attention on ``csrc/attn_tile.cuh``); on a CPU tensor it runs
:func:`attention_plain`, the same function in plain PyTorch with the dtype
discipline of the JAX ``xla_equivalent`` (and of ``_qdot`` with ``quant``).
Token counts need no padding (the TPU kernel wanted multiples of 8): the CUDA
kernels take 1 to 512 per sequence, the model's positions.
:func:`tile_walk_plain` is the CUDA attention tile's walk over 64-key tiles,
with its rounding points, in plain PyTorch.

:func:`kernel_takes` holds the CUDA kernels' shape limits: the wrapper raises
on a CUDA tensor it refuses, and the text encoder and the fusion modules
route such shapes to :func:`attention_plain` by their plan, counted in
``fused_attention.plain_calls``.

The packed form (:func:`fused_attention_packed`, bf16, no ``quant``):
sequences of different lengths lie back to back in the rows of a 2-D
``(T, C)`` tensor, described by a :class:`Packed` plan (:func:`pack`, made
on the host from the lengths and copied to the device once); a side without
a plan is a regular ``(B, N, C)`` tensor. Each sequence attends only its own
keys, so no key mask is needed: a padded form's masked key has softmax
weight exactly 0, and a padded query row is thrown away, so the packed
form's rows are the padded form's valid rows. :func:`attention_plain_packed`
is its plain version: the padded function on the rows padded to the longest
sequence, with the key mask of the padding.

Weights use the nn.Linear layout: each of wq/wk/wv/wo is (C_out, C_in).

The launches are the op ``torch.ops.mmrp.seq_attention`` (``_build.kernel_op``),
which a traced serving program records. Gradients, as JAX's ``custom_vjp``:
every form's backward differentiates the unquantized :func:`attention_plain`
recomputed on the saved inputs (``_build.grad_route``), the kernel's forward
on a CUDA tensor and the plain version's (int8 for ``quant``) on a CPU one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmrp_tpu_torch.ops import _build
from mmrp_tpu_torch.ops.quant import int8_weights, quant_dot

_LN_MODES = {"none": 0, "pre": 1, "post": 2}
MAX_TOKENS = 512  # tokens per sequence the CUDA kernels take: the model's positions
TILE = 64  # queries per attention tile, and keys per key tile


HEAD_DIMS = (32, 64, 128)
MAX_WIDTH = 1024


def kernel_takes(C: int, num_heads: int, Nq: int, Nk: Optional[int] = None) -> bool:
    """Whether the CUDA kernels take width C, ``num_heads`` heads, Nq query
    and Nk key tokens (Nk = Nq for self-attention): head dims 32, 64 or 128,
    C a multiple of 128 up to 1024, and 1 to ``MAX_TOKENS`` tokens."""
    Nk = Nq if Nk is None else Nk
    return (num_heads > 0 and C % num_heads == 0 and C // num_heads in HEAD_DIMS
            and C % 128 == 0 and C <= MAX_WIDTH and 1 <= Nq <= MAX_TOKENS
            and 1 <= Nk <= MAX_TOKENS)


def _ln(xf, scale, bias, eps):
    return F.layer_norm(xf, xf.shape[-1:], scale.float(), bias.float(), eps)


def _check_form(ln_mode: str, kv) -> None:
    if ln_mode not in _LN_MODES:
        raise ValueError(f"fused_attention: ln_mode must be pre|post|none, got {ln_mode!r}")
    # pre-LN with a cross kv would normalize kv with the query-side LN params
    if ln_mode == "pre" and kv is not None:
        raise ValueError("fused_attention: ln_mode='pre' with a cross kv input would apply "
                         "the query-side LN params to kv; use ln_mode='none' or 'post'")


def attention_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                    kv=None, key_mask=None, pos=None, alpha=None, *, num_heads: int,
                    ln_mode: str = "pre", include_residual: bool = True,
                    residual_from_raw: bool = False, eps: float = 1e-6,
                    quant: bool = False, wscales=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference it is held to)."""
    _check_form(ln_mode, kv)
    B, Nq, C = x.shape
    h, d = num_heads, C // num_heads
    dt = x.dtype
    xf = x.float()
    basef = xf + pos.float()[None] if pos is not None else xf
    base = basef.to(dt)
    qin = _ln(base.float(), ln_scale, ln_bias, eps).to(dt) if ln_mode == "pre" else base
    kin = qin if kv is None else kv
    if quant:
        (wq8, wk8, wv8, wo8) = int8_weights((wq, wk, wv, wo), wscales)

        def gemm(t, w8):
            return quant_dot(t, w8[0], out_dtype=torch.float32, wscale=w8[1])
    else:
        wq8, wk8, wv8, wo8 = wq, wk, wv, wo

        def gemm(t, w):
            return t.float() @ w.float().t()

    def lin(t, w, b):
        return (gemm(t, w) + b.float()).to(dt)

    q = lin(qin, wq8, bq).reshape(B, Nq, h, d)
    k = lin(kin, wk8, bk).reshape(B, -1, h, d)
    v = lin(kin, wv8, bv).reshape(B, -1, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    if key_mask is not None:
        scores = scores + key_mask.float()[:, None, None, :]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    attn = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dt).reshape(B, Nq, C)
    proj = gemm(attn, wo8) + bo.float()
    if alpha is not None:
        proj = proj * alpha.float().reshape(())
    if ln_mode == "post":
        out = _ln(basef + proj, ln_scale, ln_bias, eps)
    elif include_residual:
        out = (xf if residual_from_raw else basef) + proj
    else:
        out = proj
    return out.to(dt)


def tile_walk_plain(q, k, v, key_mask=None) -> torch.Tensor:
    """softmax(q k^T d^-1/2 + key_mask) v as the CUDA attention tile walks it
    (``csrc/attn_tile.cuh``): q, k, v (B, h, N, d), key_mask (B, Nk) additive
    or None. Key tiles of ``TILE`` in order with a running max and sum in f32;
    keys past Nk do not exist (they are excluded, not masked); the unnormalized
    p is rounded to q's dtype for P.V, the sum is of the f32 p, and o / l is
    rounded once. Returns (B, h, Nq, d) in q's dtype."""
    B, h, Nq, d = q.shape
    qf = q.float()
    m = torch.full((B, h, Nq, 1), -torch.inf)
    l = torch.zeros((B, h, Nq, 1))
    o = torch.zeros((B, h, Nq, d))
    for k0 in range(0, k.shape[2], TILE):
        s = qf @ k[:, :, k0:k0 + TILE].float().transpose(-1, -2) * d ** -0.5
        if key_mask is not None:
            s = s + key_mask.float()[:, None, None, k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(q.dtype).float() @ v[:, :, k0:k0 + TILE].float()
        m = m_new
    return (o / l).to(q.dtype)


def fused_attention(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                    kv: Optional[torch.Tensor] = None,
                    key_mask: Optional[torch.Tensor] = None,
                    pos: Optional[torch.Tensor] = None,
                    alpha: Optional[torch.Tensor] = None, *, num_heads: int,
                    ln_mode: str = "pre", include_residual: bool = True,
                    residual_from_raw: bool = False, eps: float = 1e-6,
                    quant: bool = False, wscales=None) -> torch.Tensor:
    """One fused attention block over x (B, Nq, C). ``ln_scale``/``ln_bias``
    may be None in ln_mode 'none'. ``quant``: W8A8 projections (module
    docstring). Launches are counted per flavor: ``launches`` (bf16) and
    ``launches_int8``. Both forms have a gradient route through the
    unquantized :func:`attention_plain` (module docstring); the W8A8 one
    needs the float weights for it (``wscales=None``)."""
    tensors = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, kv, key_mask, pos, alpha)
    kw = dict(num_heads=num_heads, ln_mode=ln_mode, include_residual=include_residual,
              residual_from_raw=residual_from_raw, eps=eps)

    def plain(*t):
        return attention_plain(*t, **kw)

    if x.device.type == "cpu":
        if not quant:
            return plain(*tensors)

        def kernel(*t):
            return attention_plain(*t, **kw, quant=True, wscales=wscales)
    elif x.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for {x.device}")
    else:
        def kernel(*t):
            launch = _op if _build.traced() else _launch
            return launch(*t, list(wscales or ()), **kw, quant=bool(quant))
    if quant:
        return _build.quant_grad_route("fused_attention", kernel, plain, tensors,
                                       wscales is not None)
    return _build.grad_route(kernel, plain, tensors)


def _launch(x: torch.Tensor, ln_scale: Optional[torch.Tensor], ln_bias: Optional[torch.Tensor],
            wq: torch.Tensor, bq: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
            wv: torch.Tensor, bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
            kv: Optional[torch.Tensor], key_mask: Optional[torch.Tensor],
            pos: Optional[torch.Tensor], alpha: Optional[torch.Tensor],
            wscales: List[torch.Tensor], *, num_heads: int, ln_mode: str,
            include_residual: bool, residual_from_raw: bool, eps: float,
            quant: bool) -> torch.Tensor:
    """The kernels' launches on CUDA tensors (:func:`fused_attention`);
    ``wscales`` empty: float weights."""
    _check_form(ln_mode, kv)
    B, Nq, C = x.shape
    Nk = Nq if kv is None else kv.shape[1]
    if not kernel_takes(C, num_heads, Nq, Nk):
        raise ValueError(
            "fused_attention: the kernel takes head dims 32/64/128, C a multiple of 128 up "
            f"to 1024 and 1 to {MAX_TOKENS} tokens, got C={C}, heads={num_heads}, Nq={Nq}, "
            f"Nk={Nk}")
    if ln_mode != "none" and (ln_scale is None or ln_bias is None):
        raise ValueError(f"fused_attention: ln_mode={ln_mode!r} needs ln_scale and ln_bias")
    bf16, f32 = torch.bfloat16, torch.float32
    weights = [("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)]
    qa = None
    if quant:
        w8 = int8_weights([w for _, w in weights], wscales or None)
        qa = _build.quant_args(1, w8)
        wspecs = [spec for (n, _), (w, s) in zip(weights, w8)
                  for spec in ((n, w, torch.int8, (C, C)), (f"{n} scale", s, f32, (C,)))]
        weights = [(n, None) for n, _ in weights]  # the kernel reads the int8 copies
    else:
        wspecs = [(n, w, bf16, (C, C)) for n, w in weights]
    _build.check_cuda_inputs("fused_attention", x.device, [
        ("x", x, bf16, (B, Nq, C)), ("kv", kv, bf16, (B, Nk, C)),
        ("key_mask", key_mask, f32, (B, Nk)), ("pos", pos, bf16, (Nq, C)),
        ("alpha", alpha, f32, ()),
        ("ln_scale", ln_scale, f32, (C,)), ("ln_bias", ln_bias, f32, (C,)),
        *wspecs, ("bq", bq, bf16, (C,)), ("bk", bk, bf16, (C,)), ("bv", bv, bf16, (C,)),
        ("bo", bo, bf16, (C,)),
    ])
    (_, wq), (_, wk), (_, wv), (_, wo) = weights
    # head-major q, k, v and the (B * Nq, C) context: bf16 intermediates of
    # the three launches
    qkv = torch.empty(B * (Nq + 2 * Nk) * C, dtype=bf16, device=x.device)
    ctx = torch.empty((B * Nq, C), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    _build.launch(
        "mmrp_seq_attention", x.device,
        *map(_build.ptr, (x, kv, key_mask, pos, alpha, ln_scale, ln_bias, wq, bq, wk,
                          bk, wv, bv, wo, bo, qkv, ctx, out)),
        B, Nq, Nk, C, num_heads, _LN_MODES[ln_mode], int(include_residual),
        int(residual_from_raw), float(eps), _build.addr(qa), _build.stream_of(x))
    if quant:
        fused_attention.launches_int8 += 1
    else:
        fused_attention.launches += 1
    return out


def _fake(x, *args, **kwargs):
    return x.new_empty(x.shape)


_op = _build.kernel_op("seq_attention", _launch, _fake)
fused_attention.launches = 0
fused_attention.launches_int8 = 0
fused_attention.launches_packed = 0
fused_attention.plain_calls = 0


class Packed(NamedTuple):
    """B sequences packed back to back in T rows (:func:`pack`). The int32
    tensors are views of one device buffer:

    - ``offsets`` (B + 1,): sequence b is rows ``offsets[b]`` to
      ``offsets[b + 1] - 1``;
    - ``lengths`` (B,): each sequence's length;
    - ``pos`` (T,): each row's position in its sequence;
    - ``slot`` (T,): each row's index in the (B, max_len) padded layout;
    - ``pad_index`` (B * max_len,): each padded slot's row, T past its
      sequence.

    ``width`` is the length the batch was padded to (the padded form runs
    B * width rows); ``T``, ``max_len`` and ``width`` are host ints."""
    offsets: torch.Tensor
    lengths: torch.Tensor
    pos: torch.Tensor
    slot: torch.Tensor
    pad_index: torch.Tensor
    B: int
    T: int
    max_len: int
    width: int


def pack(lengths: np.ndarray, width: int, device) -> Packed:
    """The :class:`Packed` plan of sequences of ``lengths`` (host ints, each
    1 to ``width``), made on the host and sent to ``device`` in one copy
    (from pinned memory, not waited for, on a CUDA device)."""
    lengths = np.asarray(lengths, np.int64)
    B, T = len(lengths), int(lengths.sum())
    if B < 1 or lengths.min() < 1 or lengths.max() > width:
        raise ValueError(f"pack: lengths must be 1 to {width}, got {lengths.tolist()}")
    max_len = int(lengths.max())
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    pos = np.arange(T) - np.repeat(offsets[:-1], lengths)
    slot = np.repeat(np.arange(B) * max_len, lengths) + pos
    pad_index = np.full(B * max_len, T)
    pad_index[slot] = np.arange(T)
    parts = (offsets, lengths, pos, slot, pad_index)
    # each part starts 32 bytes into the buffer, as the kernels' inputs must
    starts = np.cumsum([0] + [-(-len(a) // 8) * 8 for a in parts])
    buf = np.zeros(starts[-1], np.int32)
    for a, s0 in zip(parts, starts):
        buf[s0:s0 + len(a)] = a
    t = torch.from_numpy(buf)
    device = torch.device(device)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    views = [t[s0:s0 + len(a)] for a, s0 in zip(parts, starts)]
    return Packed(*views, B=B, T=T, max_len=max_len, width=width)


def to_padded(x: torch.Tensor, rows: Packed) -> torch.Tensor:
    """Packed rows (T, C) -> (B, max_len, C), zero past each sequence."""
    C = x.shape[-1]
    full = torch.cat([x, x.new_zeros((1, C))])
    return full.index_select(0, rows.pad_index).view(rows.B, rows.max_len, C)


def _check_packed(x, kv, rows: Optional[Packed], kv_rows: Optional[Packed]) -> None:
    if rows is None and kv_rows is None:
        raise ValueError("fused_attention_packed: give rows, kv_rows or both")
    if kv is None and kv_rows is not None:
        raise ValueError("fused_attention_packed: self-attention takes its keys' rows from rows")
    for name, t, r in (("x", x, rows), ("kv", kv, kv_rows)):
        if t is not None and t.dim() != (2 if r is not None else 3):
            raise ValueError(f"fused_attention_packed: {name} must be (T, C) with its rows, "
                             f"else (B, N, C), got {tuple(t.shape)}")


def attention_plain_packed(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                           kv=None, pos=None, alpha=None, *, rows: Optional[Packed] = None,
                           kv_rows: Optional[Packed] = None, num_heads: int,
                           ln_mode: str = "pre", include_residual: bool = True,
                           residual_from_raw: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """:func:`fused_attention_packed` in plain PyTorch: :func:`attention_plain`
    on each packed side padded to its longest sequence, the keys past a
    sequence masked, and the query rows packed again."""
    _check_packed(x, kv, rows, kv_rows)
    keys = rows if kv is None else kv_rows
    xs = x if rows is None else to_padded(x, rows)
    kvs = kv if kv is None or kv_rows is None else to_padded(kv, kv_rows)
    mask = None
    if keys is not None:
        valid = keys.pad_index.view(keys.B, keys.max_len) < keys.T
        mask = torch.where(valid, 0.0, -1e9).to(torch.float32)
    out = attention_plain(xs, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, kv=kvs,
                          key_mask=mask, pos=None if pos is None else pos[:xs.shape[1]],
                          alpha=alpha, num_heads=num_heads, ln_mode=ln_mode,
                          include_residual=include_residual, residual_from_raw=residual_from_raw,
                          eps=eps)
    return out if rows is None else out.reshape(-1, x.shape[-1]).index_select(0, rows.slot)


def fused_attention_packed(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                           kv: Optional[torch.Tensor] = None, pos: Optional[torch.Tensor] = None,
                           alpha: Optional[torch.Tensor] = None, *,
                           rows: Optional[Packed] = None, kv_rows: Optional[Packed] = None,
                           num_heads: int, ln_mode: str = "pre", include_residual: bool = True,
                           residual_from_raw: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """K3's packed form (module docstring): x (T, C) packed by ``rows`` or
    (B, Nq, C); kv (Tk, C) packed by ``kv_rows``, (B, Nk, C), or None
    (self-attention over x's own sequences). ``pos`` (at least max_len or Nq
    rows) is read at each row's position in its sequence. Counted in
    ``fused_attention.launches`` and ``launches_packed``; the gradient route
    is the plain version's."""
    _check_form(ln_mode, kv)
    tensors = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, kv, pos, alpha)
    kw = dict(rows=rows, kv_rows=kv_rows, num_heads=num_heads, ln_mode=ln_mode,
              include_residual=include_residual, residual_from_raw=residual_from_raw, eps=eps)

    def plain(*t):
        return attention_plain_packed(*t, **kw)

    if x.device.type == "cpu":
        return plain(*tensors)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_packed: no kernel for {x.device}")

    def kernel(*t):
        return _launch_packed(*t, **kw)
    return _build.grad_route(kernel, plain, tensors)


def _launch_packed(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, kv, pos, alpha, *,
                   rows: Optional[Packed], kv_rows: Optional[Packed], num_heads: int,
                   ln_mode: str, include_residual: bool, residual_from_raw: bool,
                   eps: float) -> torch.Tensor:
    """The packed form's launches on CUDA tensors (:func:`fused_attention_packed`)."""
    _check_packed(x, kv, rows, kv_rows)
    keys = rows if kv is None else kv_rows
    src = x if kv is None else kv
    C, B = x.shape[-1], (rows or kv_rows).B
    # rows and longest sequence of each side; a regular side is B x N
    Mq, Nq = (rows.T, rows.max_len) if rows is not None else (B * x.shape[1], x.shape[1])
    Mk, Nk = (keys.T, keys.max_len) if keys is not None else (B * src.shape[1], src.shape[1])
    if not kernel_takes(C, num_heads, Nq, Nk):
        raise ValueError(
            "fused_attention_packed: the kernel takes head dims 32/64/128, C a multiple of 128 "
            f"up to 1024 and 1 to {MAX_TOKENS} tokens a sequence, got C={C}, "
            f"heads={num_heads}, Nq={Nq}, Nk={Nk}")
    if ln_mode != "none" and (ln_scale is None or ln_bias is None):
        raise ValueError(f"fused_attention_packed: ln_mode={ln_mode!r} needs ln_scale and ln_bias")
    if pos is not None and pos.shape[0] < Nq:
        raise ValueError(f"fused_attention_packed: pos has {pos.shape[0]} rows, the longest "
                         f"sequence {Nq}")
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    q_off = None if rows is None else rows.offsets
    k_off = None if keys is None else keys.offsets
    qpos = None if rows is None or pos is None else rows.pos

    def shape(r, M):
        return (M, C) if r is not None else (B, M // B, C)

    _build.check_cuda_inputs("fused_attention_packed", x.device, [
        ("x", x, bf16, shape(rows, Mq)), ("kv", kv, bf16, shape(kv_rows, Mk)),
        ("pos", pos, bf16, None if pos is None else (pos.shape[0], C)),
        ("alpha", alpha, f32, ()), ("ln_scale", ln_scale, f32, (C,)),
        ("ln_bias", ln_bias, f32, (C,)),
        *[(n, w, bf16, (C, C)) for n, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo))],
        ("bq", bq, bf16, (C,)), ("bk", bk, bf16, (C,)), ("bv", bv, bf16, (C,)),
        ("bo", bo, bf16, (C,)), ("q_off", q_off, i32, (B + 1,)),
        ("k_off", k_off, i32, (B + 1,)), ("qpos", qpos, i32, (Mq,)),
    ])
    qkv = torch.empty((Mq + 2 * Mk) * C, dtype=bf16, device=x.device)
    ctx = torch.empty((Mq, C), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    _build.launch(
        "mmrp_seq_attention_packed", x.device,
        *map(_build.ptr, (x, kv, pos, alpha, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                          qkv, ctx, out, q_off, k_off, qpos)),
        B, Mq, Mk, Nq, Nk, C, num_heads, _LN_MODES[ln_mode], int(include_residual),
        int(residual_from_raw), float(eps), _build.stream_of(x))
    fused_attention.launches += 1
    fused_attention.launches_packed += 1
    return out
