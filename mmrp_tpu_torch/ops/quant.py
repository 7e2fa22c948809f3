"""W8A8 quantization: int8 weights per output channel, int8 activations per row.

Counterpart of ``mmrp_tpu/ops/quant.py``. Weights use the nn.Linear layout
(N, K), so :func:`quantize_weight` returns one scale per weight row: the
numbers the JAX function returns for the (K, N) kernel, transposed.

:func:`quant_dot` / :func:`quant_dot_multi` are the GEMMs the JAX package runs
outside any Pallas kernel (the text FFN, the fusion stack): int8 x int8 ->
int32, dequantized as ``acc * sx * sw`` in f32, then the bias in f32. On the
card the int8 product is ``torch._int_mm`` (cuBLASLt); on the CPU it is a
float64 product of the int8 values, which is exact at every width here
(|acc| <= 127^2 K < 2^53), where a float32 one would not be (127^2 * 3072 >
2^24). The hand-written int8 kernels (``csrc/``) quantize activations
themselves and take the int8 weights and scales made here.

Int8 weight caches: :func:`attach_int8` gives an nn.Linear the buffers
``weight_q`` (N, K) int8 and ``weight_scale`` (N,) f32, quantized from its
weight when attached and again after every ``load_state_dict``.
``utils/convert.py`` rebuilds the caches marked ``from_master`` from the f32
arrays of a JAX tree, as ``mmrp_tpu``'s ``build_quant_cache`` and
``quant_dot`` quantize the f32 parameters, where the kernels that quantize
the bf16-cast weights they receive (the in-kernel ``_qdot``) keep the cache
of the module's weight.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

EPS = 1e-8


def quantize_weight(w: torch.Tensor, eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) float weight -> (int8 (N, K), f32 per-output-channel scale (N,)):
    ``s = max(amax, eps) / 127``, ``round(w / s)`` with ties to even."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=1), min=eps) / 127.0
    return torch.round(wf / s[:, None]).to(torch.int8), s


def quantize_acts(x: torch.Tensor, eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> (int8 (..., K), f32 per-row scale (..., 1))."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=eps) / 127.0
    return torch.round(xf / s).to(torch.int8), s


def exact_int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K)^T int8 -> (..., N) int32, summed exactly in f64."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32: ``torch._int_mm`` on the
    card, with the weight passed column-major and M padded past 16 rows where
    cuBLASLt needs it; :func:`exact_int_matmul` elsewhere."""
    if xq.device.type != "cuda":
        return exact_int_matmul(xq, wq)
    M, K = xq.shape
    if K % 8 or wq.shape[0] % 8:
        raise ValueError(f"int_mm: K and N must be multiples of 8, got K={K}, N={wq.shape[0]}")
    Mp = M if (M > 16 and M % 8 == 0) else max(32, (M + 15) // 16 * 16)
    if Mp != M:
        xq = torch.cat([xq, xq.new_zeros((Mp - M, K))])
    return torch._int_mm(xq.contiguous(), wq.t())[:M]


def _dequant(acc, sx, sw, bias, out_dtype):
    out = acc.float() * sx * sw
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def quant_dot(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None,
              wscale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ w^T [+ bias] through dynamic W8A8. ``w`` is a float (N, K)
    weight, quantized here, or its int8 copy with ``wscale`` (N,)."""
    return quant_dot_multi(x, [(w, bias)], out_dtype, None if wscale is None else [wscale])[0]


def quant_dot_multi(x: torch.Tensor, wbs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                    out_dtype: Optional[torch.dtype] = None,
                    wscales: Optional[Sequence[torch.Tensor]] = None):
    """Several (w, b) GEMMs on ONE activation tensor, quantized once."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_acts(x)
    K = x.shape[-1]
    outs = []
    for i, (w, b) in enumerate(wbs):
        if wscales is not None and w.dtype != torch.int8:
            raise TypeError("quant_dot: wscales go with int8 weights")
        wq, sw = quantize_weight(w) if wscales is None else (w, wscales[i])
        acc = int_mm(xq.reshape(-1, K), wq).reshape(*x.shape[:-1], wq.shape[0])
        outs.append(_dequant(acc, sx, sw, b, out_dtype))
    return outs


def int8_weights(ws: Sequence[torch.Tensor], wscales) -> list:
    """[(int8 weight, f32 scale)] for float weights ``ws`` (quantized here) or
    for int8 ones with their ``wscales``."""
    if wscales is None:
        if any(w.dtype == torch.int8 for w in ws):
            raise ValueError("int8 weights need their wscales")
        return [quantize_weight(w) for w in ws]
    if len(wscales) != len(ws) or any(w.dtype != torch.int8 for w in ws):
        raise ValueError(f"wscales go with {len(ws)} int8 weights")
    return list(zip(ws, wscales))


# -- int8 weight caches on nn.Linear -------------------------------------------


def attach_int8(linear: nn.Linear, from_master: bool) -> None:
    """Keep an int8 copy of ``linear.weight`` (module docstring). A weight
    the JAX package quantizes from its f32 parameter is ``from_master``."""
    linear.register_buffer("weight_q", None, persistent=False)
    linear.register_buffer("weight_scale", None, persistent=False)
    linear.int8_from_master = from_master
    refresh_int8(linear)
    linear.register_load_state_dict_post_hook(lambda module, _keys: refresh_int8(module))


@torch.no_grad()
def refresh_int8(linear: nn.Linear, master: Optional[torch.Tensor] = None) -> None:
    """Quantize ``master`` (an (N, K) f32 copy of the weight) or the weight."""
    src = linear.weight if master is None else master.to(linear.weight.device)
    linear.weight_q, linear.weight_scale = quantize_weight(src)
    # what the cache was built from: stale once the weight changes in place
    linear.int8_source = (linear.weight.data_ptr(), linear.weight._version)


def int8_linears(model: nn.Module) -> Iterator[Tuple[str, nn.Linear]]:
    """(name, module) of every nn.Linear with an int8 cache."""
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear) and getattr(m, "weight_q", None) is not None:
            yield name, m


def int8_stale(linear: nn.Linear) -> bool:
    return linear.int8_source != (linear.weight.data_ptr(), linear.weight._version)
