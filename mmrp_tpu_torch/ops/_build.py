"""Build and bind the port's CUDA kernels.

The sources under ``mmrp_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface,
``mmrp_tpu_torch/build/libmmrp_kernels.so``, at first use: one ``nvcc -c``
per source, all started together, then one link. A stamp beside the library
holds the sha256 of the sources and flags; a change to either rebuilds.
Nothing includes PyTorch's headers, so a build takes seconds. The library is
bound with ``ctypes``: every pointer and the stream go as ``c_void_p``, and
every entry returns ``cudaGetLastError()``, which :func:`launch` turns into
an exception.

Without ``nvcc`` there is no kernel and no fallback: :func:`build` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
LIB_PATH = BUILD_DIR / "libmmrp_kernels.so"
SOURCES = ("window_attention.cu", "ln_mlp.cu", "seq_attention.cu", "swin_block.cu",
           "wattn_core.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry, in the order of its definition in csrc/
_SIGNATURES = {
    "mmrp_window_attention": [_P] * 10 + [_I] * 6 + [_F, _P],
    "mmrp_attn_splits": [_I] * 3,
    "mmrp_attention_smem": [_I] * 2,
    "mmrp_ln_mlp": [_P] * 10 + [_I] * 5 + [_F, _P],
    "mmrp_mlp_cluster": [_I] * 4,
    "mmrp_seq_attention": [_P] * 18 + [_I] * 8 + [_F, _P, _P],
    "mmrp_swin_block": [_P] * 17 + [_I] * 10 + [_F, _P, _P],
    "mmrp_wattn_core_fwd": [_P] * 3 + [_I] * 7 + [_F, _P],
    "mmrp_wattn_core_bwd": [_P] * 5 + [_I] * 7 + [_F, _P],
    "mmrp_core_plan": [_I] * 5 + [_P, _I],
    "mmrp_core_fit": [_I] * 2,
    "mmrp_window_attention_heads": [_P] * 5 + [_I] * 4 + [_F, _P],
}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "mmrp_tpu_torch are built from mmrp_tpu_torch/csrc with the CUDA "
        "toolkit, and there is no fallback for CUDA tensors")


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Optional[str]:
    """Compile the library unless an up-to-date one exists. Returns the
    compiler's log (ptxas register/shared-memory report) when it compiled,
    None when the existing library was current."""
    digest = source_digest()
    stamp = LIB_PATH.with_name(LIB_PATH.name + ".sha256")
    if not force and LIB_PATH.is_file() and stamp.is_file() \
            and stamp.read_text() == digest:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = nvcc_path(), os.getpid()
    tmp = BUILD_DIR / f"libmmrp_kernels.{pid}.tmp.so"
    objs = [BUILD_DIR / f"{Path(src).stem}.{pid}.o" for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / src)]
                for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in compiles]
    logs = [proc.communicate()[0] for proc in procs]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc, out in zip(compiles, procs, logs):
            _check(cmd, proc.returncode, out)
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        _check(link, proc.returncode, proc.stdout)
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    stamp.write_text(digest)
    return "".join(logs) + proc.stdout


def _check(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n{output}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mmrp_error_string.argtypes = [ctypes.c_int]
    lib.mmrp_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` with ``device`` current (a launch goes to the
    current device); raise if the launch reported a CUDA error."""
    lib = library()
    if device.index is None or device.index == torch.cuda.current_device():
        code = getattr(lib, name)(*args)
    else:
        with torch.cuda.device(device):
            code = getattr(lib, name)(*args)
    if code != 0:
        msg = lib.mmrp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_cuda_inputs(op: str, device: torch.device,
                      tensors: Sequence[tuple]) -> None:
    """Validate ``(name, tensor, dtype, shape)`` entries (tensor may be None)
    before their pointers go to a kernel: same CUDA device, dtype, shape,
    contiguity and 32-byte alignment (16-byte row copies). The kernels are
    forward-only, so an input that autograd would track is refused."""
    grad = torch.is_grad_enabled()
    for name, t, dtype, shape in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} has dtype {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{op}: {name} is not 32-byte aligned")
        if grad and t.requires_grad:
            raise RuntimeError(
                f"{op}: {name} requires grad; the CUDA kernel is forward-only "
                "(run under torch.inference_mode() or torch.no_grad())")


def run_plain(wrapper, plain, *args, **kwargs):
    """``plain(*args, **kwargs)`` on a plain route of a model's plan: a shape
    the kernel behind ``wrapper`` does not take, run by its plain version on
    any device and counted in ``wrapper.plain_calls``."""
    wrapper.plain_calls += 1
    return plain(*args, **kwargs)


def round16(n: int) -> int:
    return (n + 15) // 16 * 16


class QuantArgs(ctypes.Structure):
    """The C ``QuantArgs`` of ``csrc/common.cuh``: the W8A8 operands of one
    launch, read on the host before it. ``mode`` 1 is the JAX ``_qdot``
    (dequantized ``acc * sx * sw``), 2 its ``_static_gemm`` (``acc * sw *
    s``); ``w``/``s`` the int8 weights and their f32 scales in GEMM order;
    ``act``/``inv`` a static activation scale and its reciprocal per GEMM,
    0 for per-row scales."""
    _fields_ = [("mode", ctypes.c_int), ("w", ctypes.c_void_p * 4), ("s", ctypes.c_void_p * 4),
                ("act", ctypes.c_float * 4), ("inv", ctypes.c_float * 4)]


def quant_args(mode: int, w8: Sequence[tuple], act_scales=None) -> QuantArgs:
    """QuantArgs of ``w8`` [(int8 weight, scale)] and optional static
    activation scales (one Python float ``sa`` per GEMM): the kernel quantizes with
    ``f32(1 / sa)``, the reciprocal taken in f64 as the JAX kernel's Python
    constant is, and dequantizes with ``f32(sa)``."""
    qa = QuantArgs()
    qa.mode = mode
    for i, (w, s) in enumerate(w8):
        qa.w[i], qa.s[i] = w.data_ptr(), s.data_ptr()
    for i, sa in enumerate(act_scales or ()):
        qa.act[i], qa.inv[i] = float(sa), 1.0 / float(sa)
    return qa


def addr(qa: Optional[QuantArgs]) -> Optional[int]:
    return None if qa is None else ctypes.addressof(qa)
