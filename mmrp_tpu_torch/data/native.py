"""ctypes binding for the port's native IO runtime (host C++, no CUDA).

Counterpart of ``mmrp_tpu/data/native.py``. The C++ library implements the
DICOM decode -> window -> resize -> normalize hot path with a persistent
worker pool (``mmrp_tpu_torch/csrc/host/mmrp_io.cpp``, the port's copy of
``native/mmrp_io.cpp``); this module loads it lazily and exposes numpy-facing
wrappers. ``DICOMImagePreprocessor.load`` takes it when it is built and
falls back to the pure-Python decoder (``data/dicom.py``) when it is not:
functionality is identical, only throughput differs.

As in the JAX package, building is an explicit step and loading never
builds: :func:`available` finds only a library that is already built (and
current: the stamp beside it holds the sha256 of the source and flags).
Build it with

    python -m mmrp_tpu_torch.data.native

the counterpart of ``make -C native``: ``g++`` into
``mmrp_tpu_torch/build/libmmrp_io.so``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "host" / "mmrp_io.cpp"
LIB_PATH = PKG_DIR / "build" / "libmmrp_io.so"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")
_lib = None
_load_failed = False


def source_digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def _stamp() -> Path:
    return LIB_PATH.with_name(LIB_PATH.name + ".sha256")


def is_current() -> bool:
    """Whether a library built from this source and these flags exists."""
    stamp = _stamp()
    return LIB_PATH.is_file() and stamp.is_file() and stamp.read_text() == source_digest()


def build(force: bool = False) -> bool:
    """Compile the library with g++ unless a current one exists; True when it
    compiled. Raises RuntimeError when g++ is missing or fails."""
    global _load_failed
    if not force and is_current():
        return False
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native decoder "
                           f"({SOURCE}) is built with g++")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    _stamp().write_text(source_digest())
    _load_failed = False  # a load that found nothing before may find the library now
    return True


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not is_current():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        _load_failed = True
        return None
    lib.mmrp_preprocess.restype = ctypes.c_int
    lib.mmrp_preprocess.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ]
    lib.mmrp_preprocess_batch.restype = None
    lib.mmrp_preprocess_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mmrp_dicom_dims.restype = ctypes.c_int
    lib.mmrp_dicom_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mmrp_decode_raw.restype = ctypes.c_int
    lib.mmrp_decode_raw.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _library() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built (python -m mmrp_tpu_torch.data.native)")
    return lib


def preprocess(
    dicom_bytes: bytes,
    out_hw=(224, 224),
    mean: float = 0.5,
    std: float = 0.5,
    default_wc: float = 40.0,
    default_ww: float = 400.0,
) -> np.ndarray:
    """One DICOM blob -> (H, W) normalized float32. Raises on parse error."""
    lib = _library()
    oh, ow = out_hw
    out = np.empty((oh, ow), dtype=np.float32)
    rc = lib.mmrp_preprocess(
        dicom_bytes, len(dicom_bytes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        oh, ow, mean, std, default_wc, default_ww,
    )
    if rc != 0:
        raise ValueError(f"native DICOM preprocess failed (code {rc})")
    return out


def preprocess_batch(
    blobs: Sequence[bytes],
    out_hw=(224, 224),
    mean: float = 0.5,
    std: float = 0.5,
    default_wc: float = 40.0,
    default_ww: float = 400.0,
) -> tuple:
    """N blobs -> ((N, H, W) float32, status (N,) int32) via the worker pool."""
    lib = _library()
    n = len(blobs)
    oh, ow = out_hw
    out = np.empty((n, oh, ow), dtype=np.float32)
    status = np.empty(n, dtype=np.int32)
    buf_arr = (ctypes.c_char_p * n)(*blobs)
    len_arr = (ctypes.c_long * n)(*[len(b) for b in blobs])
    lib.mmrp_preprocess_batch(
        buf_arr, len_arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        oh, ow, mean, std, default_wc, default_ww,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out, status


def decode_raw(dicom_bytes: bytes) -> np.ndarray:
    """Decode + rescale only -> (rows, cols) float32."""
    lib = _library()
    rows, cols = ctypes.c_int(), ctypes.c_int()
    rc = lib.mmrp_dicom_dims(dicom_bytes, len(dicom_bytes),
                             ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError("native DICOM parse failed")
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    rc = lib.mmrp_decode_raw(
        dicom_bytes, len(dicom_bytes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError("native DICOM decode failed")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Build the library (``--force``: even when it is current)."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m mmrp_tpu_torch.data.native",
                                 description="build the native DICOM decoder with g++")
    ap.add_argument("--force", action="store_true", help="rebuild a current library")
    args = ap.parse_args(argv)
    built = build(force=args.force)
    print(f"{LIB_PATH} {'built' if built else 'is current'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
