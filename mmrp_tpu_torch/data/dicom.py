"""Self-contained DICOM reading + chest X-ray preprocessing.

Counterpart of ``mmrp_tpu/data/dicom.py`` (numpy only):

- a minimal, dependency-free DICOM Part-10 parser (implicit/explicit VR
  little endian, uncompressed PixelData) returning the handful of attributes
  the imaging path needs, and a writer of the same subset;
- the window/level + rescale + normalize math as pure numpy functions whose
  batched on-device equivalents live in ``mmrp_tpu_torch.ops.preprocess``;
- ``DICOMImagePreprocessor``, a file -> normalized (3, H, W) array.

``DICOMImagePreprocessor.load`` takes the port's C++ decoder
(``data/native.py``, built by ``python -m mmrp_tpu_torch.data.native``)
where that library is built, as the JAX package takes ``native/`` where
``libmmrp_io.so`` is built, and the Python path below everywhere else; the
two agree within one uint8 quantum after normalization (the resize edge
conventions differ slightly). ``_resize_bilinear`` uses cv2 where it imports
and its numpy fallback elsewhere, as in the JAX package.

Behavioral parity targets: window_image maps [center-width/2,
center+width/2] -> [0,1]; load_raw_array windows with the 0.5/99.5
percentiles after slope/intercept rescale; ``load`` replicates the
3-channel uint8 -> resize -> mean/std normalize pipeline.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Dict, Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Minimal DICOM parser
# ---------------------------------------------------------------------------

_IMPLICIT_VR_LE = "1.2.840.10008.1.2"
_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"

# VRs that use the 4-byte length form (with 2 reserved bytes) in explicit VR.
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"SQ", b"UT", b"UN", b"UC", b"UR"}

# Tags we extract. (group, element) -> attribute name.
_WANTED = {
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0101): "BitsStored",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1050): "WindowCenter",
    (0x0028, 0x1051): "WindowWidth",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x0010, 0x0020): "PatientID",
    (0x0008, 0x0018): "SOPInstanceUID",
    (0x7FE0, 0x0010): "PixelData",
}

_NUMERIC_STR_ATTRS = {
    "WindowCenter",
    "WindowWidth",
    "RescaleIntercept",
    "RescaleSlope",
}
_INT_ATTRS = {
    "Rows",
    "Columns",
    "SamplesPerPixel",
    "BitsAllocated",
    "BitsStored",
    "PixelRepresentation",
}


class DicomParseError(ValueError):
    pass


@dataclass
class DicomImage:
    """Decoded DICOM attributes relevant to X-ray preprocessing."""

    pixel_array: np.ndarray
    rows: int
    columns: int
    photometric: str = "MONOCHROME2"
    rescale_slope: float = 1.0
    rescale_intercept: float = 0.0
    window_center: Optional[float] = None
    window_width: Optional[float] = None
    extra: Dict[str, object] = field(default_factory=dict)


def _read_exact(fh: BinaryIO, n: int) -> bytes:
    b = fh.read(n)
    if len(b) != n:
        raise DicomParseError(f"truncated DICOM stream (wanted {n}, got {len(b)})")
    return b


def _parse_elements(buf: bytes, explicit: bool, wanted=_WANTED) -> Dict[str, object]:
    """Single pass over a little-endian element stream, collecting wanted tags."""
    out: Dict[str, object] = {}
    pos, end = 0, len(buf)
    while pos + 8 <= end:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                if pos + 8 > end:
                    raise DicomParseError("truncated element header")
                (length,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
            else:
                (length,) = struct.unpack_from("<H", buf, pos + 2)
                pos += 4
        else:
            vr = b"UN"
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4

        if length == 0xFFFFFFFF:
            # Undefined length (sequences / encapsulated data): scan for the
            # SequenceDelimitationItem tag (FFFE,E0DD) with 0 length.
            delim = struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
            idx = buf.find(delim, pos)
            if idx < 0:
                raise DicomParseError("unterminated undefined-length element")
            value_bytes = None  # sequences are skipped, not collected
            pos = idx + len(delim)
        else:
            if pos + length > end:
                raise DicomParseError("element length exceeds stream")
            value_bytes = buf[pos : pos + length]
            pos += length

        name = wanted.get((group, elem))
        if name is None or value_bytes is None:
            continue
        out[name] = value_bytes
    return out


def _decode_attr(name: str, raw: bytes) -> object:
    if name == "PixelData":
        return raw
    if name in _INT_ATTRS:
        if len(raw) == 2:
            return struct.unpack("<H", raw)[0]
        if len(raw) == 4:
            return struct.unpack("<I", raw)[0]
        return int(raw.decode("ascii", "ignore").strip() or 0)
    text = raw.decode("ascii", "ignore").strip().strip("\x00")
    if name in _NUMERIC_STR_ATTRS:
        # DS can be multi-valued ("40\\400"): take the first value, like the
        # reference's MultiValue handling (tensorDICOM.py:128-135).
        first = text.split("\\")[0].strip()
        try:
            return float(first)
        except ValueError:
            return None
    return text


def read_dicom(src: Union[str, Path, bytes, bytearray, BinaryIO]) -> DicomImage:
    """Parse a DICOM Part-10 file (implicit/explicit VR LE, raw PixelData)."""
    if isinstance(src, (str, Path)):
        with open(src, "rb") as fh:
            data = fh.read()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        data = src.read()

    if len(data) < 132 + 8:
        raise DicomParseError("file too small to be DICOM")
    if data[128:132] != b"DICM":
        # Some files omit the preamble; try parsing from byte 0 as implicit VR.
        body = data
        transfer_syntax = _IMPLICIT_VR_LE
    else:
        # File meta group (0002,xxxx) is always explicit VR LE. Parse meta
        # elements until the group changes.
        pos = 132
        meta: Dict[str, object] = {}
        transfer_syntax = _EXPLICIT_VR_LE
        while pos + 8 <= len(data):
            group, elem = struct.unpack_from("<HH", data, pos)
            if group != 0x0002:
                break
            vr = data[pos + 4 : pos + 6]
            if vr in _LONG_VRS:
                if pos + 12 > len(data):
                    raise DicomParseError("truncated file-meta element")
                (length,) = struct.unpack_from("<I", data, pos + 8)
                vstart = pos + 12
            else:
                (length,) = struct.unpack_from("<H", data, pos + 6)
                vstart = pos + 8
            value = data[vstart : vstart + length]
            if (group, elem) == (0x0002, 0x0010):
                transfer_syntax = value.decode("ascii", "ignore").strip().strip("\x00")
            pos = vstart + length
        body = data[pos:]

    if transfer_syntax == _IMPLICIT_VR_LE:
        explicit = False
    elif transfer_syntax == _EXPLICIT_VR_LE:
        explicit = True
    else:
        raise DicomParseError(
            f"unsupported transfer syntax {transfer_syntax!r} "
            "(only implicit/explicit VR little endian; compressed DICOM "
            "requires the native decode path)"
        )

    attrs = {k: _decode_attr(k, v) for k, v in _parse_elements(body, explicit).items()}

    rows = int(attrs.get("Rows", 0))
    cols = int(attrs.get("Columns", 0))
    pix = attrs.get("PixelData")
    if not rows or not cols or pix is None:
        raise DicomParseError("missing Rows/Columns/PixelData")

    bits = int(attrs.get("BitsAllocated", 16))
    signed = int(attrs.get("PixelRepresentation", 0)) == 1
    spp = int(attrs.get("SamplesPerPixel", 1))
    if bits == 8:
        dtype = np.int8 if signed else np.uint8
    elif bits == 16:
        dtype = np.int16 if signed else np.uint16
    else:
        raise DicomParseError(f"unsupported BitsAllocated={bits}")

    n_expected = rows * cols * spp
    arr = np.frombuffer(pix, dtype=dtype)[:n_expected]
    if arr.size != n_expected:
        raise DicomParseError("PixelData shorter than Rows*Columns")
    if spp == 1:
        arr = arr.reshape(rows, cols)
    else:
        arr = arr.reshape(rows, cols, spp)[..., 0]  # take first plane

    return DicomImage(
        pixel_array=np.asarray(arr),
        rows=rows,
        columns=cols,
        photometric=str(attrs.get("PhotometricInterpretation", "MONOCHROME2")),
        rescale_slope=float(attrs.get("RescaleSlope") or 1.0),
        rescale_intercept=float(attrs.get("RescaleIntercept") or 0.0),
        window_center=attrs.get("WindowCenter"),
        window_width=attrs.get("WindowWidth"),
        extra={
            k: attrs[k]
            for k in ("PatientID", "SOPInstanceUID")
            if k in attrs
        },
    )


# ---------------------------------------------------------------------------
# Synthetic DICOM writer (test fixtures; also documents the subset we parse)
# ---------------------------------------------------------------------------


def write_dicom(
    path: Union[str, Path, None],
    pixel_array: np.ndarray,
    *,
    window_center: Optional[float] = None,
    window_width: Optional[float] = None,
    rescale_slope: float = 1.0,
    rescale_intercept: float = 0.0,
    photometric: str = "MONOCHROME2",
) -> bytes:
    """Write a minimal explicit-VR-LE DICOM file (for fixtures/demos)."""
    arr = np.asarray(pixel_array)
    if arr.dtype not in (np.uint8, np.uint16, np.int16):
        arr = arr.astype(np.uint16)
    bits = arr.dtype.itemsize * 8
    signed = 1 if arr.dtype == np.int16 else 0
    rows, cols = arr.shape

    def elem_short(group, el, vr, value: bytes) -> bytes:
        if len(value) % 2:
            value += b"\x00" if vr != b"UI" else b"\x00"
        return struct.pack("<HH2sH", group, el, vr, len(value)) + value

    def elem_long(group, el, vr, value: bytes) -> bytes:
        if len(value) % 2:
            value += b"\x00"
        return struct.pack("<HH2sHI", group, el, vr, 0, len(value)) + value

    def ds(v: float) -> bytes:
        return f"{v:g}".encode()

    meta_body = elem_short(0x0002, 0x0010, b"UI", _EXPLICIT_VR_LE.encode())
    meta = elem_short(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body

    body = b""
    body += elem_short(0x0008, 0x0018, b"UI", b"1.2.3.4.5")
    body += elem_short(0x0010, 0x0020, b"LO", b"SYNTH")
    body += elem_short(0x0028, 0x0002, b"US", struct.pack("<H", 1))
    body += elem_short(0x0028, 0x0004, b"CS", photometric.encode())
    body += elem_short(0x0028, 0x0010, b"US", struct.pack("<H", rows))
    body += elem_short(0x0028, 0x0011, b"US", struct.pack("<H", cols))
    body += elem_short(0x0028, 0x0100, b"US", struct.pack("<H", bits))
    body += elem_short(0x0028, 0x0101, b"US", struct.pack("<H", bits))
    body += elem_short(0x0028, 0x0103, b"US", struct.pack("<H", signed))
    if window_center is not None:
        body += elem_short(0x0028, 0x1050, b"DS", ds(window_center))
    if window_width is not None:
        body += elem_short(0x0028, 0x1051, b"DS", ds(window_width))
    body += elem_short(0x0028, 0x1052, b"DS", ds(rescale_intercept))
    body += elem_short(0x0028, 0x1053, b"DS", ds(rescale_slope))
    pix = arr.astype("<" + arr.dtype.str[1:]).tobytes()
    vr = b"OB" if bits == 8 else b"OW"
    body += elem_long(0x7FE0, 0x0010, vr, pix)

    blob = b"\x00" * 128 + b"DICM" + meta + body
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


# ---------------------------------------------------------------------------
# Preprocessing math (numpy; batched on-device versions in ops/preprocess.py)
# ---------------------------------------------------------------------------


def window_image(
    pixel_array: np.ndarray, window_center: float, window_width: float
) -> np.ndarray:
    """Clip to [c-w/2, c+w/2] then scale to [0,1] (tensorDICOM.py:52-70)."""
    lower = window_center - window_width / 2.0
    upper = window_center + window_width / 2.0
    img = np.clip(pixel_array, lower, upper)
    return (img - lower) / (upper - lower)


def percentile_window(scaled: np.ndarray) -> np.ndarray:
    """Percentile (0.5/99.5) auto-windowing (tensorDICOM.py:99-110)."""
    pmin, pmax = np.percentile(scaled, [0.5, 99.5])
    wc = (pmin + pmax) / 2.0
    ww = pmax - pmin
    lower, upper = wc - ww / 2.0, wc + ww / 2.0
    win = np.clip(scaled, lower, upper)
    norm = (win - lower) / (upper - lower + 1e-8)
    return np.clip(norm, 0.0, 1.0)


def load_raw_array(src) -> np.ndarray:
    """Decode + rescale + percentile window -> (H, W) in [0,1]."""
    dcm = read_dicom(src)
    raw = dcm.pixel_array.astype(np.float32)
    scaled = raw * dcm.rescale_slope + dcm.rescale_intercept
    if dcm.photometric.upper().startswith("MONOCHROME1"):
        scaled = scaled.max() - scaled  # invert: MONOCHROME1 is white-is-low
    return percentile_window(scaled)


@dataclass
class DICOMImagePreprocessor:
    """DICOM -> normalized (3, H, W) float32 array.

    Parity with the reference preprocessor (tensorDICOM.py:9-161): explicit
    window center/width from the file (first value of multi-valued entries),
    defaults 40/400 when absent, 3-channel expansion through uint8, resize to
    ``output_size``, then mean/std normalization. Augmentation (rotation
    within ±5°, horizontal flip p=0.1) runs on the device in
    ``ops/preprocess.py``, which keeps the host path deterministic.
    """

    mean: Union[float, Tuple[float, float, float]] = 0.5
    std: Union[float, Tuple[float, float, float]] = 0.5
    default_window_center: float = 40.0
    default_window_width: float = 400.0
    output_size: Tuple[int, int] = (224, 224)
    use_native: bool = True  # C++ fast path where data/native.py's library is built

    def __post_init__(self) -> None:
        self.mean3 = np.asarray(
            [self.mean] * 3 if np.isscalar(self.mean) else list(self.mean),
            dtype=np.float32,
        )
        self.std3 = np.asarray(
            [self.std] * 3 if np.isscalar(self.std) else list(self.std),
            dtype=np.float32,
        )
        if self.mean3.shape != (3,) or self.std3.shape != (3,):
            raise ValueError("mean/std must be scalar or length-3")

    def load(self, src) -> np.ndarray:
        if self.use_native and float(self.mean3.std()) == 0 and float(self.std3.std()) == 0:
            from mmrp_tpu_torch.data import native

            if native.available():
                blob = (
                    bytes(src)
                    if isinstance(src, (bytes, bytearray))
                    else Path(src).read_bytes()
                )
                try:
                    gray = native.preprocess(
                        blob,
                        out_hw=self.output_size,
                        mean=float(self.mean3[0]),
                        std=float(self.std3[0]),
                        default_wc=self.default_window_center,
                        default_ww=self.default_window_width,
                    )
                    return np.repeat(gray[None, :, :], 3, axis=0)
                except ValueError:
                    pass  # unsupported file -> python path below
        dcm = read_dicom(src)
        wc = dcm.window_center if dcm.window_center is not None else self.default_window_center
        ww = dcm.window_width if dcm.window_width is not None else self.default_window_width
        windowed = window_image(dcm.pixel_array.astype(np.float32), wc, ww)
        if dcm.photometric.upper().startswith("MONOCHROME1"):
            windowed = 1.0 - windowed
        # Quantize through uint8 exactly like the reference's PIL round-trip
        # (tensorDICOM.py:149-151) so numerics line up.
        u8 = (windowed * 255.0).astype(np.uint8).astype(np.float32) / 255.0
        resized = _resize_bilinear(u8, self.output_size)
        chw = np.repeat(resized[None, :, :], 3, axis=0)
        return (chw - self.mean3[:, None, None]) / self.std3[:, None, None]

    def __call__(self, src) -> np.ndarray:
        return self.load(src)


def _resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with half-pixel centers (matches PIL/cv2 convention)."""
    try:
        import cv2

        return cv2.resize(
            img.astype(np.float32), (size[1], size[0]), interpolation=cv2.INTER_LINEAR
        )
    except ImportError:
        pass
    h, w = img.shape
    out_h, out_w = size
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (
        a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx
    ).astype(np.float32)
