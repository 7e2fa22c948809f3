"""Visualization utilities: heatmap overlays + report artifacts.

Parity with the reference viz helpers (reference: src/Helpers/helper.py:
219-332 — heatmap->overlay rendering and per-query overlay PNG saving;
:334-355 token-attention HTML lives in serve/app.py); a copy of
``mmrp_tpu/utils/viz.py``. PIL is imported where a PNG is written.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np


def overlay_rgb(gray01: np.ndarray, heat01: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """Grayscale [0,1] + heatmap [0,1] -> (H, W, 3) float blend."""
    g = np.clip(gray01, 0, 1)
    h = np.clip(heat01, 0, 1)
    if h.shape != g.shape:
        from mmrp_tpu_torch.data.dicom import _resize_bilinear

        h = _resize_bilinear(h.astype(np.float32), g.shape)
    base = np.stack([g, g, g], axis=-1)
    heat = np.stack([h, 0.2 * h, 1.0 - h], axis=-1)
    return np.clip((1 - alpha) * base + alpha * heat, 0, 1)


def save_overlay_png(path: str, gray01: np.ndarray, heat01: np.ndarray) -> None:
    from PIL import Image

    rgb = (overlay_rgb(gray01, heat01) * 255).astype(np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rgb).save(path)


def save_query_overlays(
    out_dir: str,
    query_id: str,
    gray01: np.ndarray,
    maps: Dict[str, np.ndarray],
    result_id: Optional[str] = None,
) -> Dict[str, str]:
    """One PNG per map type, named <qid>[_<rid>]_<map>.png
    (reference helper.py:288-332)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = {}
    stem = query_id if result_id is None else f"{query_id}_{result_id}"
    for name, m in maps.items():
        p = out / f"{stem}_{name}.png"
        save_overlay_png(str(p), gray01, m)
        written[name] = str(p)
    return written
