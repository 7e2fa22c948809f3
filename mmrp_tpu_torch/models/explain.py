"""Explainability engine: attention maps, Integrated Gradients, Grad-CAM.

Counterpart of ``mmrp_tpu/models/explain.py`` on PyTorch autograd:

- **attention maps**: head- and layer-averaged cross-attention reductions
  (txt->img weighted by the token mask; img->txt salience), reshaped to the
  patch grid and bilinearly upsampled to image size; the final map blends
  0.6 * primary + 0.4 * secondary;
- **Integrated Gradients** over the backbone patch features: the backbone
  runs once, then a Python loop over chunks of ``chunk`` interpolation steps,
  folded into the batch, differentiates the projection + fusion + classifier
  head (the model's ``features=`` path), where JAX runs a ``lax.scan``.
  Pixel-level IG through the full model is ``integrated_gradients_pixels``;
- **Grad-CAM** at the projected-patch level via the model's ``patch_delta``
  hook; **token IG** via ``txt_delta``;
- map comparison metrics Pearson / Spearman / IoU@k% (:func:`compare_maps`,
  numpy).

On the card the head runs its kernels forward; a gradient goes through each
wrapper's gradient route (``ops/_build.py::KernelRecompute``: the kernel's
forward, the plain version's backward). The engine runs outside
``inference_mode`` with the model's parameters frozen for its calls, so
autograd differentiates only the delta or feature inputs.

The int8 serving mixes differentiate as JAX's do: the fusion stack's W8A8
GEMMs (``ops/quant.py::quant_dot``) through the per-row activation scale,
K3's W8A8 form and the dynamic whole-block forms by their straight-through
routes (the int8 forward, the unquantized backward). Attention maps, patch
IG, Grad-CAM and token IG differentiate only the head, so they run on every
mix. Pixel IG differentiates the Swin tower too: over ``serve_quant=
"int8_static"`` its static W8A8 blocks have no gradient, in JAX (no VJP,
``jax.grad`` raises) as here, and the call raises naming them. All outputs
are numpy arrays; maps are shaped (B, H, W) in [0, 1].
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _normalize01(m: torch.Tensor) -> torch.Tensor:
    lo = m.amin(dim=(-2, -1), keepdim=True)
    hi = m.amax(dim=(-2, -1), keepdim=True)
    return (m - lo) / torch.clamp(hi - lo, min=1e-8)


def patch_vector_to_map(v: torch.Tensor, grid: int, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., grid*grid) -> (..., H, W) bilinear upsample, minmax to [0,1].
    ``jax.image.resize(..., "bilinear")`` upsamples with half-pixel centres
    and no antialias: ``F.interpolate(align_corners=False)``."""
    lead = v.shape[:-1]
    m = v.reshape(-1, 1, grid, grid).float()
    m = F.interpolate(m, size=tuple(out_hw), mode="bilinear", align_corners=False)
    return _normalize01(m.reshape(tuple(lead) + tuple(out_hw)))


def _select_logits(logits: torch.Tensor, target_idx) -> torch.Tensor:
    """Scalar target -> one class for the whole batch; (B,) vector ->
    per-sample class."""
    t = torch.as_tensor(target_idx, device=logits.device)
    if t.ndim == 0:
        return logits[:, int(t)].sum()
    return torch.gather(logits, 1, t.long()[:, None]).sum()


def _attention_reductions(attn: Sequence[Dict[str, torch.Tensor]], tmask: torch.Tensor,
                          out_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Layer/head-averaged cross-attention maps (JAX ``_attention_reductions``):
    the patch map from txt2img (attention each patch receives, averaged over
    valid query tokens), the one from img2txt (per-patch max over tokens),
    their 0.6 / 0.4 blend, and the token vector (mass each token receives
    from patch queries, masked, max-normalized)."""
    n_patches = attn[0]["txt2img"].shape[-1]
    grid = int(round(n_patches ** 0.5))
    t2i = torch.stack([a["txt2img"] for a in attn]).mean(dim=(0, 2))  # (B, Lt, Np)
    Lt = t2i.shape[1]
    w = tmask[:, :Lt]
    t2i = (t2i * w[:, :, None]).sum(1) / torch.clamp(w.sum(1, keepdim=True), min=1.0)
    i2t = torch.stack([a["img2txt"] for a in attn]).mean(dim=(0, 2))  # (B, Np, Lt)
    i2t_patch = i2t.amax(dim=-1)
    primary = patch_vector_to_map(t2i, grid, out_hw)
    secondary = patch_vector_to_map(i2t_patch, grid, out_hw)
    final = _normalize01(0.6 * primary + 0.4 * secondary)
    tok = i2t.mean(dim=1) * w
    tok = tok / torch.clamp(tok.amax(dim=1, keepdim=True), min=1e-8)
    return {"attn_txt2img": primary, "attn_img2txt": secondary, "attn_final": final,
            "token_attention": tok}


def _resolve_chunk(n_steps: int, chunk: int) -> int:
    """Largest divisor of ``n_steps`` that is <= ``chunk`` (>= 1)."""
    c = max(1, min(int(chunk), int(n_steps)))
    while n_steps % c:
        c -= 1
    return c


def _alphas(n_steps: int, device) -> torch.Tensor:
    """The midpoints (i + 0.5) / n_steps in f32."""
    return (torch.arange(n_steps, dtype=torch.float32, device=device) + 0.5) / n_steps


def ig_patch_attribution(model, feats: Dict[str, torch.Tensor], ids: torch.Tensor,
                         mask: torch.Tensor, targets, n_steps: int, chunk: int = 1,
                         cls_global: bool = False) -> torch.Tensor:
    """Patch-level IG core: (B, Np) L1 attribution over the embed dim.

    The raw backbone patches interpolated from a zero baseline, the text
    features held fixed, only the ``features=`` head differentiated;
    ``chunk`` alphas (a divisor of ``n_steps``) per step, folded into the
    batch (effective batch ``chunk * B``). ``cls_global``: a backbone whose
    global is a CLS token, interpolated alongside the patches; otherwise the
    global is the patch mean."""
    patches = feats["img_patches"].float()
    g0 = feats["img_global"].float()
    B = patches.shape[0]
    k = int(chunk)
    if n_steps < 1 or n_steps % k:
        raise ValueError(f"chunk {k} must divide n_steps {n_steps} >= 1")

    def tile(x):
        return x.repeat(k, *([1] * (x.ndim - 1))) if k > 1 else x

    featsr = {key: tile(v) for key, v in feats.items()
              if key not in ("img_patches", "img_global")}
    idsr, maskr, g0r = tile(ids), tile(mask), tile(g0)
    t = torch.as_tensor(targets, device=patches.device)
    targetsr = t.repeat(k) if (k > 1 and t.ndim == 1) else t
    total = torch.zeros_like(patches)
    for alphas_k in _alphas(n_steps, patches.device).reshape(-1, k):
        ipr = (patches[None] * alphas_k[:, None, None, None]).reshape(
            (k * B,) + patches.shape[1:]).requires_grad_(True)
        a = alphas_k.repeat_interleave(B)[:, None]
        g = g0r * a if cls_global else ipr.mean(dim=1)
        o = model(None, idsr, maskr, features=dict(featsr, img_patches=ipr, img_global=g))
        (grad,) = torch.autograd.grad(_select_logits(o["logits"], targetsr), ipr)
        total = total + grad.reshape((k, B) + patches.shape[1:]).sum(0)
    return (patches * total / n_steps).abs().sum(-1)


def _grid_map(v: torch.Tensor, out_hw) -> torch.Tensor:
    return patch_vector_to_map(v, int(round(v.shape[-1] ** 0.5)), out_hw)


def _numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class ExplanationEngine:
    """Wraps a :class:`MultiModalRetrievalModel` (its serving dtype and
    device; eval mode). ``image_hw`` None: each input image's own H, W."""

    def __init__(self, model, image_hw: Optional[Tuple[int, int]] = None):
        self.model = model
        self.image_hw = image_hw
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _hw(self, image) -> Tuple[int, int]:
        return tuple(self.image_hw) if self.image_hw else tuple(np.shape(image)[1:3])

    @contextlib.contextmanager
    def _grad_call(self):
        """Autograd on (outside ``inference_mode``) with the parameters frozen,
        restored afterwards; one call at a time."""
        with self._lock:
            params = [p for p in self.model.parameters() if p.requires_grad]
            for p in params:
                p.requires_grad_(False)
            try:
                with torch.inference_mode(False), torch.enable_grad():
                    yield
            finally:
                for p in params:
                    p.requires_grad_(True)

    def _tensors(self, image, input_ids, attention_mask):
        dev = self.device
        img = None if image is None else torch.as_tensor(np.asarray(image, np.float32)).to(dev)
        ids = torch.as_tensor(np.asarray(input_ids, np.int64)).to(dev)
        mask = torch.as_tensor(np.asarray(attention_mask, np.int64)).to(dev)
        return img, ids, mask

    def _probe(self, img, ids, mask, **kw):
        """One forward without autograd (the backbones run once)."""
        with torch.no_grad():
            return self.model(img, ids, mask, return_features=True, **kw)

    # -- attention maps -------------------------------------------------------

    def attention_maps(self, image: np.ndarray, input_ids: np.ndarray,
                       attention_mask: np.ndarray) -> Dict[str, np.ndarray]:
        with self._grad_call():
            img, ids, mask = self._tensors(image, input_ids, attention_mask)
            with torch.no_grad():
                out = self.model(img, ids, mask, return_attention=True)
                maps = _attention_reductions(out["attention"], mask.float(), self._hw(image))
            return _numpy(maps)

    # -- integrated gradients -------------------------------------------------

    def integrated_gradients(self, image: np.ndarray, input_ids: np.ndarray,
                             attention_mask: np.ndarray, target, n_steps: int = 50,
                             chunk: int = 5) -> np.ndarray:
        """(B, H, W, 3) -> (B, H, W) attribution map, patch-feature IG
        (:func:`ig_patch_attribution`, ``chunk`` resolved to a divisor of
        ``n_steps``), grid-reshaped, upsampled and normalized."""
        with self._grad_call():
            img, ids, mask = self._tensors(image, input_ids, attention_mask)
            feats = self._probe(img, ids, mask)["features"]
            att = ig_patch_attribution(self.model, feats, ids, mask, target, n_steps,
                                       chunk=_resolve_chunk(n_steps, chunk),
                                       cls_global=self.model.config.vision_backbone == "vit")
            return _grid_map(att, self._hw(image)).cpu().numpy()

    def integrated_gradients_pixels(self, image: np.ndarray, input_ids: np.ndarray,
                                    attention_mask: np.ndarray, target,
                                    n_steps: int = 50) -> np.ndarray:
        """(B, H, W, 3) -> (B, H, W) pixel-level IG through the full model
        (``n_steps`` backbone forward and backward passes)."""
        with self._grad_call():
            img, ids, mask = self._tensors(image, input_ids, attention_mask)
            total = torch.zeros_like(img)
            for alpha in _alphas(n_steps, img.device):
                x = (img * alpha).requires_grad_(True)
                out = self.model(x, ids, mask)
                (grad,) = torch.autograd.grad(_select_logits(out["logits"], target), x)
                total = total + grad
            ig = img * total / n_steps
            return _normalize01(ig.abs().sum(-1)).cpu().numpy()

    # -- grad-cam -------------------------------------------------------------

    def _cam(self, feats, acts, ids, mask, target) -> torch.Tensor:
        """(B, Np) Grad-CAM: ReLU(sum_c mean-grad_c * act_c)."""
        delta = torch.zeros_like(acts).requires_grad_(True)
        out = self.model(None, ids, mask, features=feats, patch_delta=delta)
        (grads,) = torch.autograd.grad(_select_logits(out["logits"], target), delta)
        return torch.relu((grads.mean(dim=1, keepdim=True) * acts).sum(-1))

    def grad_cam(self, image: np.ndarray, input_ids: np.ndarray,
                 attention_mask: np.ndarray, target) -> np.ndarray:
        with self._grad_call():
            img, ids, mask = self._tensors(image, input_ids, attention_mask)
            probe = self._probe(img, ids, mask)
            cam = self._cam(probe["features"], probe["img_patches_proj"], ids, mask, target)
            return _grid_map(cam, self._hw(image)).cpu().numpy()

    # -- token-level attribution ----------------------------------------------

    def token_attribution(self, image: np.ndarray, input_ids: np.ndarray,
                          attention_mask: np.ndarray, target,
                          n_steps: int = 16) -> np.ndarray:
        """(B, Lt) normalized IG attribution over the projected text tokens,
        interpolated from 0 through the ``txt_delta`` offset."""
        with self._grad_call():
            img, ids, mask = self._tensors(image, input_ids, attention_mask)
            probe = self._probe(img, ids, mask)
            feats, tokens = probe["features"], probe["txt_tokens_proj"]
            total = torch.zeros_like(tokens)
            for alpha in _alphas(n_steps, tokens.device):
                delta = (tokens * (alpha - 1.0)).requires_grad_(True)
                out = self.model(None, ids, mask, features=feats, txt_delta=delta)
                (grad,) = torch.autograd.grad(_select_logits(out["logits"], target), delta)
                total = total + grad
            ig = (tokens * total / n_steps).sum(-1)
            ig = ig.abs() * mask[:, : ig.shape[1]]
            return (ig / torch.clamp(ig.amax(dim=1, keepdim=True), min=1e-8)).cpu().numpy()

    # -- one backbone forward for the detail panel ----------------------------

    def explain_batch(self, image: np.ndarray, input_ids: np.ndarray,
                      attention_mask: np.ndarray, n_steps: int = 50,
                      chunk: int = 10) -> Dict[str, np.ndarray]:
        """Everything the serve detail panel needs from ONE backbone forward:
        probs, joint_emb, per-sample top-1 targets, the attention maps, patch
        IG ("ig") and Grad-CAM ("grad_cam") for those targets."""
        out_hw = self._hw(image)
        with self._grad_call():
            img, ids, mask = self._tensors(image, input_ids, attention_mask)
            out = self._probe(img, ids, mask, return_attention=True)
            with torch.no_grad():
                maps = _attention_reductions(out["attention"], mask.float(), out_hw)
            targets = out["logits"].argmax(dim=1)
            feats = out["features"]
            att = ig_patch_attribution(self.model, feats, ids, mask, targets, n_steps,
                                       chunk=_resolve_chunk(n_steps, chunk),
                                       cls_global=self.model.config.vision_backbone == "vit")
            cam = self._cam(feats, out["img_patches_proj"], ids, mask, targets)
            return _numpy(dict(maps, probs=torch.sigmoid(out["logits"]),
                               joint_emb=out["joint_emb"], targets=targets,
                               ig=_grid_map(att, out_hw), grad_cam=_grid_map(cam, out_hw)))

    # -- orchestration --------------------------------------------------------

    def explain(self, image: np.ndarray, input_ids: np.ndarray, attention_mask: np.ndarray,
                targets: Sequence, ig_steps: int = 50, include_ig: bool = True,
                include_gradcam: bool = True) -> Dict[str, Any]:
        """The attention maps, and per target its IG and Grad-CAM maps: a
        scalar target explains one class for the whole batch (keyed by the
        class id); a (B,) vector each sample for its own class (keyed
        "rank{j}")."""
        maps = self.attention_maps(image, input_ids, attention_mask)
        per_target: Dict[Any, Dict[str, np.ndarray]] = {}
        for j, t in enumerate(targets):
            t_arr = np.asarray(t)
            scalar = t_arr.ndim == 0
            tgt = int(t_arr) if scalar else t_arr
            entry: Dict[str, np.ndarray] = {}
            if include_ig:
                entry["ig"] = self.integrated_gradients(image, input_ids, attention_mask, tgt,
                                                        ig_steps)
            if include_gradcam:
                entry["grad_cam"] = self.grad_cam(image, input_ids, attention_mask, tgt)
            per_target[int(t_arr) if scalar else f"rank{j}"] = entry
        return {"attention": maps, "per_target": per_target}


# ---------------------------------------------------------------------------
# Map comparison metrics (numpy, as the JAX package's)
# ---------------------------------------------------------------------------


def _rankdata(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sx = x[order]
    n = len(x)
    i = 0
    vals = np.arange(1, n + 1, dtype=np.float64)
    while i < n:
        j = i
        while j + 1 < n and sx[j + 1] == sx[i]:
            j += 1
        vals[i : j + 1] = (i + j + 2) / 2.0
        i = j + 1
    ranks[order] = vals
    return ranks


def compare_maps(a: np.ndarray, b: np.ndarray, ious=(0.05, 0.2)) -> Dict[str, float]:
    """Pearson, Spearman, IoU of the top-k% pixels of two saliency maps."""
    fa, fb = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    out: Dict[str, float] = {}
    if fa.std() < 1e-12 or fb.std() < 1e-12:
        out["pearson"] = float("nan")
        out["spearman"] = float("nan")
    else:
        out["pearson"] = float(np.corrcoef(fa, fb)[0, 1])
        out["spearman"] = float(np.corrcoef(_rankdata(fa), _rankdata(fb))[0, 1])
    n = fa.size
    for frac in ious:
        k = max(1, int(n * frac))
        ta = set(np.argpartition(-fa, k - 1)[:k].tolist())
        tb = set(np.argpartition(-fb, k - 1)[:k].tolist())
        out[f"iou@{int(frac*100)}%"] = len(ta & tb) / len(ta | tb)
    return out
