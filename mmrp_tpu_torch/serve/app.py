"""Interactive web demo: upload a DICOM + optional text -> predictions,
retrieval, and explanation overlays.

Functional parity with the reference Flask app (reference:
src/web/app.py:49-638): the ``GET/POST /`` form accepts a DICOM file, an
optional text query, and a probability threshold; the response renders
top-K label predictions with per-class probabilities, the retrieval list,
attention / IG / Grad-CAM overlays as base64 PNGs, token-level attention,
and attention-vs-IG/Grad-CAM agreement metrics, with optional per-retrieved
-item detail. Heavy resources initialize lazily on first request
(app.py:99-142).

A copy of ``mmrp_tpu/serve/app.py`` over the port's predictor: a
dependency-free ``http.server`` app, with a JSON API (``POST /api/predict``)
beside the HTML form. PIL is imported only to render PNG overlays, which the
JSON API does not need. Start it on a run directory with

    python -m mmrp_tpu_torch.serve.app RUN_DIR [--port 8000] [--data DATA_DIR]

(the counterpart of ``python -m mmrp_tpu.cli serve --run-dir RUN_DIR``).
"""

from __future__ import annotations

import base64
import html
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from mmrp_tpu_torch.models.explain import compare_maps


def _png_base64(img01: np.ndarray, overlay: Optional[np.ndarray] = None) -> str:
    """Grayscale image in [0,1] (+ optional heatmap overlay) -> base64 PNG."""
    from PIL import Image

    g = np.clip(img01, 0, 1)
    rgb = np.stack([g, g, g], axis=-1)
    if overlay is not None:
        h = np.clip(overlay, 0, 1)
        heat = np.stack([h, 0.2 * h, 1.0 - h], axis=-1)  # blue->red ramp
        rgb = np.clip(0.55 * rgb + 0.45 * heat, 0, 1)
    im = Image.fromarray((rgb * 255).astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def token_attention_html(tokens, weights) -> str:
    """Token heat styling (reference helper.py:334-355)."""
    spans = []
    for t, w in zip(tokens, weights):
        t = html.escape(t)
        alpha = float(np.clip(w, 0, 1))
        spans.append(
            f'<span style="background: rgba(255,80,80,{alpha:.2f});'
            f' padding:1px; border-radius:2px">{t}</span>'
        )
    return " ".join(spans)


class DemoContext:
    """Lazily-initialized heavy resources (reference app.py:99-142)."""

    def __init__(self, build_fn: Callable[[], Dict[str, Any]]):
        self._build_fn = build_fn
        self._lock = threading.Lock()
        self._res: Optional[Dict[str, Any]] = None

    @property
    def res(self) -> Dict[str, Any]:
        with self._lock:
            if self._res is None:
                self._res = self._build_fn()
            return self._res


_FORM = """<!doctype html><html><head><title>mmrp-tpu demo</title>
<style>body{{font-family:sans-serif;max-width:1100px;margin:2em auto}}
.card{{border:1px solid #ccc;border-radius:8px;padding:1em;margin:1em 0}}
img{{max-width:280px;border-radius:4px}}
table{{border-collapse:collapse}} td,th{{border:1px solid #ddd;padding:4px 8px}}
</style></head><body>
<h1>Chest X-ray multi-modal retrieval &amp; prediction</h1>
<form method="post" enctype="multipart/form-data" action="/">
 <div class="card">
  <label>DICOM file <input type="file" name="dicom_file" required></label><br><br>
  <label>Text query <input type="text" name="text_query" size="60"></label><br><br>
  <label>Threshold <input type="number" name="threshold"
     placeholder="calibrated" step="0.05" min="0" max="1"></label>
  <label><input type="checkbox" name="show_retrieval_detail"> retrieval detail</label>
  <button type="submit">Analyze</button>
 </div>
</form>
{results}
</body></html>"""


def render_results(payload: Dict[str, Any]) -> str:
    if not payload:
        return ""
    parts = ['<div class="card"><h2>Predictions</h2><table>'
             "<tr><th>label</th><th>probability</th></tr>"]
    for name, p in payload.get("top_labels", []):
        parts.append(f"<tr><td>{html.escape(name)}</td><td>{p:.3f}</td></tr>")
    parts.append("</table></div>")

    if payload.get("images"):
        parts.append('<div class="card"><h2>Explanations</h2>')
        for title, b64 in payload["images"].items():
            parts.append(
                f"<div style='display:inline-block;margin:4px'><h4>{html.escape(title)}</h4>"
                f"<img src='data:image/png;base64,{b64}'></div>"
            )
        parts.append("</div>")

    if payload.get("token_html"):
        parts.append(
            f'<div class="card"><h2>Token attention</h2>{payload["token_html"]}</div>'
        )

    if payload.get("agreement"):
        parts.append('<div class="card"><h2>Map agreement (attention vs)</h2><table>'
                     "<tr><th>pair</th><th>pearson</th><th>spearman</th>"
                     "<th>IoU@5%</th><th>IoU@20%</th></tr>")
        for pair, m in payload["agreement"].items():
            parts.append(
                f"<tr><td>{pair}</td><td>{m.get('pearson', float('nan')):.3f}</td>"
                f"<td>{m.get('spearman', float('nan')):.3f}</td>"
                f"<td>{m.get('iou@5%', 0):.3f}</td><td>{m.get('iou@20%', 0):.3f}</td></tr>"
            )
        parts.append("</table></div>")

    if payload.get("retrieval"):
        parts.append('<div class="card"><h2>Similar cases</h2><ol>')
        for rid, score in payload["retrieval"]:
            parts.append(f"<li>{html.escape(str(rid))} — {score:.4f}</li>")
        parts.append("</ol></div>")
    if payload.get("retrieval_detail"):
        parts.append('<div class="card"><h2>Retrieved case detail</h2>')
        for d in payload["retrieval_detail"]:
            cm = d["cross_map"]
            top = ", ".join(
                f"{html.escape(n)} {p:.2f}" for n, p in d.get("top_labels", [])[:3]
            )
            imgs = "".join(
                f"<img src='data:image/png;base64,{d[k]}' title='{k}'>"
                for k in ("overlay", "overlay_ig", "overlay_gradcam") if d.get(k)
            )
            ag = d.get("agreement", {}).get("attn_vs_ig", {})
            parts.append(
                f"<div style='margin:6px'>"
                f"<h4>{html.escape(str(d['id']))} ({d['score']:.3f})</h4>"
                f"{imgs}"
                f"<br><small>{top}</small>"
                f"<br><small>vs query: pearson {cm.get('pearson', float('nan')):.2f} · "
                f"IoU@20% {cm.get('iou@20%', 0):.2f} · "
                f"attn-vs-IG pearson {ag.get('pearson', float('nan')):.2f}</small></div>"
            )
        if payload.get("retrieval_diversity") is not None:
            parts.append(
                f"<p>retrieved-set embedding diversity: "
                f"{payload['retrieval_diversity']:.3f}</p>"
            )
        parts.append("</div>")
    if payload.get("latency_ms") is not None:
        parts.append(f"<p>predict+explain latency: {payload['latency_ms']:.1f} ms</p>")
    return "\n".join(parts)


def run_inference(ctx: DemoContext, dicom_bytes: bytes, text: str,
                  threshold: Optional[float], detail: bool = False,
                  render_images: bool = True) -> Dict[str, Any]:
    """``threshold=None`` -> the run's per-class calibrated thresholds
    (api.py:predict). ``render_images=False`` (JSON API) skips the PNG
    base64 overlays and token HTML the JSON response never carried —
    agreement/cross-map metrics still compute from the raw maps."""
    import time

    res = ctx.res
    t0 = time.perf_counter()
    pp = res["preprocessor"]
    tok = res["tokenizer"]
    predictor = res["predictor"]
    max_len = res.get("max_length", 64)

    chw = pp.load(dicom_bytes)  # (3, H, W)
    img = np.transpose(chw, (1, 2, 0))[None].astype(np.float32)
    ids, mask = tok.encode(text or "", max_length=max_len)
    ids, mask = ids[None], mask[None]

    out = predictor.predict(img, ids, mask, K=5, threshold=threshold,
                            explain=True)
    exp = out["explanation"]
    attn = exp["attention"]
    base = (img[0, :, :, 0] + 1.0) / 2.0  # un-normalize for display

    images = {}
    if render_images:
        images["attention"] = _png_base64(base, attn["attn_final"][0])
    agreement = {}
    if exp["per_target"]:
        t = next(iter(exp["per_target"]))
        maps = exp["per_target"][t]
        if "ig" in maps:
            if render_images:
                images["integrated_gradients"] = _png_base64(base, maps["ig"][0])
            agreement["attn_vs_ig"] = compare_maps(attn["attn_final"][0], maps["ig"][0])
        if "grad_cam" in maps:
            if render_images:
                images["grad_cam"] = _png_base64(base, maps["grad_cam"][0])
            agreement["attn_vs_gradcam"] = compare_maps(
                attn["attn_final"][0], maps["grad_cam"][0]
            )

    payload = {
        "top_labels": out["top_labels"][0],
        "predicted": out["predicted"][0],
        "retrieval": out.get("retrieval", [[]])[0],
        "agreement": agreement,
        "latency_ms": (time.perf_counter() - t0) * 1e3,
    }
    if render_images:
        tokens = [tok.inv_vocab.get(int(i), "?")
                  for i in ids[0] if int(i) != tok.pad_id]
        payload["images"] = images
        payload["token_html"] = token_attention_html(
            tokens, attn["token_attention"][0][: len(tokens)]
        )

    # per-retrieved-item FULL explain (attention + IG + Grad-CAM + agreement)
    # + cross-image map comparisons + diversity (reference app.py:449-630).
    # The reference re-runs predict(explain=True) sequentially per item; here
    # all K items go through each explain program as ONE batch, with
    # per-sample IG/Grad-CAM targets (models/explain.py::_select_logits).
    if detail and res.get("records_by_id"):
        from mmrp_tpu_torch.eval.diversity import embedding_diversity, label_diversity

        q_map = attn["attn_final"][0]
        items, imgs, idss, masks = [], [], [], []
        for rid, score in payload["retrieval"][:5]:
            rec = res["records_by_id"].get(rid)
            if rec is None:
                continue
            try:
                r_chw = pp.load(rec["dicom_path"])
            except (ValueError, OSError):
                continue
            r_ids, r_mask = tok.encode(rec.get("report_text", ""), max_length=max_len)
            items.append((rid, float(score), rec))
            imgs.append(np.transpose(r_chw, (1, 2, 0)).astype(np.float32))
            idss.append(r_ids)
            masks.append(r_mask)
        details = []
        if items:
            r_img = np.stack(imgs)
            r_ids = np.stack(idss)
            r_mask = np.stack(masks)
            # ONE backbone forward seeds probs, embeddings, attention, IG
            # (per-item top-1 targets in-graph) and Grad-CAM — vs four
            # (embed + attn + IG probe + CAM probe)
            full = predictor.explainer.explain_batch(r_img, r_ids, r_mask)
            r_probs, r_ig, r_cam = full["probs"], full["ig"], full["grad_cam"]
            names = predictor.label_names
            for b, (rid, score, rec) in enumerate(items):
                r_base = (r_img[b, :, :, 0] + 1.0) / 2.0
                fin = full["attn_final"][b]
                order = np.argsort(-r_probs[b])[:5]
                d = {
                    "id": rid,
                    "score": score,
                    "top_labels": [(names[i], float(r_probs[b, i]))
                                   for i in order],
                    "agreement": {
                        "attn_vs_ig": compare_maps(fin, r_ig[b]),
                        "attn_vs_gradcam": compare_maps(fin, r_cam[b]),
                    },
                    "cross_map": compare_maps(q_map, fin),
                    "cross_map_ig": compare_maps(q_map, r_ig[b]),
                }
                if render_images:
                    d["overlay"] = _png_base64(r_base, fin)
                    d["overlay_ig"] = _png_base64(r_base, r_ig[b])
                    d["overlay_gradcam"] = _png_base64(r_base, r_cam[b])
                details.append(d)
            payload["retrieval_detail"] = details
            if len(items) >= 2:
                payload["retrieval_diversity"] = embedding_diversity(
                    full["joint_emb"][: len(items)]
                )
                lbls = [rec.get("labels") for _, _, rec in items]
                if all(l is not None for l in lbls):
                    payload["retrieval_label_diversity"] = label_diversity(
                        np.stack([np.asarray(l) for l in lbls])
                    )
        else:
            payload["retrieval_detail"] = details
    return payload


def make_handler(ctx: DemoContext):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _FORM.format(results="").encode())
            elif self.path == "/health":
                self._send(200, b'{"status":"ok"}', "application/json")
            else:
                self._send(404, b"not found")

        MAX_BODY = 64 * 1024 * 1024  # DICOM uploads are < a few MB

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, b"bad Content-Length")
                return
            if length <= 0:
                self._send(400, b"empty body")
                return
            if length > self.MAX_BODY:
                self._send(413, b"body too large")
                return
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            try:
                if self.path == "/api/predict":
                    try:
                        req = json.loads(body)
                        dicom = base64.b64decode(req["dicom_b64"], validate=True)
                        if not dicom:
                            raise ValueError("empty dicom payload")
                        # absent/blank threshold -> None -> the run's
                        # per-class calibrated thresholds (api.py:predict)
                        t_raw = req.get("threshold")
                        threshold = (None if t_raw in (None, "")
                                     else float(t_raw))
                        detail = bool(req.get("detail", False))
                    except (ValueError, KeyError, TypeError) as e:
                        self._send(
                            400, f"bad request: {html.escape(repr(e))}".encode()
                        )
                        return
                    try:
                        payload = run_inference(
                            ctx, dicom, req.get("text", ""), threshold,
                            detail=detail, render_images=False,
                        )
                    except ValueError as e:
                        # malformed upload is a client fault, not a 500.
                        # The decode path's clean-failure contract is
                        # ValueError (DicomParseError subclasses it, but
                        # np.frombuffer/int() on corrupt fields raise the
                        # plain class — tests/test_dicom_fuzz.py).
                        self._send(
                            400, f"bad dicom: {html.escape(repr(e))}".encode()
                        )
                        return
                    self._send(200, json.dumps(payload, default=float).encode(),
                               "application/json")
                    return
                # multipart form
                try:
                    fields = _parse_multipart(body, ctype)
                    if "dicom_file" not in fields:
                        raise KeyError("dicom_file field missing")
                    t_raw = fields.get("threshold", b"").strip()
                    threshold = float(t_raw) if t_raw else None
                except (ValueError, KeyError) as e:
                    self._send(400, f"bad upload: {html.escape(repr(e))}".encode())
                    return
                try:
                    payload = run_inference(
                        ctx,
                        fields["dicom_file"],
                        fields.get("text_query", b"").decode("utf-8", "ignore"),
                        threshold,
                        detail=b"show_retrieval_detail" in fields,
                    )
                except ValueError as e:  # decode clean-failure contract
                    self._send(400, f"bad dicom: {html.escape(repr(e))}".encode())
                    return
                html_page = _FORM.format(results=render_results(payload))
                self._send(200, html_page.encode())
            except Exception as e:  # noqa: BLE001 — demo surface
                self._send(500, f"error: {html.escape(repr(e))}".encode())

    return Handler


def _parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    """Minimal multipart/form-data parser (no cgi module in py3.13+).

    Boundary extraction handles RFC 2046 quoted boundaries and trailing
    Content-Type parameters. Part content is delimited EXACTLY: only the
    single CRLF preceding the next boundary is consumed (as part of the
    delimiter), never stripped byte-classes — a binary DICOM whose
    PixelData ends in 0x0A/0x0D/0x2D must arrive intact."""
    boundary = None
    for param in content_type.split(";"):
        k, _, v = param.strip().partition("=")
        if k.lower() == "boundary":
            v = v.strip()
            if len(v) >= 2 and v[0] == v[-1] == '"':
                v = v[1:-1]
            boundary = v.encode()
    if not boundary:
        raise ValueError("not multipart")
    delim = b"\r\n--" + boundary
    fields: Dict[str, bytes] = {}
    # prepend CRLF so the leading boundary matches the same delimiter
    for part in (b"\r\n" + body).split(delim)[1:]:
        if part.startswith(b"--"):  # closing delimiter
            break
        if not part.startswith(b"\r\n"):
            continue
        head, sep, data = part[2:].partition(b"\r\n\r\n")
        if not sep:
            continue
        name = None
        for line in head.split(b"\r\n"):
            if b"Content-Disposition" in line and b'name="' in line:
                name = line.split(b'name="')[1].split(b'"')[0].decode()
        if name:
            fields[name] = data
    return fields


def serve(build_fn: Callable[[], Dict[str, Any]], port: int = 8000,
          block: bool = True, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    ctx = DemoContext(build_fn)
    server = ThreadingHTTPServer((host, port), make_handler(ctx))
    if block:
        print(f"[serve] listening on :{port}")
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Serve the demo for a training-run directory on the card (``--device``
    names another, e.g. cpu)."""
    import argparse

    from mmrp_tpu_torch.device import DEFAULT_DEVICE
    from mmrp_tpu_torch.serve.runner import build_demo_context

    ap = argparse.ArgumentParser(prog="python -m mmrp_tpu_torch.serve.app",
                                 description="web demo of a training-run directory")
    ap.add_argument("run_dir")
    ap.add_argument("--data", default=None, help="data dir holding records_cache.json")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    serve(lambda: build_demo_context(args.run_dir, data_dir=args.data, device=args.device),
          port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
