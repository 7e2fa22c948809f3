"""The plain float32 forward of the retrieval model, written from the
architecture: the vision tower of the configuration's ``vision.kind``
(``vision/<kind>.py``: Swin, Liu et al. 2021, or MedCLIP's Swin-T with its
projection, Wang et al. 2022, on the Swin primitives here), a post-LN BERT,
the cross-modal fusion stack of the reference's ``configs/config.yaml`` and
the 43-label head.

It reads its widths from the benchmark's configuration file and its weights
from a dict of tensors under the parameter names of the weight format the
benchmark writes (the served model's state dict: nn.Linear weights are
(out, in); a Swin block's ``qkv`` rows are [q | k | v], each head's columns
together; PatchEmbed is one GEMM over (kh, kw, in)-flattened patches; patch
merging concatenates the 2 x 2 neighbours in (row, column) order). Nothing
of the program is imported: every table (relative positions, shifted-window
masks, sinusoidal positions) is built here again.

``quant``, when given, is applied to both operands of every GEMM: the
control's lower precision (``reference/quant.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

Weights = Mapping[str, torch.Tensor]
NEG = -1e9  # additive mask of a key that may not be attended


class Ref:
    """The reference forward over one weight dict."""

    def __init__(self, cfg: Mapping, weights: Weights, quant: Optional[Callable] = None):
        self.cfg = cfg
        self.w = weights
        self.quant = quant
        self._tables: Dict = {}

    # --- primitives --------------------------------------------------------

    def lin(self, x, name: str, bias: bool = True):
        w = self.w[f"{name}.weight"]
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = x @ w.t()
        return y + self.w[f"{name}.bias"] if bias else y

    def ln(self, x, name: str):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], 1e-6)

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))

    def mha(self, q, k, v, heads: int, key_mask=None, bias=None):
        """q (..., Lq, D), k / v (..., Lk, D) -> (..., Lq, D); ``key_mask``
        (B, Lk) 0/1; ``bias`` added to the (.., h, Lq, Lk) scores."""
        *lead, Lq, D = q.shape
        d = D // heads
        q = q.reshape(*lead, Lq, heads, d).transpose(-2, -3)
        k = k.reshape(*lead, -1, heads, d).transpose(-2, -3)
        v = v.reshape(*lead, -1, heads, d).transpose(-2, -3)
        if self.quant is not None:
            q, k = self.quant(q), self.quant(k)
        s = (q @ k.transpose(-1, -2)) * d ** -0.5
        if bias is not None:
            s = s + bias
        if key_mask is not None:
            s = s + torch.where(key_mask > 0, 0.0, NEG).to(s.dtype)[:, None, None, :]
        p = torch.softmax(s, dim=-1)
        if self.quant is not None:
            p, v = self.quant(p), self.quant(v)
        return (p @ v).transpose(-2, -3).reshape(*lead, Lq, D)

    # --- Swin ----------------------------------------------------------------

    def _rel_index(self, ws: int, device):
        key = ("rel", ws, device)
        if key not in self._tables:
            c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
            rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
            idx = rel[..., 0] * (2 * ws - 1) + rel[..., 1]
            self._tables[key] = torch.from_numpy(idx.reshape(-1)).to(device)
        return self._tables[key]

    def _shift_mask(self, res: int, ws: int, s: int, device):
        key = ("mask", res, ws, s, device)
        if key not in self._tables:
            img = np.zeros((res, res), np.int64)
            cuts = (slice(0, -ws), slice(-ws, -s), slice(-s, None))
            n = 0
            for a in cuts:
                for b in cuts:
                    img[a, b] = n
                    n += 1
            win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3)
            win = win.reshape(-1, ws * ws)
            m = np.where(win[:, :, None] != win[:, None, :], NEG, 0.0).astype(np.float32)
            self._tables[key] = torch.from_numpy(m).to(device)
        return self._tables[key]

    def swin_block(self, x, p: str, heads: int, ws: int, shift: int):
        B, H, W, C = x.shape
        N = ws * ws
        y = self.ln(x, f"{p}.LayerNorm_0")
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        y = y.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(B, -1, N, C)
        qkv = self.lin(y, f"{p}.attn.qkv")
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        table = self.w[f"{p}.attn.rel_bias_table"]
        bias = table[self._rel_index(ws, x.device)].reshape(N, N, heads).permute(2, 0, 1)
        if shift:
            bias = bias[None] + self._shift_mask(H, ws, shift, x.device)[:, None]
        o = self.lin(self.mha(q, k, v, heads, bias=bias), f"{p}.attn.proj")
        o = o.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        o = o.reshape(B, H, W, C)
        if shift:
            o = torch.roll(o, (shift, shift), (1, 2))
        x = x + o
        y = self.ln(x, f"{p}.LayerNorm_1")
        return x + self.lin(self.gelu(self.lin(y, f"{p}.mlp.Dense_0")), f"{p}.mlp.Dense_1")

    def swin(self, image, p: str):
        """NHWC image -> (patches (B, Np, F), global (B, F))."""
        v = self.cfg["vision"]
        ps = v["patch_size"]
        B, H, W, C = image.shape
        x = image.reshape(B, H // ps, ps, W // ps, ps, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // ps, W // ps, ps * ps * C)
        x = self.ln(self.lin(x, f"{p}.patch_embed.proj"), f"{p}.patch_embed.LayerNorm_0")
        depths = v["depths"]
        for stage, depth in enumerate(depths):
            res = x.shape[1]
            ws = min(v["window_size"], res)
            for blk in range(depth):
                shift = ws // 2 if blk % 2 and res > ws else 0
                x = self.swin_block(x, f"{p}.stage{stage}_block{blk}", v["num_heads"][stage],
                                    ws, shift)
            if stage < len(depths) - 1:
                B, H, W, C = x.shape
                x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
                x = x.reshape(B, H // 2, W // 2, 4 * C)
                x = self.lin(self.ln(x, f"{p}.merge{stage}.LayerNorm_0"),
                             f"{p}.merge{stage}.Dense_0", bias=False)
        x = self.ln(x, f"{p}.norm")
        patches = x.reshape(x.shape[0], -1, x.shape[-1])
        return patches, patches.mean(dim=1)

    def vision(self, image):
        """The tower of the file's ``vision.kind`` (``vision/<kind>.py``)."""
        from mmrp_bench.harness import vision_kind

        return vision_kind(self.cfg["vision"]["kind"]).reference(self, image)

    # --- BERT ----------------------------------------------------------------

    def text(self, ids, mask):
        t = self.cfg["text"]
        ids, mask = ids[:, : t["max_positions"]], mask[:, : t["max_positions"]]
        e = "backbones.text.embeddings"
        L = ids.shape[1]
        x = (self.w[f"{e}.word.weight"][ids] + self.w[f"{e}.position.weight"][:L][None]
             + self.w[f"{e}.token_type.weight"][0])
        x = self.ln(x, f"{e}.LayerNorm_0")
        for i in range(t["num_layers"]):
            p = f"backbones.text.layer{i}"
            a = f"{p}.attention"
            ctx = self.mha(self.lin(x, f"{a}.query"), self.lin(x, f"{a}.key"),
                           self.lin(x, f"{a}.value"), t["num_heads"], key_mask=mask)
            x = self.ln(x + self.lin(ctx, f"{a}.out"), f"{p}.attn_norm")
            y = self.lin(self.gelu(self.lin(x, f"{p}.ffn_in")), f"{p}.ffn_out")
            x = self.ln(x + y, f"{p}.ffn_norm")
        return x, x[:, 0]

    # --- fusion and head -----------------------------------------------------

    def _sinusoid(self, n: int, dim: int, device):
        key = ("sin", n, dim, device)
        if key not in self._tables:
            pos = np.arange(n)[:, None].astype(np.float64)
            div = np.exp(np.arange((dim + 1) // 2) * (-2.0 * np.log(10000.0) / dim))
            tab = np.zeros((n, dim), np.float32)
            tab[:, 0::2] = np.sin(pos * div)
            tab[:, 1::2] = np.cos(pos * div[: dim // 2])
            self._tables[key] = torch.from_numpy(tab).to(device)
        return self._tables[key]

    def enhancer(self, x, p: str, heads: int, mask=None):
        """x + alpha * MHA(LN(x + pos))."""
        y = self.ln(x + self.w[f"{p}.pos_embed"][0, : x.shape[1]], f"{p}.LayerNorm_0")
        a = f"{p}.attention"
        ctx = self.mha(self.lin(y, f"{a}.query"), self.lin(y, f"{a}.key"),
                       self.lin(y, f"{a}.value"), heads, key_mask=mask)
        return x + self.w[f"{p}.alpha"] * self.lin(ctx, f"{a}.out")

    def cross(self, q_in, kv_in, p: str, norm: str, heads: int, mask=None):
        """LN(q_in + MHA(q_in, kv_in))."""
        ctx = self.mha(self.lin(q_in, f"{p}.q"), self.lin(kv_in, f"{p}.k"),
                       self.lin(kv_in, f"{p}.v"), heads, key_mask=mask)
        return self.ln(q_in + self.lin(ctx, f"{p}.out"), norm)

    def fusion_layer(self, i: int, img_patches, img_global, txt_tokens, txt_mask):
        heads = self.cfg["fusion"]["num_heads"]
        p = f"fusion_layer{i}"
        f = f"{p}.fusion"
        txt_e = self.enhancer(txt_tokens, f"{f}.txt_enh", heads, txt_mask)
        pat_e = self.enhancer(img_patches, f"{f}.img_enh", heads)
        txt = self.cross(txt_e, pat_e, f"{f}.txt2img", f"{f}.txt_norm", heads)
        patches = self.cross(pat_e, txt_e, f"{f}.img2txt", f"{f}.img_norm", heads, txt_mask)
        w = txt_mask.to(txt.dtype)
        pooled = (txt * w[:, :, None]).sum(1) / torch.clamp(w.sum(1, keepdim=True), min=1.0)
        cls = self.lin(torch.cat([img_global, pooled], -1), f"{f}.cls_proj")
        seq = torch.cat([cls[:, None], patches, pooled[:, None]], 1)
        seq = seq + self._sinusoid(seq.shape[1], seq.shape[2], seq.device)
        y = self.ln(seq, f"{p}.LayerNorm_0")
        a = f"{p}.attention"
        ctx = self.mha(self.lin(y, f"{a}.query"), self.lin(y, f"{a}.key"),
                       self.lin(y, f"{a}.value"), heads)
        seq = seq + self.lin(ctx, f"{a}.out")
        y = self.ln(seq, f"{p}.LayerNorm_1")
        seq = seq + self.lin(self.gelu(self.lin(y, f"{p}.ffn.Dense_0")), f"{p}.ffn.Dense_1")
        a = self.lin(self.gelu(self.lin(seq, f"{p}.adapter_down")), f"{p}.adapter_up")
        return self.ln(seq + a, f"{p}.LayerNorm_2").mean(dim=1)

    def forward(self, image, ids, mask) -> Dict[str, torch.Tensor]:
        """f32 NHWC image (B, H, W, 3), ids and 0/1 mask (B, L) -> logits,
        probs, joint_emb, img_emb, txt_emb."""
        patches, glob = self.vision(image)
        tokens, cls = self.text(ids, mask)
        img_patches = self.lin(patches, "img_proj")
        img_global = self.lin(glob, "img_global_proj")
        txt_tokens = self.lin(tokens, "txt_proj")
        txt_cls = self.lin(cls, "txt_cls_proj")
        txt_mask = mask[:, : txt_tokens.shape[1]]
        joint = self.lin(torch.cat([img_global, txt_cls], -1), "joint_init")
        for i in range(self.cfg["fusion"]["num_fusion_layers"]):
            pooled = self.fusion_layer(i, img_patches, img_global, txt_tokens, txt_mask)
            joint = self.ln(joint + pooled, f"joint_norm{i}")
        logits = self.lin(self.gelu(self.lin(joint, "cls_hidden")), "cls_out")
        return {"logits": logits, "probs": torch.sigmoid(logits), "joint_emb": joint,
                "img_emb": img_global, "txt_emb": txt_cls}


def window_normalize(raw16: torch.Tensor, center: torch.Tensor, width: torch.Tensor):
    """uint16 pixels (as int16 or int32 bytes), per-sample window center and
    width -> the model's f32 NHWC input: clip to [c - w/2, c + w/2], scale to
    [0, 1], then (x - 0.5) / 0.5, on 3 channels."""
    x = (raw16.to(torch.int32) & 0xFFFF).to(torch.float32)
    lo = (center.float() - width.float() / 2.0)[:, None, None]
    hi = (center.float() + width.float() / 2.0)[:, None, None]
    x = (torch.minimum(torch.maximum(x, lo), hi) - lo) / torch.clamp(hi - lo, min=1e-8)
    return ((x - 0.5) / 0.5)[..., None].expand(*x.shape, 3)


def forward_blocks(cfg: Mapping, weights: Weights, image, ids, mask, rows: int = 16,
                   quant: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """:meth:`Ref.forward` in blocks of ``rows``, without autograd."""
    ref = Ref(cfg, weights, quant)
    outs = []
    with torch.no_grad():
        for i in range(0, ids.shape[0], rows):
            outs.append(ref.forward(image[i:i + rows], ids[i:i + rows], mask[i:i + rows]))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
