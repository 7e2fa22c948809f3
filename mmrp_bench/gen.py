"""The one general generator: every input of a run, made from ``--seed`` and
the parameters of a traffic file, on the device in a few large calls.

The same seed gives the same inputs. Each kind of input draws from a
generator of its own, seeded from (seed, kind), so that adding a kind never
changes another. Every seed gets the same set of text lengths (the
quantiles of the traffic's log-normal), in its own order, so that seeds
change which pair is long, not how much work a ring holds.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

KINDS = ("weights", "text", "image", "labels", "gallery", "thresholds", "kg", "sample")


def generator(seed: int, kind: str, device) -> torch.Generator:
    sub = np.random.SeedSequence([int(seed), KINDS.index(kind)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(sub))


def host_rng(seed: int, kind: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), KINDS.index(kind)])


# --- weights ---------------------------------------------------------------

def _init_rule(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of a parameter: dense weights lecun-normal (std
    1/sqrt(fan_in), the layout is (out, in)); norm scales 1 + N(0, 0.02^2);
    the enhancers' residual gates 0.5 + N(0, 0.1^2); everything else
    (biases, embeddings, positional and relative-position tables) N(0,
    0.02^2). Nothing is zero, so no branch hides from a check."""
    if name.endswith("alpha"):
        return 0.5, 0.1
    if name.endswith(".weight") and len(shape) == 2:
        return 0.0, float(shape[1]) ** -0.5
    if name.endswith(".weight") and len(shape) == 1:
        return 1.0, 0.02
    return 0.0, 0.02


def weights(schema: Sequence[Tuple[str, Sequence[int], torch.dtype]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """{name: tensor in its dtype} for (name, shape, dtype) in ``schema``:
    one normal draw for all of them, then each scaled by its rule, then one
    cast per dtype."""
    sizes = [int(np.prod(shape)) for _, shape, _ in schema]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device), device=device)
    views = list(torch.split(flat, sizes))
    rules = [_init_rule(name, shape) for name, shape, _ in schema]
    torch._foreach_mul_(views, [std for _, std in rules])
    torch._foreach_add_(views, [mean for mean, _ in rules])
    out = {}
    for dtype in {dt for _, _, dt in schema}:
        idx = [i for i, (_, _, dt) in enumerate(schema) if dt == dtype]
        cast = torch.cat([views[i] for i in idx]).to(dtype)
        for i, part in zip(idx, torch.split(cast, [sizes[i] for i in idx])):
            out[schema[i][0]] = part.view(tuple(schema[i][1]))
    return out


def kg_proj(dim_in: int, dim_out: int, seed: int, device) -> torch.Tensor:
    """The joint -> KG projection of the train state, N(0, 1) / sqrt(dim_in)."""
    g = generator(seed, "kg", device)
    return torch.randn((dim_in, dim_out), generator=g, device=device) / dim_in ** 0.5


# --- texts -----------------------------------------------------------------

def lengths(n: int, text: Mapping, seed: int) -> np.ndarray:
    """n valid lengths ([CLS] and [SEP] included): the quantiles (i + 0.5) / n
    of a log-normal with the traffic's mean and sigma (its median is
    ``len_mean * exp(-sigma^2 / 2)``), rounded and clipped to [len_min,
    len_max], in an order drawn from the seed."""
    q = (np.arange(n) + 0.5) / n
    z = torch.special.ndtri(torch.from_numpy(q)).numpy()
    sigma = text["len_sigma"]
    L = np.exp(np.log(text["len_mean"]) - sigma ** 2 / 2 + sigma * z)
    L = np.clip(np.rint(L), text["len_min"], min(text["len_max"], text["max_len"]))
    return host_rng(seed, "text").permutation(L.astype(np.int64))


def texts(n: int, text: Mapping, seed: int, device):
    """(ids (n, max_len) int32, mask (n, max_len) int32, lengths (n,)):
    [CLS], body ids drawn uniformly from the vocabulary without its special
    tokens, [SEP], then padding."""
    L = lengths(n, text, seed)
    T = text["max_len"]
    g = generator(seed, "text", device)
    ids = torch.randint(text["first_body_id"], text["vocab_size"], (n, T), generator=g,
                        device=device, dtype=torch.int32)
    pos = torch.arange(T, device=device)[None, :]
    Lt = torch.from_numpy(L).to(device)[:, None]
    ids = torch.where(pos == 0, text["cls_id"], ids)
    ids = torch.where(pos == Lt - 1, text["sep_id"], ids)
    ids = torch.where(pos >= Lt, text["pad_id"], ids).to(torch.int32)
    mask = (pos < Lt).to(torch.int32)
    return ids, mask, L


# --- images ----------------------------------------------------------------

def raw_images(n: int, image: Mapping, seed: int, device):
    """uint16 pixels (as int16 bytes) (n, size, size) of ``bits`` bits and
    each sample's window center and width (f32), as a compact ingest sends
    them."""
    g = generator(seed, "image", device)
    s = image["size"]
    px = torch.randint(0, 2 ** image["bits"], (n, s, s), generator=g, device=device,
                       dtype=torch.int32).to(torch.int16)
    lo, hi = image["center"]
    center = lo + (hi - lo) * torch.rand(n, generator=g, device=device)
    lo, hi = image["width"]
    width = lo + (hi - lo) * torch.rand(n, generator=g, device=device)
    return px, center, width


def model_images(n: int, image: Mapping, seed: int, device) -> torch.Tensor:
    """f32 NHWC (n, size, size, 3) in [-1, 1], a grey image on 3 channels, as
    the training loader yields it."""
    g = generator(seed, "image", device)
    s = image["size"]
    x = torch.rand((n, s, s, 1), generator=g, device=device) * 2.0 - 1.0
    return x.expand(n, s, s, 3).contiguous()


# --- the rest --------------------------------------------------------------

def labels(n: int, classes: int, p: float, seed: int, device) -> torch.Tensor:
    g = generator(seed, "labels", device)
    return (torch.rand((n, classes), generator=g, device=device) < p).float()


def kg_targets(n: int, dim: int, seed: int, device) -> torch.Tensor:
    g = generator(seed, "labels", device)
    torch.rand(1, generator=g, device=device)  # its own stream after the labels' draw
    return torch.randn((n, dim), generator=g, device=device)


def gallery(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """(rows, dim) f32 unit rows."""
    g = torch.randn((rows, dim), generator=generator(seed, "gallery", device), device=device)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def thresholds(classes: int, lo: float, hi: float, seed: int) -> np.ndarray:
    return host_rng(seed, "thresholds").uniform(lo, hi, classes).astype(np.float32)


def pos_weight(labels_np: np.ndarray, clamp_max: float) -> np.ndarray:
    """Per class negatives over positives, clamped to [1, clamp_max]; 1 for a
    class with no positive (the loss never weights it)."""
    pos = labels_np.sum(0)
    neg = labels_np.shape[0] - pos
    pw = np.where(pos > 0, neg / np.maximum(pos, 1), 1.0)
    return np.minimum(np.maximum(pw, 1.0), clamp_max).astype(np.float32)


def sample(n: int, k: int, seed: int) -> List[int]:
    """k distinct positions of n, drawn from the seed, in order."""
    return sorted(host_rng(seed, "sample").choice(n, size=min(k, n), replace=False).tolist())
