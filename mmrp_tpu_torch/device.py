"""Where the port's entry points build: on the card unless the caller asks otherwise."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a clear error when it names CUDA and
    this machine has none (pass ``device="cpu"`` to run every kernel's plain
    PyTorch version on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: no CUDA device here (torch.cuda.is_available() is false); the "
            "port runs on the card by default, pass device='cpu' to run its plain "
            "PyTorch versions on the CPU")
    return dev
