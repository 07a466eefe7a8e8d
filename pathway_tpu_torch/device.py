"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"``. The CPU
is taken only when the caller passes ``device="cpu"`` (the CPU tests do,
to run every kernel's plain version). When no card is present and the
CPU was not asked for, resolution raises; it never falls back.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only on request; raise when a CUDA
    device is asked for (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pathway_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_current(device: torch.device):
    """A context in which ``device`` is the current CUDA device (kernels
    launched through ctypes run on the current device); nothing for the
    CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
