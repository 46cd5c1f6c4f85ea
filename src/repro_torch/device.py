"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA device
without a GPU raises: the port never carries on silently on the CPU.  The
CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a :class:`torch.device`; raises
    :class:`RuntimeError` for a CUDA device when no GPU is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            f"pass device='cpu' to run the port on the CPU")
    return dev
