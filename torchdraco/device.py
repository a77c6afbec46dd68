"""Device selection for the port: an explicit ``device`` argument
everywhere, no global backend switch, and no silent drop to the CPU."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` for ``device`` (None means the CPU). Asking for
    CUDA on a machine without a usable card raises instead of quietly
    running the plain versions on the CPU."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; torchdraco runs on "
                         "'cpu' (plain versions) or 'cuda' (kernels)")
    return dev
