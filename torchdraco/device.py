"""Device selection for the port: entry points run on the card unless the
caller asks for the CPU (``device="cpu"``, as the CPU tests do). No global
backend switch, and no silent drop to the CPU."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` for ``device``; None means the card
    (``"cuda"``). A machine without a usable card raises, whether CUDA was
    asked for or left to the default: the plain versions on the CPU are
    had by asking, ``device="cpu"``, never by a quiet probe."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False); "
                           "pass device='cpu' for the plain versions")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; torchdraco runs on "
                         "'cpu' (plain versions) or 'cuda' (kernels)")
    return dev
