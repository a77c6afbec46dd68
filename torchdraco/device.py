"""Device selection for the port: entry points run on the card unless the
caller asks for the CPU (``device="cpu"``, as the CPU tests do). No global
backend switch, and no silent drop to the CPU.

A shard axis (``mesh_axis``, the counterpart of a 1-D
``jax.sharding.Mesh``) is a sequence of such devices. An entry may repeat:
shards on one device run one after another on its current stream, which
is how one card, or the CPU, carries several shards."""

from __future__ import annotations

import numpy as np
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


def _indexed(dev: torch.device) -> torch.device:
    """One name for one device: ``cuda`` as ``cuda:<current device>``,
    the CPU as ``cpu``."""
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_axis(mesh_axis) -> list[torch.device]:
    """The devices of a shard axis: ``resolve`` on each entry of the
    non-empty sequence ``mesh_axis`` (``torch.device`` or strings), a card
    without an index taken as the current one. An empty axis raises
    ValueError, a ``cuda`` entry without a card ``resolve``'s
    RuntimeError."""
    if isinstance(mesh_axis, (str, torch.device)):
        raise TypeError(f"mesh_axis must be a sequence of devices, got "
                        f"{mesh_axis!r}")
    axis = [_indexed(resolve(d)) for d in mesh_axis]
    if not axis:
        raise ValueError("mesh_axis must name at least one device")
    return axis


def axis_for(device=None, mesh_axis=None) -> list[torch.device]:
    """The devices a call runs on: ``mesh_axis`` through ``resolve_axis``,
    or else the one device ``device`` (None: the card). Given both,
    ``device`` must be the axis's first device, where the results gather;
    anything else raises ValueError."""
    if mesh_axis is None:
        return [resolve(device)]
    axis = resolve_axis(mesh_axis)
    if device is not None and _indexed(resolve(device)) != axis[0]:
        raise ValueError(f"device {device} is not the first device of "
                         f"mesh_axis {[str(d) for d in axis]}")
    return axis


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """(start, stop) of the pieces ``torch.tensor_split`` cuts n rows
    into: the first ``n % n_shards`` pieces one row longer, nothing
    padded, a piece empty where n < n_shards."""
    q, r = divmod(n, n_shards)
    out, start = [], 0
    for i in range(n_shards):
        stop = start + q + (i < r)
        out.append((start, stop))
        start = stop
    return out


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def shard_rows(x, axis: list) -> list[torch.Tensor]:
    """``x`` (a tensor or numpy array) cut along dim 0 by
    ``shard_bounds``, piece i on ``axis[i]``. A list or tuple is taken as
    cut already, one entry a shard of the axis, and each entry is moved
    to its device (no copy where it lies there)."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(axis):
            raise ValueError(f"{len(x)} shards for an axis of {len(axis)}")
        return [_tensor(p).to(d) for p, d in zip(x, axis)]
    t = _tensor(x)
    return [t[a:b].to(d) for (a, b), d in zip(shard_bounds(len(t),
                                                           len(axis)), axis)]


def replicate(x, axis: list) -> list:
    """``x`` on the device of every shard of the axis: a tensor or numpy
    array is copied once to each distinct device and shared by the shards
    there; a dict is replicated value by value; a list or tuple is taken
    as replicated already, one entry a shard."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(axis):
            raise ValueError(f"{len(x)} shards for an axis of {len(axis)}")
        return list(x)
    copies: dict = {}
    for d in axis:
        if str(d) not in copies:
            copies[str(d)] = ({k: _tensor(v).to(d) for k, v in x.items()}
                              if isinstance(x, dict) else _tensor(x).to(d))
    return [copies[str(d)] for d in axis]
