"""The corpus over several processes, the counterpart of
``tpudraco/parallel/multihost.py``.

The corpus is the shard axis: each process owns a deterministic slice
(round-robin over the sorted inputs, so that sizes balance), encodes it
with ``BatchEncoder.encode_corpus`` on its own card, and every process
gets the totals of all. The processes meet through ``torch.distributed``
on the gloo backend, which runs on the host: its one collective is an
all-gather of four float64 counters, and gloo (unlike NCCL) takes two
ranks on one card. Every output file stands alone and is named by its
input, so no bitstream crosses processes.

One process (no ``WORLD_SIZE`` above 1, no coordinator) is the plain
``encode_corpus``.
"""

from __future__ import annotations

import json
import os


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group of a multi-process run on the gloo backend
    and return (rank, world size). ``coordinator`` (``host:port``, with
    ``num_processes`` and ``process_id``) names rank 0's address; without
    it the launcher's environment (torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) does. One process, or a group that
    is already up, is left as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        world, rank = int(num_processes), int(process_id)
        init_method = f"tcp://{coordinator}"
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        init_method = "env://"
    if world <= 1:
        return 0, 1
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    return rank, world


def shard_corpus(inputs: list[str], process_id: int,
                 num_processes: int) -> list[str]:
    """Deterministic round-robin slice of the corpus for this process."""
    return [p for i, p in enumerate(sorted(inputs))
            if i % num_processes == process_id]


def _rank_device(device):
    """The card of this process where ``device`` is None or a bare
    ``cuda``: ``cuda:<LOCAL_RANK mod the cards>``; None where the machine
    has no card, so that ``encode_corpus`` raises ``resolve``'s error. A
    card so chosen, or named with its index, becomes the process's
    current device: its context and every launch go there."""
    import torch

    if device is None or str(device) == "cuda":
        n = torch.cuda.device_count()
        if not n:
            return device
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % n}"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return device


def encode_corpus_multihost(inputs: list[str], out_dir: str,
                            resume: bool = True,
                            use_device: bool | str = True, device=None,
                            workers: int = 1, cfg=None,
                            device_window: int | None = None) -> dict:
    """Encode a corpus across every process of the group
    (``init_distributed``; one process without one). Each writes the
    outputs of its slice (``shard_corpus``) into ``out_dir`` on
    ``device`` (None or ``"cuda"``: its local rank's card; ``"cpu"``: the
    kernels' plain twins), or on the host plane with ``use_device=False``,
    loading ``device_window`` files at a time (``encode_corpus``).
    Inputs whose output names collide are dropped before the slicing, as
    ``encode_corpus`` drops them, and rank 0 reports them, so that a name
    is written once and by the same input as in one process. Every
    process returns its report with ``encoded``, ``skipped`` and the byte
    totals summed over the group (an all-gather of float64, exact to
    2^53) and ``num_hosts``; ``failed`` stays the process's own. Rank 0
    writes the merged report to ``corpus_report.json``."""
    import torch
    import torch.distributed as dist

    from .batch import BatchEncoder, _drop_output_collisions

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    inputs, collided = _drop_output_collisions(
        inputs, lambda p: os.path.splitext(os.path.basename(p))[0])
    mine = shard_corpus(inputs, rank, world)
    if use_device:
        device = _rank_device(device)
    report = BatchEncoder(use_device=use_device, cfg=cfg,
                          device=device).encode_corpus(
        mine, out_dir, resume=resume, workers=workers,
        device_window=device_window)
    if rank == 0:
        report["failed"] = [{"path": p, "error": "output name collision"}
                            for p in collided] + report["failed"]
    if world > 1:
        local = torch.tensor([report["encoded"], report["skipped"],
                              report["total_in_bytes"],
                              report["total_out_bytes"]],
                             dtype=torch.float64)
        totals = [torch.zeros_like(local) for _ in range(world)]
        dist.all_gather(totals, local)
        agg = torch.stack(totals).sum(dim=0).tolist()
        report = dict(report)
        for k, v in zip(("encoded", "skipped", "total_in_bytes",
                         "total_out_bytes"), agg):
            report[k] = int(v)
        report["num_hosts"] = world
    if rank == 0:
        tmp = os.path.join(out_dir, f"corpus_report.json.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, os.path.join(out_dir, "corpus_report.json"))
    return report
