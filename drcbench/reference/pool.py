"""The reference's work spread over worker processes, a block of frames
each: every worker makes its frames from the seed, builds each take's
topology once and encodes its frames. A frame is a (take, frame) pair, as
the harness names it, and a block keeps to one take where it can. Nothing
here imports the program under test."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..core.inputs import Takes
from . import oracle


def _frames(config: dict, seed: int, frame_ids, precision: str):
    takes = Takes(config, seed)
    out = []
    for t, f in frame_ids:
        attrs = takes[t].frame(f)
        if precision == "bfloat16":
            attrs = tuple(round_bfloat16(a) for a in attrs)
        out.append(oracle.build_mesh(takes[t].faces, *attrs))
    return out


def round_bfloat16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    back in float32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000))
    return r.view(np.float32)


def _encode_block(job):
    config, seed, frame_ids, precision = job
    meshes = _frames(config, seed, frame_ids, precision)
    cfg = oracle.codec_config(config["quantization"])
    topos: dict = {}
    blobs = oracle.encode_frames(meshes, cfg, topos)
    stats = [oracle.stream_stats(b, topos[oracle.signature(m)])
             for b, m in zip(blobs, meshes)]
    return blobs, stats


def _split(items: list, n: int) -> list[list]:
    """``items`` in ``n`` runs of consecutive items, the first ones longer
    by one where they do not share evenly (as ``np.array_split``)."""
    q, r = divmod(len(items), n)
    cuts = [i * q + min(i, r) for i in range(n + 1)]
    return [items[a:b] for a, b in zip(cuts, cuts[1:])]


def _blocks(frame_ids: list, workers: int) -> list[list[int]]:
    """Positions in ``frame_ids``, in at most ``workers`` blocks: whole
    takes packed together where there are as many takes as blocks, else
    each take cut into its share of them."""
    n = max(1, min(workers, len(frame_ids)))
    by_take: dict = {}
    for i, (t, _) in enumerate(frame_ids):
        by_take.setdefault(t, []).append(i)
    takes = list(by_take.values())
    if len(takes) >= n:
        return [[i for take in part for i in take]
                for part in _split(takes, n)]
    return [blk for take in takes
            for blk in _split(take, max(1, n * len(take) // len(frame_ids)))]


def _map(fn, jobs: list, workers: int) -> list:
    if workers <= 1 or len(jobs) == 1:
        return [fn(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(jobs), mp_context=ctx) as ex:
        return list(ex.map(fn, jobs))


def default_workers() -> int:
    return max(1, min(6, (os.cpu_count() or 2) - 2))


def encode(config: dict, seed: int, frame_ids: list, workers: int,
           precision: str = "float32"):
    """(blobs, stream stats), one of each a (take, frame) pair of
    ``frame_ids``, in its order. ``precision`` "bfloat16" rounds every
    input attribute to bfloat16 first (the lower-precision control)."""
    blocks = _blocks(frame_ids, workers)
    blobs: list = [None] * len(frame_ids)
    stats: list = [None] * len(frame_ids)
    for blk, (b, s) in zip(blocks, _map(_encode_block, [
            (config, seed, [frame_ids[i] for i in blk], precision)
            for blk in blocks], workers)):
        for i, bi, si in zip(blk, b, s):
            blobs[i], stats[i] = bi, si
    return blobs, stats
