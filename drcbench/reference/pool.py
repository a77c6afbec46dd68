"""The reference's work spread over worker processes, a block of frames
each: every worker makes its frames from the seed, builds the topology
once and encodes its frames. Nothing here imports the program under
test."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..core.inputs import frame_attributes, lattice, lattice_faces
from . import oracle


def _frames(config: dict, seed: int, frame_ids, precision: str):
    faces = lattice_faces(*lattice(config), seed)
    out = []
    for f in frame_ids:
        attrs = frame_attributes(config, seed, f, faces)
        if precision == "bfloat16":
            attrs = tuple(round_bfloat16(a) for a in attrs)
        out.append(oracle.build_mesh(faces, *attrs))
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


def _blocks(frame_ids: list, workers: int) -> list[list]:
    n = max(1, min(workers, len(frame_ids)))
    return [list(b) for b in np.array_split(np.asarray(frame_ids), n)
            if len(b)]


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
    """(blobs, stream stats), one of each a frame, in ``frame_ids``'
    order. ``precision`` "bfloat16" rounds every input attribute to
    bfloat16 first (the lower-precision control)."""
    blobs, stats = [], []
    for b, s in _map(_encode_block, [
            (config, seed, blk, precision)
            for blk in _blocks(frame_ids, workers)], workers):
        blobs += b
        stats += s
    return blobs, stats
