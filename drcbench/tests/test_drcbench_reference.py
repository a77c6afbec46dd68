"""The reference (a frozen copy of the Draco host codec) against the
program's host codec at small sizes: the same bytes from ``encode_frames``
as from the program's ``encode()``, and the stream walk that the rooflines
count from. The program is imported by this test only; the reference never
imports it."""

import json

import numpy as np
import pytest

from conftest import ROOT
from drcbench.core.inputs import frame_attributes, lattice_faces
from drcbench.reference import oracle, pool
from drcbench.reference.codec.shared.sequencer import compute_sequence

CFG = json.loads((ROOT / "drcbench/configs/dfaust-pnt.json").read_text())


def _frames(rows, cols, seed, n):
    cfg = dict(CFG, lattice=[rows, cols], uv=dict(CFG["uv"], chart_size=5))
    faces = lattice_faces(rows, cols, seed)
    return cfg, faces, [frame_attributes(cfg, seed, f, faces)
                        for f in range(n)]


@pytest.mark.parametrize("rows,cols,seed", [(9, 9, 1), (17, 20, 2 ** 33 + 1),
                                            (33, 26, 5)])
def test_reference_bytes_equal_the_program_host_encoder(rows, cols, seed):
    from torchdraco import build_meshes
    from torchdraco.encode import encode

    from drcbench.entries.encode_group import program_config

    cfg, faces, frames = _frames(rows, cols, seed, 3)
    ccfg = oracle.codec_config(cfg["quantization"])
    blobs = oracle.encode_frames(
        [oracle.build_mesh(faces, *f) for f in frames], ccfg)
    meshes = build_meshes(np.stack([f[0] for f in frames]), faces,
                          np.stack([f[1] for f in frames]),
                          np.stack([f[2] for f in frames]))
    pcfg = program_config(cfg["quantization"])
    assert blobs == [encode(m, cfg=pcfg) for m in meshes]


@pytest.mark.parametrize("rows,cols,seed", [(9, 12, 3), (24, 21, 4)])
def test_stream_stats_walk_every_byte_of_the_streams(rows, cols, seed):
    """The walk reads each attribute's stream, prediction data and metadata
    to the blob's last byte (it raises otherwise), and counts a symbol per
    coded component of each vertex in the attribute's traversal."""
    cfg = dict(CFG, lattice=[rows, cols], uv=dict(CFG["uv"], chart_size=5))
    blobs, stats = pool.encode(cfg, seed, [(0, 0), (0, 1)], workers=1)
    v = rows * cols
    for blob, st in zip(blobs, stats):
        assert [s["h"]["att_type"].name for s in st] == [
            "POSITION", "NORMAL", "TEX_COORD"]
        assert st[0]["symbols"] == 3 * v  # x, y, z
        assert st[1]["symbols"] == 2 * v  # octahedral (s, t)
        assert st[2]["symbols"] >= 2 * v  # (u, v), seams add vertices
        assert all(0 < s["payload_bytes"] < len(blob) for s in st)
        assert all(s["table_entries"] > 1 for s in st)


def test_shared_sequences_equal_their_own_traversals():
    cfg, faces, frames = _frames(30, 27, 8, 1)
    topo = oracle.EncoderTopology(oracle.build_mesh(faces, *frames[0]))
    for i in range(3):
        assert topo.sequences[i] == compute_sequence(
            topo.view(i), list(topo.conn_out.corners_of_edgebreaker))


def test_bfloat16_rounding():
    a = np.array([1.0, 1.00390625, 1.005859375, -3.3, 0.0], np.float32)
    r = pool.round_bfloat16(a)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie goes to even
    assert r[2] == np.float32(1.0078125)
    assert np.all(r.view(np.uint32) & 0xFFFF == 0)
    assert abs(r[3] - a[3]) <= 2 ** -7 * 4


def test_blocks_keep_to_one_take_and_answers_keep_their_order():
    ids = [(t, f) for t in (4, 1, 2) for f in range(3)]
    blocks = pool._blocks(ids, 3)
    assert [[ids[i][0] for i in b] for b in blocks] == [[4] * 3, [1] * 3,
                                                        [2] * 3]
    assert len(pool._blocks(ids, 6)) == 6
    assert all(len({ids[i][0] for i in b}) == 1
               for b in pool._blocks(ids, 6))
    assert sorted(i for b in pool._blocks(ids, 2) for i in b) == list(
        range(9))
    # one take: the consecutive runs np.array_split makes
    one = [(0, f) for f in range(10)]
    assert pool._blocks(one, 4) == [
        list(b) for b in np.array_split(np.arange(10), 4)]
    cfg = dict(CFG, lattice=[9, 8], uv=dict(CFG["uv"], chart_size=4),
               takes=[{"lattice": [9, 8]}, {"lattice": [6, 10]}])
    mixed = [(1, 1), (0, 0), (2, 0), (1, 0)]
    blobs, stats = pool.encode(cfg, 11, mixed, workers=2)
    alone = [pool.encode(cfg, 11, [p], workers=1) for p in mixed]
    assert blobs == [b[0][0] for b in alone]
    assert [s[0]["symbols"] for s in stats] == [
        b[1][0][0]["symbols"] for b in alone]
    assert stats[0][0]["symbols"] == 3 * 60 and stats[1][0]["symbols"] == (
        3 * 72)
