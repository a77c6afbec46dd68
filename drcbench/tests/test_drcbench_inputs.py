"""The input makers: deterministic in the seed, the same sizes for every
seed, seeds past 32 bits, valences as in a scan, and data that is not
degenerate: vertices off the lattice, normals of the jittered surface, UVs
that no affine map of the positions gives, with seams."""

import json

import numpy as np
import pytest

from conftest import ROOT
from drcbench.core import harness
from drcbench.core.inputs import (
    TAKE_STREAM, Takes, frame_attributes, lattice, lattice_faces, raw_bytes,
    take_seed,
)

CFG = dict(json.loads((ROOT / "drcbench/configs/dfaust-pnt.json")
                      .read_text()), lattice=[20, 23])
CFG["uv"] = dict(CFG["uv"], chart_size=6)
ROWS, COLS = lattice(CFG)
V = ROWS * COLS


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 2 ** 40 + 1])
def test_same_seed_same_inputs(seed):
    f1, f2 = lattice_faces(ROWS, COLS, seed), lattice_faces(ROWS, COLS, seed)
    assert np.array_equal(f1, f2)
    a = frame_attributes(CFG, seed, 5, f1)
    b = frame_attributes(CFG, seed, 5, f2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_seeds_and_frames_change_values_not_sizes():
    f1, f2 = lattice_faces(ROWS, COLS, 1), lattice_faces(ROWS, COLS, 2)
    assert f1.shape == f2.shape and not np.array_equal(f1, f2)
    a = frame_attributes(CFG, 1, 0, f1)
    b = frame_attributes(CFG, 1, 1, f1)
    c = frame_attributes(CFG, 2, 0, f2)
    for x, y, z in zip(a, b, c):
        assert x.shape == y.shape == z.shape
        assert x.dtype == np.float32
        assert not np.array_equal(x, z)
    # positions and normals move with the frame; the atlas stays
    assert not np.array_equal(a[0], b[0]) and not np.array_equal(a[1], b[1])
    assert np.array_equal(a[2], b[2])


def test_lattice_shape_and_valences():
    faces = lattice_faces(ROWS, COLS, 11)
    assert faces.shape == (2 * (ROWS - 1) * (COLS - 1), 3)
    val = np.bincount(faces.ravel(), minlength=V).reshape(ROWS, COLS)
    inner = val[1:-1, 1:-1]
    assert inner.min() >= 4 and inner.max() <= 8
    assert len(np.unique(inner)) >= 4


def test_attributes_are_the_default_set():
    faces = lattice_faces(ROWS, COLS, 3)
    pos, nrm, uvs = frame_attributes(CFG, 3, 2, faces)
    assert pos.shape == (V, 3) and nrm.shape == (V, 3)
    assert uvs.shape == (V, 2)
    assert np.allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-6)
    assert np.all(nrm[:, 2] > 0)  # the height field faces up
    assert np.all((uvs >= 0) & (uvs < 1))
    assert raw_bytes(CFG) == V * 8 * 4


def test_vertices_sit_off_the_lattice():
    pos = frame_attributes(CFG, 4, 0, lattice_faces(ROWS, COLS, 4))[0]
    frac = np.abs(pos[:, :2] - np.round(pos[:, :2]))
    assert np.mean(frac > 0.05) > 0.8
    assert len(np.unique(np.round(pos[:, 0], 3))) > 0.9 * V


def test_uvs_are_no_affine_map_of_the_positions_and_have_seams():
    faces = lattice_faces(ROWS, COLS, 5)
    pos, _, uvs = frame_attributes(CFG, 5, 0, faces)
    a = np.c_[pos[:, :2], np.ones(V)]
    fit, *_ = np.linalg.lstsq(a, uvs, rcond=None)
    assert np.abs(a @ fit - uvs).max() > 0.05
    # within a chart the map bends: no affine map fits one chart either
    size = CFG["uv"]["chart_size"]
    gi, gj = np.indices((ROWS, COLS))
    one = ((gi < size) & (gj < size)).ravel()
    fit, *_ = np.linalg.lstsq(a[one], uvs[one], rcond=None)
    assert np.abs(a[one] @ fit - uvs[one]).max() > 1e-3
    # seams: edges whose UV length is many times the median
    e = np.linalg.norm(uvs[faces[:, 0]] - uvs[faces[:, 1]], axis=1)
    assert np.sum(e > 5 * np.median(e)) > 0


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3, 2 ** 40 + 1])
def test_take_0_is_the_configuration_on_the_runs_seed(seed):
    take = Takes(CFG, seed)[0]
    assert take.config is CFG and take.seed == seed
    assert np.array_equal(take.faces, lattice_faces(ROWS, COLS, seed))
    a, b = take.frame(3), frame_attributes(CFG, seed, 3, take.faces)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert (take.vertices, take.num_faces, take.frame_bytes) == (
        V, 2 * (ROWS - 1) * (COLS - 1), raw_bytes(CFG))


@pytest.mark.parametrize("seed", [7, 2 ** 40 + 1])
def test_later_takes_have_their_own_topology_and_surface(seed):
    takes = Takes(CFG, seed)
    faces = [takes[t].faces for t in range(4)]
    assert all(f.shape == faces[0].shape for f in faces)
    assert len({f.tobytes() for f in faces}) == 4
    assert len({takes[t].seed for t in range(4)}) == 4
    assert takes[2].faces is takes[2].faces  # made once
    # take t >= 1 is take 0 of its own seed, the same on every call
    s = take_seed(seed, 2)
    assert s == takes[2].seed == Takes(CFG, seed)[2].seed
    assert np.array_equal(takes[2].faces, Takes(CFG, s)[0].faces)
    pos = [takes[t].frame(0)[0] for t in range(3)]
    assert not np.array_equal(pos[0], pos[1])
    assert not np.array_equal(pos[1], pos[2])


def test_take_seeds_come_from_a_stream_of_their_own():
    # the run's own draws use streams 0 to 5 on its seed
    assert TAKE_STREAM > 5
    s = np.random.SeedSequence([7, TAKE_STREAM, 1]).generate_state(
        1, np.uint64)[0]
    assert take_seed(7, 1) == int(s)
    assert take_seed(7, 1) != take_seed(8, 1)


def test_takes_cycle_the_configurations_lattices():
    cfg = dict(CFG, takes=[{"lattice": [5, 6]}, {"lattice": [8, 4]}])
    takes = Takes(cfg, 3)
    assert [takes[t].lattice for t in range(5)] == [
        (5, 6), (8, 4), (5, 6), (8, 4), (5, 6)]
    t = takes[1]
    assert (t.vertices, t.num_faces, t.frame_bytes) == (32, 42, 32 * 32)
    assert t.faces.shape == (42, 3) and t.faces.max() == 31
    assert [a.shape[0] for a in t.frame(2)] == [32, 32, 32]
    # the rest of the file is shared
    assert t.config["uv"] == CFG["uv"] and t.config["lattice"] == [8, 4]


def test_requests_name_their_takes_and_frames():
    one = {"frames_per_request": 3}
    assert harness.request_takes(one, 2) == [(0, [6, 7, 8])]
    assert harness.request_frames(one, 1) == [(0, 3), (0, 4), (0, 5)]
    many = {"frames_per_request": 6, "takes_per_request": 3}
    assert harness.request_takes(many, 1) == [(3, [0, 1]), (4, [0, 1]),
                                              (5, [0, 1])]
    assert harness.request_frames(many, 0)[:3] == [(0, 0), (0, 1), (1, 0)]
    assert harness.request_takes(dict(many, takes_per_request=1), 2) == [
        (2, [0, 1, 2, 3, 4, 5])]
    for k in (0, 4):
        with pytest.raises(harness.SpecError):
            harness.request_takes(dict(many, takes_per_request=k), 0)
