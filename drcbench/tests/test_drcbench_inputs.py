"""The input makers: deterministic in the seed, the same sizes for every
seed, seeds past 32 bits, valences as in a scan, and data that is not
degenerate: vertices off the lattice, normals of the jittered surface, UVs
that no affine map of the positions gives, with seams."""

import json

import numpy as np
import pytest

from conftest import ROOT
from drcbench.core.inputs import (
    frame_attributes, lattice, lattice_faces, raw_bytes,
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
