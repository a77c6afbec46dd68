"""The row dedup under torchdraco's mesh building, on the CPU: the native
one-pass hash (``torchdraco.native.unique_rows``, csrc/dedup.cpp) against
its numpy twin (``models.attribute.first_occurrences`` without the
library) and tpudraco's ``unique_rows_first_occurrence``, exactly; the
attribute that keeps its caller's array when no row repeats; and
``build_meshes`` giving the same meshes and ``.drc`` bytes with
``TORCHDRACO_NO_NATIVE`` set and unset. Inputs are made from numpy
seeds."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")  # tpudraco.ops imports it

import tpudraco.models as ref_models  # noqa: E402
from torchdraco import native as tnative  # noqa: E402
from torchdraco.models import (Attribute, AttributeDomain,  # noqa: E402
                               AttributeType, unique_rows_first_occurrence)
from torchdraco.models.attribute import first_occurrences  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (dtype, columns): rows of 1, 2, 3, 7 and 32 bytes, and the float and
# int widths the loaders make
ROWS = [(np.uint8, 1), (np.uint8, 2), (np.uint8, 3), (np.uint8, 7),
        (np.uint8, 32), (np.int32, 1), (np.int32, 3), (np.int32, 8),
        (np.float32, 1), (np.float32, 2), (np.float32, 3), (np.float32, 8),
        (np.float64, 1), (np.float64, 3), (np.float64, 4)]
PATTERNS = ("distinct", "equal", "repeated")
# float32 and float64 bits of -0.0, +0.0, 1.0 and three NaNs: two payloads
# and a negative one
SPECIAL = {np.float32: [0x80000000, 0, 0x3F800000, 0x7FC00000, 0x7FC00001,
                        0xFFC00000],
           np.float64: [0x8000000000000000, 0, 0x3FF0000000000000,
                        0x7FF8000000000000, 0x7FF8000000000001,
                        0xFFF8000000000000]}


def _distinct(rng, n: int, width: int) -> np.ndarray:
    """(n, width) uint8 rows, distinct where 256^width >= n: a shuffled
    index in the first bytes, the rest random."""
    out = rng.integers(0, 256, size=(n, width), dtype=np.uint8)
    idx = rng.permutation(n).astype("<u8").view(np.uint8).reshape(n, 8)
    k = min(width, 8)
    out[:, :k] = idx[:, :k]
    return out


def _rows(dtype, cols: int, pattern: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    width = np.dtype(dtype).itemsize * cols
    if pattern == "distinct":
        raw = _distinct(rng, n, width)
    elif pattern == "equal":
        raw = np.repeat(_distinct(rng, 1, width), n, axis=0)
    elif pattern == "repeated":  # every row twice, in shuffled order
        base = _distinct(rng, (n + 1) // 2, width)
        raw = np.concatenate([base, base])[rng.permutation(2 * len(base))][:n]
    else:  # signed zeros and NaN payloads
        bits = np.array(SPECIAL[dtype], dtype=f"<u{np.dtype(dtype).itemsize}")
        raw = bits[rng.integers(0, len(bits), size=(n, cols))].view(np.uint8)
    return np.ascontiguousarray(raw).view(dtype).reshape(n, cols)


CASES = ([(d, c, p, n) for d, c in ROWS for p in PATTERNS
          for n in (1, 6890)]
         + [(d, 3, "zeros_and_nans", n) for d in (np.float32, np.float64)
            for n in (1, 6890)]
         + [(d, c, p, 1 << 20) for d, c in ((np.float32, 3), (np.uint8, 32))
            for p in ("distinct", "repeated")])


@pytest.mark.parametrize(
    "dtype,cols,pattern,n", CASES,
    ids=[f"{np.dtype(d).name}x{c}-{p}-{n}" for d, c, p, n in CASES])
def test_native_dedup_matches_the_numpy_twin(monkeypatch, dtype, cols,
                                             pattern, n):
    arr = _rows(dtype, cols, pattern, n, seed=n * 31 + cols)
    floating = np.issubdtype(dtype, np.floating)
    first, inverse = tnative.unique_rows(
        arr.view(np.uint8), arr.dtype.itemsize if floating else 0)
    assert first.dtype == inverse.dtype == np.int64
    assert first_occurrences(arr)[2] is True
    uniq, inv = unique_rows_first_occurrence(arr)
    with monkeypatch.context() as m:
        m.setattr(tnative, "load_library", lambda: None)
        twin_first, twin_inverse, hashed = first_occurrences(arr)
        twin_uniq, twin_inv = unique_rows_first_occurrence(arr)
    assert hashed is False
    assert np.array_equal(first, twin_first)
    assert np.array_equal(inverse, twin_inverse)
    ref_uniq, ref_inv = ref_models.unique_rows_first_occurrence(arr)
    for u, i in ((uniq, inv), (twin_uniq, twin_inv)):
        assert u.dtype == ref_uniq.dtype and u.shape == ref_uniq.shape
        assert u.tobytes() == ref_uniq.tobytes()
        assert i.dtype == ref_inv.dtype and np.array_equal(i, ref_inv)
    if len(first) == n:
        assert uniq is arr  # no gather where no row repeats
    if pattern == "distinct" and 256 ** (arr.itemsize * cols) >= n:
        assert len(first) == n
    if pattern == "equal":
        assert len(first) == 1


@pytest.mark.parametrize("hashed", [True, False])
def test_attribute_keeps_the_callers_array(monkeypatch, hashed):
    if not hashed:
        monkeypatch.setattr(tnative, "load_library", lambda: None)
    vals = np.random.default_rng(3).random((100, 3)).astype(np.float32)
    att = Attribute(vals, AttributeType.POSITION, AttributeDomain.POSITION)
    assert att.values is vals and att.point_map is None
    vals[7] = -0.0
    vals[9] = 0.0
    att = Attribute(vals[[0, 7, 1, 9, 0, 2, 1]], AttributeType.POSITION,
                    AttributeDomain.POSITION)
    assert att.values.tobytes() == vals[[0, 7, 1, 2]].tobytes()
    assert att.point_map.tolist() == [0, 1, 2, 1, 0, 3, 2]


# frames with seams (a vertex's position, normal or UV copied onto another
# with the rest left different), duplicated corners (every attribute
# copied), and -0.0 beside +0.0; built and encoded with and without the
# native library, one pickle a side
_SIDE = r"""
import pickle, sys
import numpy as np
import torchdraco
from torchdraco import native
from torchdraco.encode import encode

assert (native.load_library() is None) == bool(int(sys.argv[2]))
pos, faces = torchdraco.make_mesh_batch(4, 12, seed=7)
nrm, uvs = torchdraco.make_normal_uv_batch(pos, 12, seed=8)
for b in range(len(pos)):
    rng = np.random.default_rng(b)
    v = rng.permutation(pos.shape[1])
    for i in range(0, 24, 2):
        pos[b, v[i + 1]] = pos[b, v[i]]          # position seams
    for i in range(24, 40, 2):
        nrm[b, v[i + 1]] = nrm[b, v[i]]          # normal seams
        uvs[b, v[i + 1]] = uvs[b, v[i]]
    for i in range(40, 56, 2):                   # duplicated corners
        a, c = v[i], v[i + 1]
        pos[b, c], nrm[b, c], uvs[b, c] = pos[b, a], nrm[b, a], uvs[b, a]
    pos[b, v[60], 0] = 0.0                       # signed zeros merge
    pos[b, v[61]] = pos[b, v[60]]
    pos[b, v[61], 0] = -0.0
out = []
for m in torchdraco.build_meshes(pos, faces, nrm, uvs):
    atts = [(int(a.att_type), a.values.dtype.str, a.values.shape,
             a.values.tobytes(),
             None if a.point_map is None else a.point_map.tolist())
            for a in m.attributes]
    out.append((m.faces.tolist(), atts, encode(m)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _side(tmp_path, no_native: bool):
    path = tmp_path / f"side{int(no_native)}.pkl"
    env = {k: v for k, v in os.environ.items()
           if k != "TORCHDRACO_NO_NATIVE"}
    if no_native:
        env["TORCHDRACO_NO_NATIVE"] = "1"
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", _SIDE, str(path),
                    str(int(no_native))], env=env, cwd=ROOT, check=True,
                   capture_output=True, timeout=300)
    with open(path, "rb") as f:
        return pickle.load(f)


def test_build_meshes_is_the_same_without_the_native_library(tmp_path):
    hashed, twin = _side(tmp_path, False), _side(tmp_path, True)
    assert hashed == twin
    assert len(hashed) == 4
    for faces, atts, blob in hashed:
        # 144 points less 8 duplicated corners; positions less 12 seams
        # and a signed zero besides; normals and UVs less their 8 seams
        assert [len(pm) for *_, pm in atts] == [136] * 3
        assert [shape[0] for _, _, shape, _, _ in atts] == [123, 128, 128]
        assert blob[:5] == b"DRACO"
