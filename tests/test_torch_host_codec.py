"""torchdraco's own host codec (wire, models, entropy, encode, decode,
shared, native: numpy and C++) against tpudraco's, on the CPU. The port
keeps a copy at the same relative paths and imports nothing of tpudraco;
these tests import both and hold the copy to the original, exactly. Inputs
are made from numpy seeds."""

import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")  # tpudraco.ops imports it

PKGS = ("torchdraco", "tpudraco")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _build(pkg, pos, faces, normals=None, uvs=None):
    m = _mod(pkg, "models")
    b = m.MeshBuilder()
    b.set_connectivity_attribute(np.asarray(faces, dtype=np.int64))
    pid = b.add_attribute(pos, m.AttributeType.POSITION,
                          m.AttributeDomain.POSITION)
    if normals is not None:
        b.add_attribute(normals, m.AttributeType.NORMAL,
                        m.AttributeDomain.POSITION, parents=[pid])
    if uvs is not None:
        b.add_attribute(uvs, m.AttributeType.TEX_COORD,
                        m.AttributeDomain.POSITION, parents=[pid])
    return b.build()


def _mesh_arrays(kind: str, seed: int, n: int = 9):
    """tests/test_parallel.py's ``_grid_mesh`` or tests/test_fuzz.py's
    ``_random_mesh`` (random holes), with unit normals and UVs per vertex."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    scale = 3 if kind == "random" else 1
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.random(n * n).astype(np.float32) * scale], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = (i * n + j, i * n + j + 1,
                          (i + 1) * n + j, (i + 1) * n + j + 1)
            if kind == "grid" or rng.random() < 0.9:
                faces.append([a, b, c])
            if kind == "grid" or rng.random() < 0.9:
                faces.append([b, d, c])
    nrm = rng.normal(size=(n * n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uvs = rng.random((n * n, 2)).astype(np.float32)
    return pos, faces, nrm, uvs


def _config(pkg: str, setting: dict):
    enc = _mod(pkg, "encode")
    types = _mod(pkg, "models").AttributeType
    cfg = enc.Config.from_level(setting["cl"]) if "cl" in setting \
        else enc.Config(**setting.get("kw", {}))
    for name, bits in setting.get("q", {}).items():
        cfg.quant_bits[types[name]] = bits
    return cfg


SETTINGS = {
    "default": {},
    "qp14": {"q": {"POSITION": 14}},
    "qp8_qn10_qt12": {"q": {"POSITION": 8, "NORMAL": 10, "TEX_COORD": 12}},
    "cl0": {"cl": 0},
    "cl5_qp16": {"cl": 5, "q": {"POSITION": 16}},
    "cl7": {"cl": 7},
    "cl10": {"cl": 10},
    "length_coded": {"kw": {"symbol_coding": "length"}},
    "prediction_degree": {"kw": {"attribute_traversal": "prediction-degree"}},
}


def _same_mesh(a, b) -> bool:
    return (np.array_equal(a.faces, b.faces)
            and len(a.attributes) == len(b.attributes)
            and all(int(x.att_type) == int(y.att_type)
                    and np.array_equal(np.asarray(x.values),
                                       np.asarray(y.values))
                    for x, y in zip(a.attributes, b.attributes)))


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("kind,attrs", [
    ("grid", "p"), ("grid", "pnt"), ("random", "p"), ("random", "pnt")])
def test_encode_bytes_and_decode_match_tpudraco(kind, attrs, setting):
    """encode() of the same mesh gives the same bytes through both
    packages, and decode() of those bytes the same mesh."""
    for seed in (1, 2):
        pos, faces, nrm, uvs = _mesh_arrays(kind, seed)
        extra = dict(normals=nrm, uvs=uvs) if attrs == "pnt" else {}
        blobs, meshes = [], []
        for pkg in PKGS:
            mesh = _build(pkg, pos, faces, **extra)
            blob = _mod(pkg, "encode").encode(
                mesh, cfg=_config(pkg, SETTINGS[setting]))
            blobs.append(blob)
            meshes.append(_mod(pkg, "decode").decode(blob))
        assert blobs[0] == blobs[1]
        assert _same_mesh(meshes[0], meshes[1])
        assert len(meshes[0].attributes) == len(attrs)


@pytest.mark.parametrize("prec", (12, 15, 20))
def test_rans_coders_match_tpudraco(prec):
    rng = np.random.default_rng(prec)
    stream = (rng.integers(0, 60, size=5000) ** 2 % 700).astype(np.int64)
    out = []
    for pkg in PKGS:
        r = _mod(pkg, "entropy.rans")
        wire = _mod(pkg, "wire.byte_io")
        dist = r.normalize_freq_counts(np.bincount(stream), prec)
        enc = r.RansEncoder(dist, precision=prec)
        enc.write_all(stream[::-1])
        blob = enc.flush()
        got = r.RansDecoder(wire.ByteReader(blob), len(blob), dist,
                            precision=prec).read_all(len(stream))
        assert np.array_equal(np.asarray(got).astype(np.int64), stream)
        out.append((dist, blob))
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


@pytest.mark.parametrize("case", ("flat", "skewed", "sparse", "single"))
def test_normalize_and_serialize_tables_match_tpudraco(case):
    rng = np.random.default_rng(3)
    counts = {
        "flat": rng.integers(1, 50, size=(6, 300)),
        "skewed": (rng.integers(0, 40, size=(6, 500)) ** 3),
        "sparse": rng.integers(0, 2, size=(6, 2000))
        * rng.integers(1, 9000, size=(6, 2000)),
        "single": np.eye(6, 40, dtype=np.int64) * 777,
    }[case].astype(np.int64)
    counts[:, 0] += 1
    prec = np.array([12, 13, 15, 18, 20, 20])
    got = []
    for pkg in PKGS:
        r = _mod(pkg, "entropy.rans")
        wire = _mod(pkg, "wire.byte_io")
        dist, ns = r.normalize_freq_counts_batch(counts, prec)
        rows = [r.normalize_freq_counts(c, int(p))
                for c, p in zip(counts, prec)]
        for k, row in enumerate(rows):
            assert np.array_equal(dist[k, :len(row)], row)
        tables = r.serialize_rans_tables_batch(dist, ns)
        for k, row in enumerate(rows):
            w = wire.ByteWriter()
            r.serialize_rans_table(row, w)
            assert tables[k] == w.getvalue()
        got.append((dist, ns, tables))
    assert np.array_equal(got[0][0], got[1][0])
    assert np.array_equal(got[0][1], got[1][1])
    assert got[0][2] == got[1][2]


@pytest.mark.parametrize("alphabet,n,comps", [(40, 333, 1), (3, 50, 1),
                                              (5000, 1200, 3), (1, 64, 2)])
def test_symbol_coding_matches_tpudraco(alphabet, n, comps):
    """encode_symbols (DirectCoded and LengthCoded) and the stream parser
    the batch decoder collects lanes with."""
    rng = np.random.default_rng(alphabet)
    sym = rng.integers(0, alphabet, size=n * comps, dtype=np.uint64)
    out = []
    for pkg in PKGS:
        sc = _mod(pkg, "entropy.symbol_coding")
        wire = _mod(pkg, "wire.byte_io")
        w = wire.ByteWriter()
        sc.encode_symbols(sym, comps, sc.DIRECT_CODED, w)
        direct = w.getvalue()
        dist, prec, payload = sc.parse_direct_coded_stream(
            wire.ByteReader(direct))
        back = sc.decode_symbols(len(sym), comps, wire.ByteReader(direct))
        assert np.array_equal(np.asarray(back).astype(np.uint64), sym)
        w = wire.ByteWriter()
        sc.encode_symbols(sym, comps, sc.LENGTH_CODED, w)
        out.append((direct, np.asarray(dist), int(prec), bytes(payload),
                    w.getvalue()))
    for a, b in zip(*out):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


@pytest.mark.parametrize("kind", ("grid", "random"))
def test_topology_passes_match_tpudraco(kind):
    """The connectivity encoder's output, the traversal sequence, the
    Python parallelogram gathers and the native topology pass."""
    pos, faces, _, _ = _mesh_arrays(kind, 4, n=8)
    got = []
    for pkg in PKGS:
        mesh = _build(pkg, pos, faces)
        conn = _mod(pkg, "encode.connectivity")
        wire = _mod(pkg, "wire.byte_io")
        models = _mod(pkg, "models")
        w = wire.ByteWriter()
        eb = conn.EdgebreakerEncoder(mesh.faces, mesh.attributes)
        out = eb.encode(w)
        view = models.TableView(out.corner_table.corner_table, None)
        seq = _mod(pkg, "shared.sequencer").compute_sequence(
            view, list(out.corners_of_edgebreaker))
        uniq = mesh.position_attribute().unique_indices()
        g_py = _mod(pkg, "ops.gathers").build_parallelogram_gathers(
            view, seq, uniq)
        arrays = view.as_arrays()
        voc = uniq[view.u.faces_points.ravel()]
        g_nat = _mod(pkg, "native.topo").parallelogram_gathers(
            arrays[0], arrays[1], arrays[2], voc, np.asarray(seq))
        assert g_nat is not None, f"{pkg}: native library did not load"
        for k in g_py:
            assert np.array_equal(np.asarray(g_py[k]), np.asarray(g_nat[k]))
        got.append((w.getvalue(), list(seq),
                    {k: np.asarray(v) for k, v in g_py.items()}))
    assert got[0][0] == got[1][0] and got[0][1] == got[1][1]
    assert got[0][2].keys() == got[1][2].keys()
    assert all(np.array_equal(got[0][2][k], got[1][2][k]) for k in got[0][2])


@pytest.mark.parametrize("bits", (8, 11, 16))
def test_native_quantize_batch_matches_tpudraco(bits):
    rng = np.random.default_rng(bits)
    vals = rng.normal(size=(5, 300, 3)).astype(np.float32) * 7
    vals[2] = 1.5                                   # a degenerate mesh
    got = [_mod(pkg, "native").quantize_batch(vals, bits) for pkg in PKGS]
    assert got[0] is not None and got[1] is not None
    for a, b in zip(*got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_native_libraries_are_separate_and_coexist():
    """The port builds its own library under its own name into the
    gitignored torchdraco/_build/, and both libraries load in one
    process."""
    t = _mod("torchdraco", "native")
    j = _mod("tpudraco", "native")
    tl, jl = t.load_library(), j.load_library()
    assert tl is not None and jl is not None
    t_path, j_path = tl._name, jl._name
    assert t_path != j_path
    assert os.path.dirname(t_path) == os.path.join(ROOT, "torchdraco",
                                                   "_build")
    assert os.path.basename(t_path).startswith("libtorchdraco_native_")
    assert hasattr(tl, "tdn_rans_encode") and hasattr(jl, "tpud_rans_encode")


def test_native_build_does_not_race(tmp_path):
    """Four processes build the library into one empty directory at once:
    each compiles under a temporary name of its own and renames it into
    place, so every one of them ends with a loaded library and no
    pure-Python fallback warning."""
    code = f"""
import sys, warnings
sys.path.insert(0, {ROOT!r})
warnings.simplefilter("error")
from torchdraco import native
native._BUILD = {str(tmp_path)!r}
assert native.load_library() is not None
import numpy as np
assert native.quantize_batch(np.zeros((1, 4, 3), np.float32), 11) is not None
"""
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    left = sorted(os.listdir(tmp_path))
    assert len(left) == 1 and left[0].endswith(".so"), left


def test_no_compiler_falls_back_with_a_warning(monkeypatch, tmp_path):
    """The host codec's documented contract: without a C++ compiler the
    pure-Python twins run, with a RuntimeWarning."""
    t = _mod("torchdraco", "native")
    monkeypatch.setattr(t, "_BUILD", str(tmp_path))
    monkeypatch.setattr(t, "_lib", None)
    monkeypatch.setattr(t, "_tried", False)
    monkeypatch.setenv("PATH", str(tmp_path))   # no g++ there
    with pytest.warns(RuntimeWarning, match="torchdraco native build "
                                            "unavailable"):
        assert t.load_library() is None
    assert t.quantize_batch(np.zeros((1, 4, 3), np.float32), 11) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t.load_library() is None         # asked once, not again
