"""The chain entries' host payloads, byte for byte: the flip and
orientation writers (``shared/prediction.py``, numpy) and the chunk's
batch entry (``parallel/batch.py::_chain_payloads`` over
``native.chain_payloads``, csrc/rans.cpp ``tdn_chain_payloads``) against
tpudraco's list-based writers (``write_normal_flips``,
``write_tex_orientations``) and its DIRECT_CODED section
(``encode_symbols``), which run on tpudraco's own coders: the zero
probability at its clamps, the orientations' delta chains, skipped
meshes, the rows of a body mesh and of a 1M-vertex one, with the port's
native library and under ``TORCHDRACO_NO_NATIVE``. Inputs are made from
numpy seeds."""

import numpy as np
import pytest

from torchdraco import native
from torchdraco.parallel import batch as tbatch
from torchdraco.shared.prediction import (write_normal_flips,
                                          write_tex_orientations)
from torchdraco.wire.byte_io import ByteWriter
from tpudraco.entropy import symbol_coding as jsym
from tpudraco.shared import prediction as jpred
from tpudraco.wire.byte_io import ByteWriter as JaxByteWriter

# --- what tpudraco writes --------------------------------------------------


def _want_payload(symbols: np.ndarray) -> bytes:
    """tpudraco's DIRECT_CODED section of one mesh's symbols."""
    w = JaxByteWriter()
    jsym.encode_symbols(symbols.astype(np.uint64).ravel(), 2,
                        jsym.DIRECT_CODED, w)
    return w.getvalue()


def _outcome(fn):
    """fn's bytes, or the type of what it raised (no flips: the zero
    probability's 0 / 0 reaches ``int`` as a NaN)."""
    try:
        with np.errstate(invalid="ignore"):
            return fn()
    except (ValueError, OverflowError) as e:
        return type(e)


def _written(writer_fn, row, writer_cls=ByteWriter):
    def go():
        w = writer_cls()
        writer_fn(row, w)
        return w.getvalue()
    return _outcome(go)


def _want_entries(chunk: dict):
    """tpudraco's {k: entry} for every mesh not skipped, or what the
    first raised."""
    syms, bits, flags = chunk["syms"], chunk["bits"], chunk.get("flags")
    out = {}
    for k in range(len(syms)):
        if chunk["skip"][k]:
            continue
        w = JaxByteWriter()
        if flags is None:
            w.write_u32(chunk["n_mx"])
            w.write_u32(chunk["n_mx"] // 2)
            meta = _written(jpred.write_normal_flips, bits[k].tolist(),
                            JaxByteWriter)
        else:
            meta = _written(jpred.write_tex_orientations,
                            bits[k][flags[k]].tolist(), JaxByteWriter)
        if isinstance(meta, type):
            return meta
        w.write_bytes(meta)
        if flags is not None:
            w.write_u32(int(chunk["vmin"][k]) & 0xFFFFFFFF)
            w.write_u32(int(chunk["vmax"][k]) & 0xFFFFFFFF)
        payload = _outcome(lambda: _want_payload(syms[k]))
        if isinstance(payload, type):
            return payload
        out[k] = {"payload": payload, "xform_meta": w.getvalue()}
    return out


# --- the chunks ------------------------------------------------------------


def _flip_rows(T: int, zeros: list) -> np.ndarray:
    """One row of T flips a count of clear ones, placed at random."""
    rng = np.random.default_rng(T)
    rows = np.ones((len(zeros), T), bool)
    for r, z in zip(rows, zeros):
        r[rng.permutation(T)[:z]] = False
    return rows


def _orientations(count: int, changes: int, end: bool | None = None):
    """``count`` orientations whose forward chain from True changes
    ``changes`` times; ``end`` forces the last value where it can."""
    o = np.ones(count, bool)
    o[:changes] = np.arange(changes) % 2 == 1
    if changes:
        o[changes:] = o[changes - 1]
    if end is not None and count and changes < count:
        o[-1] = end
    return o


def _normal(bits: np.ndarray, seed: int, skip=None, hi: int = 255,
            n_mx: int = 255) -> dict:
    n, T = bits.shape
    rng = np.random.default_rng(seed)
    return {"syms": rng.integers(0, hi, size=(n, T, 2)).astype(np.int32),
            "bits": bits, "n_mx": n_mx,
            "skip": np.zeros(n, bool) if skip is None else skip}


def _uv(rows: list, T: int, seed: int, skip=None, hi: int = 2047) -> dict:
    """Each mesh's orientations ``rows[k]`` at random flagged steps."""
    n = len(rows)
    rng = np.random.default_rng(seed)
    bits = rng.random((n, T)) < 0.5
    flags = np.zeros((n, T), bool)
    for k, o in enumerate(rows):
        at = np.sort(rng.permutation(T)[:len(o)])
        flags[k, at] = True
        bits[k, at] = o
    return {"syms": rng.integers(0, hi, size=(n, T, 2)).astype(np.uint32),
            "bits": bits, "flags": flags,
            "vmin": rng.integers(-(1 << 31), 0, n).astype(np.int32),
            "vmax": rng.integers(0, 1 << 31, n).astype(np.int32),
            "skip": np.zeros(n, bool) if skip is None else skip}


def _clamp_flips():
    """Around the clamps: 1 and 255 by the count of clear flips, and
    65,491 of 65,877, which float32 rounds up to 255 (254 exactly)."""
    chunks = []
    for T in (1, 2, 3, 170, 171, 255, 256, 511, 512, 513, 1000, 4096):
        zeros = sorted({z for z in (0, 1, 2, 3, T // 2, T // 2 + 1, T - 3,
                                    T - 2, T - 1, T) if 0 <= z <= T})
        chunks.append(_normal(_flip_rows(T, zeros), T))
    chunks.append(_normal(_flip_rows(65877, [65490, 65491, 65492]), 65877))
    return chunks


def _clamp_orientations():
    """As ``_clamp_flips`` by the change count, and counts where float32
    rounds across 1 (22 of 11,264), 2 (192 of 32,768) and 255 (32,576 of
    32,768; 33,085 of 33,280)."""
    rows = [_orientations(c, x) for c in (1, 2, 3, 170, 171, 255, 256, 511,
                                          512, 513)
            for x in sorted({0, 1, 2, 3, c // 2, c // 2 + 1, c - 2, c - 1,
                             c})
            if 0 <= x <= c]
    edges = [_orientations(c, x) for c, x in (
        (11264, 21), (11264, 22), (32768, 192), (32768, 32576),
        (33280, 33085))]
    return [_uv(rows, 600, 7), _uv(edges, 40000, 19)]


def _random_normal(n, T, p, seed, skip=None):
    rng = np.random.default_rng(seed)
    return _normal(rng.random((n, T)) < p, seed, skip)


def _random_uv(n, T, share, seed, skip=None):
    rng = np.random.default_rng(seed)
    rows = [rng.random(int(T * share)) < 0.5 for _ in range(n)]
    return _uv(rows, T, seed, skip)


CASES = {
    "normal-len0": lambda: [_normal(np.zeros((2, 0), bool), 1)],
    "uv-len0": lambda: [_uv([np.zeros(0, bool)] * 2, 4, 1),
                        _uv([np.zeros(0, bool)] * 2, 0, 1)],
    "normal-len1": lambda: [_normal(np.array([[False], [True]]), 2)],
    "uv-len1": lambda: [_uv([np.array([False]), np.array([True])], 3, 2)],
    "normal-len2": lambda: [_normal(np.array(
        [[False, False], [False, True], [True, False], [True, True]]), 3)],
    "uv-len2": lambda: [_uv([np.array(r, bool) for r in
                             ([0, 0], [0, 1], [1, 0], [1, 1])], 5, 3)],
    "normal-all-zero-one": lambda: [
        _normal(np.zeros((3, 50), bool), 4), _normal(np.ones((3, 50), bool),
                                                     5)],
    "uv-all-zero-one": lambda: [_uv([np.zeros(40, bool), np.ones(40, bool),
                                     np.zeros(1, bool)], 50, 6)],
    "normal-clamps": _clamp_flips,
    "uv-clamps": _clamp_orientations,
    "uv-ends-false": lambda: [_uv([_orientations(c, x, end=False)
                                   for c, x in ((1, 0), (5, 1), (9, 4),
                                                (9, 8), (64, 17))], 80, 8)],
    "normal-skipped": lambda: [_random_normal(
        6, 300, 0.3, 9, np.array([1, 0, 0, 1, 0, 1], bool)),
        _random_normal(2, 30, 0.3, 10, np.ones(2, bool))],
    "uv-skipped": lambda: [_random_uv(
        6, 300, 0.2, 11, np.array([0, 1, 1, 0, 0, 1], bool))],
    "normal-body": lambda: [_random_normal(8, 6890, 0.05, 12),
                            _random_normal(4, 6890, 0.5, 13)],
    "uv-body": lambda: [_random_uv(8, 6890, 0.3, 14)],
    "normal-1m": lambda: [_random_normal(1, 1 << 20, 0.02, 15)],
    "uv-1m": lambda: [_random_uv(1, 1 << 20, 0.1, 16)],
}


def _batch(chunk: dict):
    return tbatch._chain_payloads(
        chunk["syms"], chunk["skip"], chunk["bits"], chunk.get("flags"),
        chunk.get("vmin"), chunk.get("vmax"), chunk.get("n_mx", 0))


@pytest.mark.parametrize("library", ["native", "no_native"])
@pytest.mark.parametrize("case", list(CASES))
def test_chain_payloads_give_the_list_writers_bytes(monkeypatch, case,
                                                    library):
    """Each chunk's entries from the batch entry, and each mesh's
    metadata from the array writers, equal tpudraco's list-based writers'
    and its DIRECT_CODED section's; what tpudraco raised, the port
    raises. The span's counts: the meshes coded, skipped, the bits coded
    and whether the one native call ran."""
    if native.load_library() is None:
        pytest.fail("the native library did not build")
    chunks = CASES[case]()
    want = [_want_entries(c) for c in chunks]
    if library == "no_native":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setenv("TORCHDRACO_NO_NATIVE", "1")
        assert native.load_library() is None
    for chunk, old in zip(chunks, want):
        flags = chunk.get("flags")
        for k in np.flatnonzero(~chunk["skip"]):
            if flags is None:
                row = chunk["bits"][k]
                pair = (jpred.write_normal_flips, write_normal_flips)
            else:
                row = chunk["bits"][k][flags[k]]
                pair = (jpred.write_tex_orientations,
                        write_tex_orientations)
            assert _written(pair[1], row) == _written(
                pair[0], row.tolist(), JaxByteWriter)
        got = _outcome(lambda: _batch(chunk))
        if isinstance(old, type):
            assert got is old
            continue
        entries, counts = got
        assert entries == old
        coded = [k for k in range(len(chunk["skip"])) if not chunk["skip"][k]]
        n_bits = sum(int(chunk["bits"].shape[1]) if flags is None
                     else int(flags[k].sum()) for k in coded)
        assert counts == {"meshes": len(coded),
                          "skipped": int(chunk["skip"].sum()),
                          "bits": n_bits, "native": library == "native"}


def test_native_entry_leaves_what_it_cannot_code():
    """Offsets of -2 where the one call leaves a mesh (symbols past
    2^24's table, no flips) and -1 where it was skipped; the entries
    then come from the per-mesh writers, with tpudraco's bytes."""
    chunk = _random_normal(4, 40, 0.3, 17, np.array([0, 0, 1, 0], bool))
    chunk["syms"][1, 3, 0] = -5  # int32 read as uint32: past 2^24
    buf, offs, _ = native.chain_payloads(chunk["syms"], chunk["skip"],
                                         chunk["bits"], n_mx=255)
    assert [int(o[0]) < 0 for o in offs] == [False, True, True, False]
    assert offs[1, 0] == -2 and offs[2, 0] == -1
    assert offs[3, 0] == offs[0, 2] and len(buf) == offs[3, 2]
    # the per-mesh payload raises on the negative symbol, as tpudraco's
    assert _outcome(lambda: _batch(chunk)) is _want_entries(chunk)
    chunk["syms"][1, 3, 0] = 5
    entries, counts = _batch(chunk)
    assert entries == _want_entries(chunk)
    assert counts["native"] and counts["meshes"] == 3
    empty = _normal(np.zeros((2, 0), bool), 18)
    _, offs, n_bits = native.chain_payloads(empty["syms"], empty["skip"],
                                            empty["bits"], n_mx=255)
    assert offs[:, 0].tolist() == [-2, -2] and n_bits == 0
