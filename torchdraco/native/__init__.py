"""Native (C++) fast paths, loaded via ctypes with automatic build.

The library is compiled on first use with g++ -O3 into the package's
gitignored ``_build/`` directory (beside the CUDA kernels' library), under
a temporary name of this process before an atomic rename, so concurrent
first uses do not race. Every entry point has a pure-Python fallback in
torchdraco.entropy, so the host codec works (slowly) without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_lib = None
_tried = False


# -ffp-contract=off: quantize.cpp's correctness contract is that
# mul+add stays two rounded f32 ops (an FMA contraction would diverge
# from the numpy twin in about 1 of 3M values);
# the integer coders are unaffected
_CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(_CXXFLAGS).encode())
    for name in sorted(os.listdir(_SRC)):
        if name.endswith(".cpp") or name.endswith(".h"):
            with open(os.path.join(_SRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def load_library():
    """Returns the ctypes library or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TORCHDRACO_NO_NATIVE"):
        return None
    try:
        os.makedirs(_BUILD, exist_ok=True)
        so_path = os.path.join(
            _BUILD, f"libtorchdraco_native_{_source_hash()}.so")
        if not os.path.isfile(so_path):
            srcs = [os.path.join(_SRC, n) for n in sorted(os.listdir(_SRC))
                    if n.endswith(".cpp")]
            tmp = f"{so_path}.tmp{os.getpid()}"
            subprocess.run(["g++"] + _CXXFLAGS + ["-o", tmp] + srcs,
                           check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        # every pointer argument is c_void_p: call sites pass the raw
        # ndarray.ctypes.data address (ctypes.cast/data_as is a large
        # share of a small-mesh encode()). The
        # typed POINTER forms checked nothing ctypes can verify anyway;
        # callers must keep the owning array alive across the call
        # (all sites pass named locals or views of named locals).
        i64, i32, u8p, i32p = (ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_void_p, ctypes.c_void_p)
        lib.tdn_rans_encode.restype = i64
        lib.tdn_rans_encode.argtypes = [i32p, i64, i32p, i32p, i32, i64,
                                         u8p, i64]
        lib.tdn_rans_decode.restype = i32
        lib.tdn_rans_decode.argtypes = [u8p, i64, i32p, i32p, i32p, i32,
                                         i64, i64, i32p]
        lib.tdn_rabs_encode.restype = i64
        lib.tdn_rabs_encode.argtypes = [u8p, i64, i32, i32, i64, u8p, i64]
        lib.tdn_rabs_decode.restype = i32
        lib.tdn_rabs_decode.argtypes = [u8p, i64, i32, i32, i64, i64, u8p]
        i64p = ctypes.c_void_p
        lib.tdn_parse_rans_table.restype = i64
        lib.tdn_parse_rans_table.argtypes = [u8p, i64, i64, i64p]
        u64p_ = ctypes.c_void_p
        lib.tdn_encode_direct.restype = i64
        lib.tdn_encode_direct.argtypes = [u64p_, i64, u8p, i64]
        lib.tdn_chain_payloads.restype = i64
        lib.tdn_chain_payloads.argtypes = [
            i64, i64, i64, u8p, u8p, u8p, u8p, i32p, i32p, ctypes.c_uint32,
            u8p, i64, i64p, i64p]
        lib.tdn_rans_decode_auto.restype = i32
        lib.tdn_rans_decode_auto.argtypes = [u8p, i64, i32p, i32p, i64,
                                              i32, i64, i64, i32p]
        f32p = ctypes.c_void_p
        u16p = ctypes.c_void_p
        lib.tdn_quantize_batch.restype = i32
        lib.tdn_quantize_batch.argtypes = [f32p, i64, i64, i64, i32,
                                            u16p, f32p, f32p, i32p, i32p]
        lib.tdn_pack12.restype = None
        lib.tdn_pack12.argtypes = [u16p, i64, u8p, u8p]
        u64p = ctypes.c_void_p
        lib.tdn_predict_wrapped_zigzag.restype = i32
        lib.tdn_predict_wrapped_zigzag.argtypes = [
            i32p, i64, i64, i32p, i32p, i32p, i32p, i32p, u8p, u8p, i64,
            u64p, i32p, i32p]
        lib.tdn_unique_rows.restype = i64
        lib.tdn_unique_rows.argtypes = [u8p, i64, i64, i32, i64p, i64p]
        _lib = lib
    except Exception as exc:
        # fall back to the pure-Python paths, but loudly: a silent 15x
        # slowdown is much harder to notice than a warning
        import warnings
        detail = ""
        if isinstance(exc, subprocess.CalledProcessError):
            detail = (exc.stderr or b"").decode("utf-8", "replace")[:500]
        warnings.warn(
            f"torchdraco native build unavailable ({exc!r}) {detail}; "
            "using pure-Python fallbacks", RuntimeWarning)
        _lib = None
    return _lib


def _i32p(a: np.ndarray) -> int:
    # raw address for a c_void_p argument slot; the caller must keep
    # the array alive across the call (unlike data_as, nothing here
    # holds a reference)
    return a.ctypes.data


def _u8p(a: np.ndarray) -> int:
    return a.ctypes.data


def quantize_batch(vals: np.ndarray, bits: int):
    """Fused batch quantize: f32 (B, V, C) -> (q uint16 (B, V, C),
    mins f32 (B, C), delta_max f32 (B,), vmin i32 (B,), vmax i32 (B,)).
    Bit-exact twin of parallel.batch.quantize_positions_host (equality
    pinned by tests/test_parallel.py) in two memory passes instead of
    ~10. Returns None when the native library is unavailable OR the
    input holds non-finite values (the caller re-runs the numpy twin,
    which raises the canonical per-mesh error)."""
    lib = load_library()
    if lib is None or not (0 < bits <= 16):
        return None
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    B, V, C = vals.shape
    q = np.empty((B, V, C), dtype=np.uint16)
    mins = np.empty((B, C), dtype=np.float32)
    delta = np.empty((B,), dtype=np.float32)
    vmin = np.empty((B,), dtype=np.int32)
    vmax = np.empty((B,), dtype=np.int32)
    rc = lib.tdn_quantize_batch(
        vals.ctypes.data, B, V, C, bits,
        q.ctypes.data, mins.ctypes.data,
        delta.ctypes.data, _i32p(vmin), _i32p(vmax))
    if rc != 0:
        return None
    return q, mins, delta, vmin, vmax


def pack12(q: np.ndarray):
    """Pack uint16 values < 4096 into (lo bytes, paired high nibbles)
    for the 12-bit H2D upload (see csrc/quantize.cpp::tdn_pack12 and
    ops/device.py::unpack12_kernel). The first axis is the batch axis:
    nibbles pair within a row only, so a (B, ...) batch keeps hb
    shardable as (B, ceil(N/2)) under the data-parallel mesh. Falls back
    to a numpy twin (equality-pinned) when the native library is
    missing."""
    q = np.ascontiguousarray(q, dtype=np.uint16)
    B = q.shape[0] if q.ndim > 1 else 1
    n = q.size // B
    lo = np.empty(q.shape, dtype=np.uint8)
    hb = np.empty((B, (n + 1) // 2), dtype=np.uint8)
    lib = load_library()
    if lib is not None:
        if n % 2 == 0:
            # pairs never cross rows when the row length is even: one
            # flat pass over the whole batch
            lib.tdn_pack12(q.ctypes.data, q.size, _u8p(lo), _u8p(hb))
        else:
            q2 = q.reshape(B, n)
            lo2 = lo.reshape(B, n)
            for b in range(B):
                lib.tdn_pack12(_u8p(q2[b]), n, _u8p(lo2[b]), _u8p(hb[b]))
        return lo, hb if q.ndim > 1 else hb[0]
    flat = q.reshape(B, n)
    np.copyto(lo.reshape(B, n), flat.astype(np.uint8))
    hi = (flat >> 8).astype(np.uint8)
    if n & 1:
        hi = np.concatenate([hi, np.zeros((B, 1), dtype=np.uint8)], axis=1)
    np.bitwise_or(hi[:, 0::2], hi[:, 1::2] << 4, out=hb)
    return lo, hb if q.ndim > 1 else hb[0]


def unique_rows(rows: np.ndarray, float_bytes: int):
    """First-occurrence dedup of the rows of ``rows``, (n, w) uint8
    C-contiguous, in one hashed pass (csrc/dedup.cpp). ``float_bytes``
    (2, 4 or 8) reads the rows as floats of that size, whose -0.0
    elements count as +0.0; 0 compares raw bytes. Returns (first int64
    (u,): the ascending index of each distinct row's first appearance,
    inverse int64 (n,): each row's rank in that order), or None without
    a toolchain or for inputs the C path leaves to the numpy twin
    (``models.attribute.first_occurrences``)."""
    lib = load_library()
    if lib is None:
        return None
    n, w = rows.shape
    first = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    u = lib.tdn_unique_rows(_u8p(rows), n, w, float_bytes,
                            first.ctypes.data, inverse.ctypes.data)
    if u < 0:
        return None
    return first[:u], inverse


def rans_encode(symbols: np.ndarray, freqs: np.ndarray, cums: np.ndarray,
                precision: int, l_base: int) -> bytes | None:
    lib = load_library()
    if lib is None:
        return None
    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    freqs = np.ascontiguousarray(freqs, dtype=np.int32)
    cums = np.ascontiguousarray(cums, dtype=np.int32)
    cap = len(symbols) * 8 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.tdn_rans_encode(_i32p(symbols), len(symbols), _i32p(freqs),
                             _i32p(cums), precision, l_base, _u8p(out), cap)
    if n < 0:
        raise ValueError("native rANS encode failed")
    return out[:n].tobytes()


def rans_decode(blob: bytes, freqs: np.ndarray, cums: np.ndarray,
                slots: np.ndarray, precision: int, l_base: int,
                n: int) -> np.ndarray | None:
    lib = load_library()
    if lib is None:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8)
    freqs = np.ascontiguousarray(freqs, dtype=np.int32)
    cums = np.ascontiguousarray(cums, dtype=np.int32)
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    rc = lib.tdn_rans_decode(_u8p(buf), len(buf), _i32p(freqs), _i32p(cums),
                              _i32p(slots), precision, l_base, n, _i32p(out))
    if rc != 0:
        raise ValueError("native rANS decode failed")
    return out


def encode_direct(symbols: np.ndarray) -> bytes | None:
    """Whole DirectCoded section ([bit-length, table, leb128 len, rANS
    stream]) in one native call — twin of _encode_direct_coded (bytes
    pinned by tests). None without a toolchain or for inputs the C path
    bounds out (empty streams, symbols >= 2^24); the Python path then
    raises the canonical errors."""
    lib = load_library()
    if lib is None or len(symbols) == 0:
        return None
    symbols = np.ascontiguousarray(symbols, dtype=np.uint64)
    cap = len(symbols) * 8 + 3 * (1 << 20) + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.tdn_encode_direct(symbols.ctypes.data, len(symbols),
                               _u8p(out), cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def chain_payloads(symbols: np.ndarray, skip: np.ndarray, bits: np.ndarray,
                   flags: np.ndarray | None = None,
                   vmin: np.ndarray | None = None,
                   vmax: np.ndarray | None = None, n_mx: int = 0):
    """The chain entries of one NORMAL (``flags`` None: ``bits`` the
    flips, ``n_mx`` the wire's maximum) or TEX_COORD attribute (``bits``
    the orientation values, ``flags`` which are coded, ``vmin`` /
    ``vmax`` the ranges) of a chunk, in one call (csrc/rans.cpp
    ``tdn_chain_payloads``). symbols (n, T, C) int32 or uint32, bits
    and flags (n, T), skip (n,). Returns (buf, offsets (n, 3), bits
    coded): mesh k's metadata is ``buf[o0:o1]``, its DIRECT_CODED
    payload ``buf[o1:o2]``; o0 is -1 where ``skip[k]`` and -2 where the
    mesh is left to the per-mesh writers. None without a toolchain."""
    lib = load_library()
    if lib is None:
        return None
    n, T, C = symbols.shape
    if bits.shape != (n, T) or skip.shape != (n,):
        raise ValueError(f"chain payloads: bits {bits.shape} and skip "
                         f"{skip.shape} do not fit symbols {symbols.shape}")
    if symbols.dtype not in (np.int32, np.uint32):
        raise ValueError(f"chain payloads: symbols of {symbols.dtype}")
    # int32 symbols are read as uint32: a negative one exceeds 2^24 and
    # leaves its mesh to the per-mesh writers, which raise on it
    syms = np.ascontiguousarray(symbols).view(np.uint32)
    bits_u8 = np.ascontiguousarray(bits, dtype=bool).view(np.uint8)
    skip_u8 = np.ascontiguousarray(skip, dtype=bool).view(np.uint8)
    if flags is None:
        flags_u8 = None
        lo = hi = np.zeros(n, dtype=np.int32)
    else:
        if flags.shape != (n, T) or vmin.shape != (n,) \
                or vmax.shape != (n,):
            raise ValueError("chain payloads: flags, vmin or vmax do not "
                             "fit the symbols")
        flags_u8 = np.ascontiguousarray(flags, dtype=bool).view(np.uint8)
        lo = np.ascontiguousarray(vmin, dtype=np.int32)
        hi = np.ascontiguousarray(vmax, dtype=np.int32)
    # a mesh: metadata at most T + 32 bytes; a payload at most 3 bytes a
    # symbol, 3 a table entry and 64 more (tdn_encode_direct); a mesh
    # past this leaves the call, not the result
    S = min(int(syms.max()) + 1 if syms.size else 1, 1 << 16)
    cap = n * (T + 4 * T * C + 3 * S + 128)
    out = np.empty(cap, dtype=np.uint8)
    offs = np.empty((n, 3), dtype=np.int64)
    n_bits = np.zeros(1, dtype=np.int64)
    used = lib.tdn_chain_payloads(
        n, T, C, _u8p(bits_u8), None if flags_u8 is None else _u8p(flags_u8),
        syms.ctypes.data, _u8p(skip_u8), _i32p(lo), _i32p(hi), n_mx,
        _u8p(out), cap, offs.ctypes.data, n_bits.ctypes.data)
    return out[:used].tobytes(), offs, int(n_bits[0])


def predict_wrapped_zigzag(vals: np.ndarray, origs_idx: np.ndarray,
                           nxt: np.ndarray, prv: np.ndarray,
                           opp: np.ndarray, fb: np.ndarray,
                           can_para_u8: np.ndarray, has_fb_u8: np.ndarray):
    """Fused parallelogram + wrapped-difference + zigzag over a
    traversal. vals int32 (V, C) C-contiguous; index arrays int32 (T,);
    flags uint8 (T,). Returns (symbols uint64 (T, C), vmin, vmax) or
    None without a toolchain."""
    lib = load_library()
    if lib is None:
        return None
    V, C = vals.shape
    T = len(origs_idx)
    out = np.empty((T, C), dtype=np.uint64)
    vminmax = np.empty(2, dtype=np.int32)
    rc = lib.tdn_predict_wrapped_zigzag(
        _i32p(vals), V, C, _i32p(origs_idx), _i32p(nxt), _i32p(prv),
        _i32p(opp), _i32p(fb), _u8p(can_para_u8), _u8p(has_fb_u8), T,
        out.ctypes.data, _i32p(vminmax[:1]), _i32p(vminmax[1:]))
    if rc != 0:
        return None
    return out, int(vminmax[0]), int(vminmax[1])


def rans_decode_auto(blob: bytes, freqs: np.ndarray, cums: np.ndarray,
                     precision: int, l_base: int,
                     n: int) -> np.ndarray | None:
    """rans_decode with the slot table built natively (saves the 2^P-entry
    np.repeat per blob)."""
    lib = load_library()
    if lib is None:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8)
    freqs = np.ascontiguousarray(freqs, dtype=np.int32)
    cums = np.ascontiguousarray(cums, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    rc = lib.tdn_rans_decode_auto(_u8p(buf), len(buf), _i32p(freqs),
                                   _i32p(cums), len(freqs), precision,
                                   l_base, n, _i32p(out))
    if rc != 0:
        raise ValueError("native rANS decode failed")
    return out


def parse_rans_table_body(view, num_symbols: int):
    """Parse the token body of a serialized rANS table from ``view``
    (bytes/memoryview positioned AT the tokens). Returns
    (dist int64 (num_symbols,), bytes_consumed) or None (no library /
    corrupt stream — the caller falls back to the Python loop, which
    raises the canonical error)."""
    lib = load_library()
    if lib is None:
        return None
    buf = np.frombuffer(view, dtype=np.uint8)
    dist = np.empty(num_symbols, dtype=np.int64)
    n = lib.tdn_parse_rans_table(_u8p(buf), len(buf), num_symbols,
                                  dist.ctypes.data)
    if n < 0:
        return None
    return dist, int(n)


def rabs_encode(bits: np.ndarray, freq0: int, precision: int,
                l_base: int) -> bytes | None:
    lib = load_library()
    if lib is None:
        return None
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    cap = len(bits) * 2 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.tdn_rabs_encode(_u8p(bits), len(bits), freq0, precision,
                             l_base, _u8p(out), cap)
    if n < 0:
        raise ValueError("native RAbS encode failed")
    return out[:n].tobytes()


def rabs_decode(blob: bytes, freq0: int, precision: int, l_base: int,
                n: int) -> np.ndarray | None:
    lib = load_library()
    if lib is None:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    rc = lib.tdn_rabs_decode(_u8p(buf), len(buf), freq0, precision,
                              l_base, n, _u8p(out))
    if rc != 0:
        raise ValueError("native RAbS decode failed")
    return out
