"""Edgebreaker connectivity decoding (Spirale Reversi over the reversed
CLERS stream) + attribute seam decoding.

The reconstruction core lives in torchdraco.shared.spirale (shared with the
valence-traversal encoder). This module parses the wire layout
(edgebreaker.rs:458-530 for Standard; the Valence layout replaces the
CrLight symbol buffer with per-context direct-coded rANS streams) and runs
the core.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..entropy.rans import RabsDecoder
from ..entropy.symbol_coding import decode_symbols
from ..models.corner_table import NONE, next_corner
from ..shared.clers import (EB_PREDICTIVE, EB_STANDARD, EB_VALENCE,
                            ORIENTATION_RIGHT, crlight_decode)
from ..shared.spirale import (
    NUM_VALENCE_CONTEXTS, DecodedCornerTable, DecodeError,
    spirale_reversi_core, valence_context,
)
from ..wire.bit_io import BitReader
from ..wire.byte_io import ByteReader
from ..wire.varint import leb128_read

__all__ = ["DecodeError", "DecodedCornerTable", "ConnectivityDecodeResult",
           "decode_connectivity"]


class ConnectivityDecodeResult:
    def __init__(self, ct: DecodedCornerTable, seed_corners: list[int],
                 att_seams: list[np.ndarray], num_att_data: int) -> None:
        self.corner_table = ct
        self.seed_corners = seed_corners  # attribute sequencer seed stack
        self.att_seams = att_seams        # per attribute: is_edge_on_seam[C]
        self.num_att_data = num_att_data


def decode_connectivity(reader: ByteReader) -> ConnectivityDecodeResult:
    traversal_kind = reader.read_u8()
    if traversal_kind not in (EB_STANDARD, EB_VALENCE, EB_PREDICTIVE):
        raise DecodeError(f"unsupported edgebreaker kind {traversal_kind}")
    num_vertices = leb128_read(reader)
    num_faces = leb128_read(reader)
    num_att_data = reader.read_u8()
    num_symbols = leb128_read(reader)
    num_split_symbols = leb128_read(reader)
    # corrupted counts must fail BEFORE the corner-table/symbol arrays
    # size themselves (a crafted leb128 can claim 2^60 faces and bomb
    # the allocator): 4096 symbols per stream byte exceeds what any real
    # stream carries (CrLight >= 1 bit/symbol; valence rANS at its
    # flattest legal table stays under ~2^12/byte, and the attribute
    # payload still follows)
    cap = max(reader.remaining(), 1) << 12
    if num_faces > cap or num_vertices > cap or num_symbols > cap \
            or num_split_symbols > cap:
        raise DecodeError("connectivity counts exceed stream size "
                          "(corrupt header)")

    # topology splits (spirale_reversi.rs:136-162)
    splits: list[list[int]] = []
    n_splits = leb128_read(reader)
    last = 0
    for _ in range(n_splits):
        source = leb128_read(reader) + last
        split = source - leb128_read(reader)
        splits.append([source, split, ORIENTATION_RIGHT])
        last = source
    if n_splits:
        br = BitReader(reader, msb_first=False)
        for s in splits:
            s[2] = br.read_bits(1)  # 0 = left, 1 = right

    if traversal_kind == EB_STANDARD:
        # traversal buffers: CrLight symbols, start-face flags, seams
        sym_size = leb128_read(reader)
        sym_bytes = reader.read_bytes(sym_size)
        start_face_prob_zero = reader.read_u8()
        sf_size = leb128_read(reader)
        sf_bytes = reader.read_bytes(sf_size)
        seam_streams = _read_seam_streams(reader, num_att_data)

        sym_reader = BitReader(ByteReader(sym_bytes), msb_first=False)

        def get_symbol(ct, active_stack, symbol_id):
            return crlight_decode(sym_reader)

        # native fast path: CrLight symbols are self-delimiting, so the
        # whole CLERS stream pre-decodes without reconstruction state and
        # the Spirale core runs in C++ (falls back on any malformed stream
        # so the Python core raises the precise DecodeError)
        from ..native import topo as _topo
        syms = _topo.crlight_decode(sym_bytes, num_symbols)
        nat = (_topo.spirale(syms, num_split_symbols, num_vertices,
                             num_faces, splits)
               if syms is not None else None)
        if nat is not None:
            ct = DecodedCornerTable(num_faces)
            ct.opposite = nat["opposite"]
            ct.corner_to_vertex = nat["corner_to_vertex"]
            ct.num_vertices = nat["num_vertices"]
            ct.left_most = nat["left_most"][:ct.num_vertices].tolist()
            return _finish_connectivity(
                ct, nat["active_stack"], nat["invalid_vertices"],
                nat["num_decoded_faces"], num_faces, num_symbols,
                num_att_data, start_face_prob_zero, sf_bytes, seam_streams)
    elif traversal_kind == EB_PREDICTIVE:
        # Predictive layout (EdgebreakerKind=1; the reference declares the
        # variant but ships no semantics — mod.rs:20-53): start-face flags
        # and seams as Standard, then SIX direct-coded symbol streams, one
        # per order-1 context (previous decoded symbol; context 5 seeds).
        # The context chain depends only on the symbols themselves, so the
        # whole decode-order sequence reconstructs here with no topology
        # state and feeds the native Spirale core like Standard's path.
        start_face_prob_zero = reader.read_u8()
        sf_size = leb128_read(reader)
        sf_bytes = reader.read_bytes(sf_size)
        seam_streams = _read_seam_streams(reader, num_att_data)
        pqueues: list[deque] = []
        for _ in range(6):
            n = leb128_read(reader)
            if n > cap:
                raise DecodeError("predictive stream count exceeds "
                                  "stream size (corrupt header)")
            pqueues.append(deque(decode_symbols(n, 1, reader).tolist())
                           if n else deque())
        syms_list: list[int] = []
        prev = 5
        for _ in range(num_symbols):
            if not pqueues[prev]:
                raise DecodeError(f"predictive context {prev} exhausted")
            s = int(pqueues[prev].popleft())
            if s > 4:
                raise DecodeError(f"invalid CLERS symbol {s}")
            syms_list.append(s)
            prev = s
        if any(pqueues):
            raise DecodeError("trailing symbols in predictive streams")

        from ..native import topo as _topo
        nat = _topo.spirale(np.asarray(syms_list, dtype=np.int32),
                            num_split_symbols, num_vertices, num_faces,
                            splits)
        if nat is not None:
            ct = DecodedCornerTable(num_faces)
            ct.opposite = nat["opposite"]
            ct.corner_to_vertex = nat["corner_to_vertex"]
            ct.num_vertices = nat["num_vertices"]
            ct.left_most = nat["left_most"][:ct.num_vertices].tolist()
            return _finish_connectivity(
                ct, nat["active_stack"], nat["invalid_vertices"],
                nat["num_decoded_faces"], num_faces, num_symbols,
                num_att_data, start_face_prob_zero, sf_bytes, seam_streams)

        sym_iter = iter(syms_list)

        def get_symbol(ct, active_stack, symbol_id):
            return next(sym_iter)
    else:
        # Valence layout: start-face flags, seams, then per-context
        # direct-coded symbol streams (decode order)
        start_face_prob_zero = reader.read_u8()
        sf_size = leb128_read(reader)
        sf_bytes = reader.read_bytes(sf_size)
        seam_streams = _read_seam_streams(reader, num_att_data)
        queues: list[deque] = []
        for _ in range(NUM_VALENCE_CONTEXTS):
            n = leb128_read(reader)
            if n:
                queues.append(deque(decode_symbols(n, 1, reader).tolist()))
            else:
                queues.append(deque())

        def get_symbol(ct, active_stack, symbol_id):
            ctx = valence_context(ct, active_stack)
            if not queues[ctx]:
                raise DecodeError(f"valence context {ctx} exhausted")
            return int(queues[ctx].popleft())

        # native valence fast path: queues are fully pre-decoded, contexts
        # recompute from the reconstruction state in C++
        from ..native import topo as _topo
        nat = _topo.spirale_valence(
            [np.asarray(list(q), dtype=np.int32) for q in queues],
            num_symbols, num_split_symbols, num_vertices, num_faces, splits)
        if nat is not None:
            ct = DecodedCornerTable(num_faces)
            ct.opposite = nat["opposite"]
            ct.corner_to_vertex = nat["corner_to_vertex"]
            ct.num_vertices = nat["num_vertices"]
            ct.left_most = nat["left_most"][:ct.num_vertices].tolist()
            return _finish_connectivity(
                ct, nat["active_stack"], nat["invalid_vertices"],
                nat["num_decoded_faces"], num_faces, num_symbols,
                num_att_data, start_face_prob_zero, sf_bytes, seam_streams)

    ct = DecodedCornerTable(num_faces)
    active_stack, invalid_vertices, num_decoded_faces = spirale_reversi_core(
        ct, num_symbols, num_split_symbols, num_vertices, splits, get_symbol)
    return _finish_connectivity(
        ct, active_stack, invalid_vertices, num_decoded_faces, num_faces,
        num_symbols, num_att_data, start_face_prob_zero, sf_bytes,
        seam_streams)


def _finish_connectivity(ct, active_stack, invalid_vertices,
                         num_decoded_faces, num_faces, num_symbols,
                         num_att_data, start_face_prob_zero, sf_bytes,
                         seam_streams) -> "ConnectivityDecodeResult":
    # start faces (interior flags drained in component-encode order)
    sf_rabs = RabsDecoder(ByteReader(sf_bytes), len(sf_bytes),
                          start_face_prob_zero) if sf_bytes else None
    init_corners: list[int] = []  # interior components only (encoder parity)
    while active_stack:
        corner = active_stack.pop()
        interior = sf_rabs.read() if sf_rabs else 0
        if interior:
            if num_decoded_faces >= num_faces:
                raise DecodeError("too many faces")
            corner_a = corner
            vert_n = ct.vertex(next_corner(corner_a))
            corner_b = next_corner(ct.left_most_corner(vert_n))
            vert_x = ct.vertex(next_corner(corner_b))
            corner_c = next_corner(ct.left_most_corner(vert_x))
            if corner in (corner_b, corner_c) or corner_b == corner_c:
                raise DecodeError("start face corners not distinct")
            vert_p = ct.vertex(next_corner(corner_c))
            face = num_decoded_faces
            num_decoded_faces += 1
            new_corner = 3 * face
            ct.set_opposite(new_corner, corner)
            ct.set_opposite(new_corner + 1, corner_b)
            ct.set_opposite(new_corner + 2, corner_c)
            ct.corner_to_vertex[new_corner] = vert_x
            ct.corner_to_vertex[new_corner + 1] = vert_p
            ct.corner_to_vertex[new_corner + 2] = vert_n
            init_corners.append(new_corner)

    if num_decoded_faces != num_faces:
        raise DecodeError(
            f"decoded {num_decoded_faces} faces, expected {num_faces}")

    _remove_invalid_vertices(ct, invalid_vertices)

    # attribute sequencer seed: mirrors the encoder's
    # rev(init_face_corners) ++ processed_corners (edgebreaker.rs:516-524).
    # Encoder processed corner at step i corresponds to decoder face
    # (num_symbols - 1 - i)'s first corner.
    processed = [3 * (num_symbols - 1 - i) for i in range(num_symbols)]
    seed = list(reversed(init_corners)) + processed

    att_seams = _decode_att_seams(ct, num_symbols, seam_streams)
    return ConnectivityDecodeResult(ct, seed, att_seams, num_att_data)


def decode_sequential_connectivity(reader: ByteReader,
                                   num_points: int) -> np.ndarray:
    """Mirror of encode.connectivity.encode_sequential: u64 face count,
    u8 method, then the index payload.

    Method 1 (DirectIndices): indices at 8/16/32 bits or leb128 for the
    21-bit range, switched on the point count (shared/connectivity/
    sequential.rs index_size_from_vertex_count). Method 0 (Compressed,
    modeled-but-unimplemented in the reference, sequential.rs:23-38):
    sign-folded consecutive deltas in one symbol_coding stream."""
    num_faces = reader.read_u64()
    method = reader.read_u8()
    n = num_faces * 3
    if method == 0:
        from ..entropy.symbol_coding import decode_symbols
        # corrupted counts must fail BEFORE the symbol decoder sizes its
        # output (same 4096-symbols-per-byte bound as the edgebreaker
        # header guard)
        if n > max(reader.remaining(), 1) << 12:
            raise DecodeError("sequential face count exceeds stream size")
        syms = decode_symbols(n, 1, reader).ravel().astype(np.int64)
        diffs = np.where(syms & 1, -(syms >> 1), syms >> 1)
        flat = np.cumsum(diffs)
        if len(flat) and (flat.min() < 0 or flat.max() >= num_points):
            raise DecodeError("compressed sequential index out of range")
        return flat.reshape(-1, 3)
    if method != 1:
        raise DecodeError(f"unsupported sequential method {method}")
    if num_points < 0x100:
        flat = np.frombuffer(reader.read_bytes(n), dtype=np.uint8)
    elif num_points < 0x10000:
        flat = np.frombuffer(reader.read_bytes(2 * n), dtype="<u2")
    elif num_points < (1 << 21):
        flat = np.asarray([leb128_read(reader) for _ in range(n)],
                          dtype=np.int64)
    elif num_points < 0x1000000:
        flat = np.frombuffer(reader.read_bytes(4 * n), dtype="<u4")
    else:
        raise DecodeError("too many vertices for sequential connectivity")
    return flat.astype(np.int64).reshape(-1, 3)


def _read_seam_streams(reader: ByteReader, num_att_data: int):
    seam_streams = []
    for _ in range(num_att_data):
        prob_zero = reader.read_u8()
        size = leb128_read(reader)
        blob = reader.read_bytes(size)
        seam_streams.append((prob_zero, blob))
    return seam_streams


def _remove_invalid_vertices(ct: DecodedCornerTable,
                             invalid_vertices: list[int]) -> None:
    """Compact isolated vertices by swapping with the last valid vertex
    (spirale_reversi.rs:590-625 / draco)."""
    num_vertices = ct.num_vertices
    for invalid in invalid_vertices:
        src = num_vertices - 1
        while ct.left_most[src] == NONE:
            num_vertices -= 1
            src = num_vertices - 1
        if src < invalid:
            continue
        for c in ct.vertex_corners(src):
            if ct.vertex(c) != src:
                raise DecodeError("corrupted vertex mapping")
            ct.corner_to_vertex[c] = invalid
        ct.left_most[invalid] = ct.left_most[src]
        ct.left_most[src] = NONE
        num_vertices -= 1
    ct.num_vertices = num_vertices
    ct.left_most = ct.left_most[:num_vertices]


def _decode_att_seams(ct: DecodedCornerTable, num_symbols: int,
                      seam_streams) -> list[np.ndarray]:
    """Replay symbol faces in decode order, reading one seam bit per
    attribute for every interior edge seen first from this side (mirrors
    the encoder's seam collection, edgebreaker.rs:610-653). Boundary edges
    are implicit seams."""
    out = []
    for _ in seam_streams:
        seam = np.zeros(ct.num_corners, dtype=bool)
        seam[np.asarray(ct.opposite) == NONE] = True
        out.append(seam)
    if not seam_streams:
        return out
    # collect the edge replay order vectorized: symbol faces replay in id
    # order, so "opposite face not yet visited" is just opp_face > f
    fs = np.arange(num_symbols, dtype=np.int64)
    corners3 = np.stack([3 * fs, 3 * fs + 1, 3 * fs + 2], axis=1)
    opp3 = np.asarray(ct.opposite, dtype=np.int64)[corners3]
    emit = (opp3 != NONE) & (opp3 // 3 > fs[:, None])
    earr = np.stack([corners3[emit], opp3[emit]], axis=1)
    if len(earr):
        for j, (prob, blob) in enumerate(seam_streams):
            dec = RabsDecoder(ByteReader(blob), len(blob), prob)
            bits = dec.read_all(len(earr)).astype(bool)
            out[j][earr[bits, 0]] = True
            out[j][earr[bits, 1]] = True
    return out
