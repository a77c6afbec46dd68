"""Top-level Draco decoder: header -> metadata -> connectivity (Spirale
Reversi) -> attributes -> mesh assembly.

The reference's in-tree decoder is WIP/disabled (lib.rs:13-14); this is a
complete fresh implementation mirroring our encoder (and the reference
encoder's stream layout).
"""

from __future__ import annotations

import numpy as np

from ..models.attribute import Attribute
from ..models.mesh import Mesh
from ..models.metadata import GeometryMetadata
from ..wire.byte_io import ByteReader
from .attribute import decode_attributes
from .connectivity import DecodeError, decode_connectivity

METADATA_FLAG_MASK = 32768


def decode_header(reader: ByteReader) -> dict:
    magic = reader.read_bytes(5)
    if magic != b"DRACO":
        raise DecodeError("not a Draco stream")
    major = reader.read_u8()
    minor = reader.read_u8()
    geometry_type = reader.read_u8()
    method = reader.read_u8()
    flags = reader.read_u16()
    return {"version": (major, minor), "geometry_type": geometry_type,
            "method": method, "flags": flags}


def decode_metadata(reader: ByteReader) -> GeometryMetadata:
    """Full metadata section parse (decode/metadata/mod.rs:24-104)."""
    return GeometryMetadata.read_from(reader)


def decode(data: bytes) -> Mesh:
    from ..utils.debug import debug_expect
    reader = ByteReader(data)
    header = decode_header(reader)
    debug_expect(reader, "header done")
    metadata = None
    if header["flags"] & METADATA_FLAG_MASK:
        metadata = decode_metadata(reader)
    if header["geometry_type"] == 0:  # point cloud
        from .point_cloud import decode_point_cloud
        mesh = decode_point_cloud(reader)
        mesh.metadata = metadata
        return mesh
    if header["method"] == 0:  # sequential mesh
        from ..wire.varint import leb128_read
        from .connectivity import decode_sequential_connectivity
        from .point_cloud import decode_sequential_attributes
        num_points = leb128_read(reader)
        if num_points > max(reader.remaining(), 1) << 12:
            # corrupt counts must not bomb the allocator (see the
            # connectivity-side guards)
            raise DecodeError("point count exceeds stream size")
        faces = decode_sequential_connectivity(reader, num_points)
        debug_expect(reader, "connectivity done")
        atts = decode_sequential_attributes(reader, num_points)
        debug_expect(reader, "attributes done")
        mesh = Mesh(faces=faces, attributes=atts)
        mesh.metadata = metadata
        return mesh
    if header["method"] != 1:
        raise DecodeError("only edgebreaker and sequential streams are "
                          "supported")
    conn = decode_connectivity(reader)
    debug_expect(reader, "connectivity done")
    atts = decode_attributes(reader, conn)
    debug_expect(reader, "attributes done")
    mesh = _assemble_mesh(conn, atts)
    mesh.metadata = metadata
    return mesh


def _assemble_mesh(conn, atts) -> Mesh:
    """Draco point construction: corners with identical per-attribute vertex
    tuples share a point; faces index points."""
    ct = conn.corner_table
    C = ct.num_corners
    if not atts:
        faces = np.arange(C, dtype=np.int64).reshape(-1, 3)
        return Mesh(faces=faces, attributes=[])

    per_att_vertex = np.stack(
        [np.asarray(a.vertex_of_corner, dtype=np.int64) for a in atts], axis=1)
    # the point construction depends only on the per-attribute vertex
    # maps — topology-determined and identical across a shared-topology
    # group (BatchDecoder), so cache it on the conn result behind an
    # exact equality guard (a ~100 KB compare vs re-sorting per blob)
    cached = getattr(conn, "_assembly_cache", None)
    if cached is not None and np.array_equal(cached[0], per_att_vertex):
        point_of_corner, keep_corners = cached[1], cached[2]
    else:
        # unique tuples in first-appearance order. Mixed-radix int64 keys
        # when they fit (np.unique over void views runs scalar and
        # dominated large decodes); void-view fallback for pathological
        # vertex counts.
        if per_att_vertex.shape[1] == 1:
            keys = per_att_vertex[:, 0]
        else:
            radices = per_att_vertex.max(axis=0).astype(np.int64) + 1
            if float(np.prod(radices.astype(np.float64))) < float(2 ** 62):
                keys = per_att_vertex[:, 0].copy()
                for j in range(1, per_att_vertex.shape[1]):
                    keys = keys * radices[j] + per_att_vertex[:, j]
            else:
                key = np.ascontiguousarray(per_att_vertex)
                keys = key.view(np.dtype(
                    (np.void, key.dtype.itemsize * key.shape[1]))).ravel()
        _, first_idx, inverse = np.unique(keys, return_index=True,
                                          return_inverse=True)
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        point_of_corner = rank[inverse.ravel()]
        keep_corners = np.sort(first_idx)
        conn._assembly_cache = (per_att_vertex, point_of_corner,
                                keep_corners)

    # per-mesh copy: decoded meshes must not alias one faces array
    faces = point_of_corner.reshape(-1, 3).copy()

    attributes = []
    pos_id = None
    for i, a in enumerate(atts):
        att = Attribute(a.values_by_vertex, a.att_type, a.domain,
                        att_id=i, unique_id=a.unique_id, dedup=False)
        pm = np.asarray(a.vertex_of_corner, dtype=np.int64)[keep_corners]
        if not np.array_equal(pm, np.arange(len(pm))) or len(pm) != len(att.values):
            att.point_map = pm
        if pos_id is None and a.att_type == 0:
            pos_id = i
        attributes.append(att)
    if pos_id is not None:
        for att in attributes:
            if att.att_id != pos_id and att.att_type in (1, 3):
                att.parents = [pos_id]
    return Mesh(faces=faces, attributes=attributes)


__all__ = ["decode", "decode_header", "DecodeError"]
