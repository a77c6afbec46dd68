"""PLY mesh/point-cloud I/O (ascii + binary_little_endian).

The reference's scene_io lists Ply as a supported format enum but its
dispatch is `unimplemented!` (io/gltf/scene_io.rs:84-97); this is a real
implementation. Vertex properties map to draco attributes the same way the
OBJ loader's do: x/y/z -> POSITION, nx/ny/nz -> NORMAL, s/t | u/v ->
TEX_COORD, red/green/blue(/alpha) -> COLOR (uint8 kept). A file without a
face element loads as a point cloud (empty faces — encode() handles it via
geometry type 0).
"""

from __future__ import annotations

import numpy as np

from ..models import AttributeDomain, AttributeType, MeshBuilder
from ..models.mesh import Mesh

# the header comment of written files: tpudraco's, so that a file written by
# this copy equals the reference package's byte for byte
_COMMENT = "comment tpudraco"

_TYPES = {
    "char": np.int8, "int8": np.int8,
    "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
}


class PlyError(Exception):
    pass


def _parse_header(data: bytes):
    end = data.find(b"end_header")
    if data[:3] != b"ply" or end < 0:
        raise PlyError("not a PLY file")
    end = data.find(b"\n", end) + 1
    lines = data[:end].decode("ascii", "replace").splitlines()
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) | ("__list__", ...)])
    for ln in lines[1:]:
        parts = ln.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise PlyError("property before element")
            if parts[1] == "list":
                elements[-1][2].append(
                    ("__list__", _TYPES[parts[2]], _TYPES[parts[3]],
                     parts[4]))
            else:
                elements[-1][2].append((parts[2], _TYPES[parts[1]]))
        elif parts[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian"):
        raise PlyError(f"unsupported PLY format {fmt!r}")
    return fmt, elements, end


def _read_elements(data: bytes, fmt: str, elements, body_off: int):
    """Returns {element name: {prop: ndarray}} (+ 'faces' for list props)."""
    out = {}
    if fmt == "ascii":
        tokens = data[body_off:].split()
        ti = 0
        for name, count, props in elements:
            n_lists = sum(1 for p in props if p[0] == "__list__")
            if n_lists and len(props) != 1:
                # same constraint as the binary path: a second list (e.g.
                # per-face texcoords) would silently corrupt connectivity
                raise PlyError("mixed list/scalar elements not supported")
            cols = {p[0]: [] for p in props}
            faces = []
            for _ in range(count):
                for p in props:
                    if p[0] == "__list__":
                        n = int(tokens[ti]); ti += 1
                        idx = [int(tokens[ti + k]) for k in range(n)]
                        ti += n
                        faces.append(idx)
                    else:
                        cols[p[0]].append(float(tokens[ti])); ti += 1
            rec = {k: np.asarray(v) for k, v in cols.items()
                   if k != "__list__"}
            for p in props:
                if p[0] != "__list__":
                    rec[p[0]] = rec[p[0]].astype(p[1])
            if faces:
                rec["__faces__"] = faces
            out[name] = rec
        return out

    off = body_off
    for name, count, props in elements:
        if all(p[0] != "__list__" for p in props):
            dt = np.dtype([(p[0], np.dtype(p[1]).newbyteorder("<"))
                           for p in props])
            arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            out[name] = {p[0]: arr[p[0]] for p in props}
        else:
            # variable-length list rows read one by one (uniform-size rows
            # fast-path: probe the first row and bulk-read if consistent)
            faces = []
            rec = {}
            if len(props) == 1 and props[0][0] == "__list__":
                _, cnt_t, idx_t, _pname = props[0]
                cnt_dt = np.dtype(cnt_t).newbyteorder("<")
                idx_dt = np.dtype(idx_t).newbyteorder("<")
                if count:
                    n0 = int(np.frombuffer(data, cnt_dt, 1, off)[0])
                    row = cnt_dt.itemsize + n0 * idx_dt.itemsize
                    bulk_ok = off + row * count <= len(data)
                    if bulk_ok:
                        blk = np.frombuffer(data, np.uint8, row * count,
                                            off)
                        # verify every row really has the same count —
                        # ragged lists (mixed tri/quad) take the scalar
                        # walk below instead
                        cnts = blk.reshape(count, row)[:, :cnt_dt.itemsize]\
                            .copy().view(cnt_dt).ravel()
                        bulk_ok = bool((cnts == n0).all())
                    if bulk_ok:
                        idx = blk.reshape(count, row)[:, cnt_dt.itemsize:]\
                            .copy().view(idx_dt).reshape(count, n0)
                        faces = idx.astype(np.int64).tolist()
                        off += row * count
                    else:  # ragged or short buffer: scalar walk
                        for _ in range(count):
                            n = int(np.frombuffer(data, cnt_dt, 1, off)[0])
                            off += cnt_dt.itemsize
                            idx = np.frombuffer(data, idx_dt, n, off)
                            off += n * idx_dt.itemsize
                            faces.append(idx.astype(np.int64).tolist())
            else:
                raise PlyError("mixed list/scalar elements not supported")
            rec["__faces__"] = faces
            out[name] = rec
    return out


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, body_off = _parse_header(data)
    rec = _read_elements(data, fmt, elements, body_off)
    if "vertex" not in rec:
        raise PlyError("PLY without a vertex element")
    v = rec["vertex"]
    for c in ("x", "y", "z"):
        if c not in v:
            raise PlyError("vertex element missing x/y/z")
    pos = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)

    faces = []
    for name in ("face", "faces"):
        if name in rec and "__faces__" in rec[name]:
            for poly in rec[name]["__faces__"]:
                for k in range(1, len(poly) - 1):  # fan-triangulate
                    faces.append([poly[0], poly[k], poly[k + 1]])
    faces = (np.asarray(faces, dtype=np.int64) if faces
             else np.zeros((0, 3), dtype=np.int64))

    # shared per-point attribute extraction (mesh and point-cloud paths)
    extra: list[tuple[np.ndarray, AttributeType, str]] = []
    if all(c in v for c in ("nx", "ny", "nz")):
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], 1).astype(np.float32)
        extra.append((nrm, AttributeType.NORMAL, "NORMAL"))
    for ua, va in (("s", "t"), ("u", "v"), ("texture_u", "texture_v")):
        if ua in v and va in v:
            uv = np.stack([v[ua], v[va]], 1).astype(np.float32)
            extra.append((uv, AttributeType.TEX_COORD, "TEXCOORD_0"))
            break
    if all(c in v for c in ("red", "green", "blue")):
        chans = [v["red"], v["green"], v["blue"]]
        if "alpha" in v:
            chans.append(v["alpha"])
        extra.append((np.stack(chans, 1), AttributeType.COLOR, "COLOR_0"))

    if len(faces) == 0:
        # point cloud: builder-based dedup/reorder is face-driven; keep
        # the raw per-point attributes instead
        from ..models.attribute import Attribute
        atts = [Attribute(pos, AttributeType.POSITION,
                          AttributeDomain.POSITION, name="POSITION")]
        atts[0].att_id = 0
        for vals, ty, nm in extra:
            a = Attribute(vals, ty, AttributeDomain.CORNER,
                          parents=[0], name=nm)
            a.att_id = len(atts)
            atts.append(a)
        return Mesh(faces=faces, attributes=atts)

    builder = MeshBuilder()
    builder.set_connectivity_attribute(faces)
    pid = builder.add_attribute(pos, AttributeType.POSITION,
                                AttributeDomain.POSITION, name="POSITION")
    for vals, ty, nm in extra:
        parents = ([pid] if ty in (AttributeType.NORMAL,
                                   AttributeType.TEX_COORD) else [])
        builder.add_attribute(vals, ty, AttributeDomain.CORNER,
                              parents=parents, name=nm)
    return builder.build()


def save_ply(mesh: Mesh, path: str, binary: bool = True) -> None:
    pos_att = mesh.position_attribute()
    pos = np.asarray(pos_att.values_per_point(), dtype=np.float32)
    props = [("x", pos[:, 0]), ("y", pos[:, 1]), ("z", pos[:, 2])]
    nrm = next((a for a in mesh.attributes
                if a.att_type == AttributeType.NORMAL), None)
    if nrm is not None and nrm.num_components >= 3:
        nv = np.asarray(nrm.values_per_point(), dtype=np.float32)
        props += [("nx", nv[:, 0]), ("ny", nv[:, 1]), ("nz", nv[:, 2])]
    uv = next((a for a in mesh.attributes
               if a.att_type == AttributeType.TEX_COORD), None)
    if uv is not None and uv.num_components >= 2:
        uvv = np.asarray(uv.values_per_point(), dtype=np.float32)
        props += [("s", uvv[:, 0]), ("t", uvv[:, 1])]
    col = next((a for a in mesh.attributes
                if a.att_type == AttributeType.COLOR), None)
    col_u8 = None
    if col is not None and col.num_components >= 3:
        cv = np.asarray(col.values_per_point())
        if np.issubdtype(cv.dtype, np.floating):
            cv = np.clip(cv * 255.0 + 0.5, 0, 255)
        col_u8 = cv.astype(np.uint8)

    n = len(pos)
    faces = np.asarray(mesh.faces, dtype=np.int64)
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              _COMMENT,
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in props]
    if col_u8 is not None:
        for c in ("red", "green", "blue", "alpha")[:col_u8.shape[1]]:
            header.append(f"property uchar {c}")
    header.append(f"element face {len(faces)}")
    header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fields = [(name, "<f4") for name, _ in props]
            if col_u8 is not None:
                fields += [(c, "u1") for c in
                           ("red", "green", "blue", "alpha")
                           [:col_u8.shape[1]]]
            rec = np.empty(n, dtype=np.dtype(fields))
            for name, vals in props:
                rec[name] = vals
            if col_u8 is not None:
                for k, c in enumerate(("red", "green", "blue", "alpha")
                                      [:col_u8.shape[1]]):
                    rec[c] = col_u8[:, k]
            f.write(rec.tobytes())
            if len(faces):
                fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
                frec = np.empty(len(faces), dtype=fdt)
                frec["n"] = 3
                frec["i"] = faces.astype(np.int32)
                f.write(frec.tobytes())
        else:
            for i in range(n):
                row = [repr(float(vals[i])) for _, vals in props]
                if col_u8 is not None:
                    row += [str(int(x)) for x in col_u8[i]]
                f.write((" ".join(row) + "\n").encode("ascii"))
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode("ascii"))
