"""Attribute data model: SoA numpy arrays replacing the reference's
type-erased AttributeBuffer.

An attribute holds ``values`` — a (U, N) array of U *unique* values — plus an
optional ``point_map`` (P,) mapping point index -> unique-value index (None
means identity, i.e. no duplicate values were found).

Reference behavior: draco-oxide/src/core/attribute/mod.rs (Attribute,
remove_duplicate_values at :394-452, enums at :527-721).

Wire-format note: the reference's ComponentDataType::get_id and ::from_id
disagree with each other (U8<->I8 etc. swapped, mod.rs:566-606). We use
Google Draco's DataType ids (INT8=1, UINT8=2, ..., FLOAT32=9, FLOAT64=10),
which match the reference's from_id and the external draco_decoder; for the
float attributes produced by the OBJ/glTF loaders the two references agree.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from .. import native, trace


class ComponentType(IntEnum):
    I8 = 1
    U8 = 2
    I16 = 3
    U16 = 4
    I32 = 5
    U32 = 6
    I64 = 7
    U64 = 8
    F32 = 9
    F64 = 10

    @property
    def np_dtype(self):
        return _NP_DTYPES[self]

    @property
    def size(self) -> int:
        return np.dtype(_NP_DTYPES[self]).itemsize

    @property
    def is_float(self) -> bool:
        return self in (ComponentType.F32, ComponentType.F64)

    @classmethod
    def from_np_dtype(cls, dtype) -> "ComponentType":
        return _FROM_NP[np.dtype(dtype).name]


_NP_DTYPES = {
    ComponentType.I8: np.int8, ComponentType.U8: np.uint8,
    ComponentType.I16: np.int16, ComponentType.U16: np.uint16,
    ComponentType.I32: np.int32, ComponentType.U32: np.uint32,
    ComponentType.I64: np.int64, ComponentType.U64: np.uint64,
    ComponentType.F32: np.float32, ComponentType.F64: np.float64,
}
_FROM_NP = {np.dtype(v).name: k for k, v in _NP_DTYPES.items()}


class AttributeType(IntEnum):
    """Semantic attribute type; ids are the Draco wire ids
    (core/attribute/mod.rs:648-661)."""
    POSITION = 0
    NORMAL = 1
    COLOR = 2
    TEX_COORD = 3
    CUSTOM = 4
    TANGENT = 5
    MATERIAL = 6
    JOINT = 7
    WEIGHT = 8

    def minimum_dependency(self) -> tuple["AttributeType", ...]:
        # TexCoord prediction needs a Position parent (mod.rs:631-644)
        if self is AttributeType.TEX_COORD:
            return (AttributeType.POSITION,)
        return ()


class AttributeDomain(IntEnum):
    """Whether values attach to unique positions or to corners/points
    (core/attribute/mod.rs:696-721)."""
    POSITION = 0
    CORNER = 1


def first_occurrences(arr: np.ndarray):
    """First-occurrence dedup of the rows of 2-D ``arr``.

    Returns (first, inverse, native): ``first`` (U,) the ascending index
    of each distinct row's first appearance, ``inverse`` (P,) int64 the
    rank of each row's distinct row in that order, and whether the native
    hash pass ran. Rows are equal when their bytes are, but that float
    -0.0 counts as +0.0 (the reference compares by value equality,
    mod.rs:394-452); NaN payloads compare as bytes. Without the native
    library (or for a dtype it does not take) the numpy twin runs: a sort
    of each row's bytes."""
    arr = np.ascontiguousarray(arr)
    floating = np.issubdtype(arr.dtype, np.floating)
    if arr.ndim == 2 and not arr.dtype.hasobject and (
            not floating or arr.dtype.isnative):
        found = native.unique_rows(arr.view(np.uint8),
                                   arr.dtype.itemsize if floating else 0)
        if found is not None:
            return (*found, True)
    key = arr
    if floating:
        key = arr.copy()
        key[key == 0] = 0.0  # merge -0.0 with +0.0 like value equality
    void = key.view(np.dtype((np.void, key.dtype.itemsize * key.shape[1]))).ravel()
    _, first_idx, inverse = np.unique(void, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return np.sort(first_idx), rank[inverse.ravel()], False


def unique_rows_first_occurrence(arr: np.ndarray):
    """Unique rows of (P, N) ``arr`` in first-appearance order.

    Returns (unique_values (U, N), inverse (P,)) with
    unique_values[inverse] == arr up to -0.0/0.0 merging for float dtypes
    (``first_occurrences``); ``arr`` itself (made contiguous) where no
    row repeats."""
    arr = np.ascontiguousarray(arr)
    first, inverse, _ = first_occurrences(arr)
    return (arr if len(first) == len(arr) else arr[first]), inverse


class Attribute:
    """A mesh attribute with deduplicated values.

    ``num_points`` is the logical length (number of points); ``values`` holds
    the unique values only."""

    def __init__(self, values, att_type: AttributeType,
                 domain: AttributeDomain, parents=(), att_id: int = 0,
                 name: str | None = None, unique_id: int | None = None,
                 dedup: bool = True) -> None:
        values = np.asarray(values)
        if values.ndim == 1:
            values = values[:, None]
        self.att_id = att_id
        self.att_type = AttributeType(att_type)
        self.domain = AttributeDomain(domain)
        self.parents = list(parents)
        self.name = name
        self.unique_id = unique_id  # draco per-attribute unique id (wire)
        if dedup and len(values):
            with trace.span("build.values", rows=len(values)) as s:
                first, inverse, hashed = first_occurrences(values)
                s.note(unique=len(first), native=hashed)
                merged = len(first) < len(values)
                # no copy where every row is distinct: the caller's array
                self.values = values[first] if merged else values
            self.point_map = inverse if merged else None
        else:
            self.values = values
            self.point_map = None

    # --- shape / dtype -------------------------------------------------
    @property
    def num_points(self) -> int:
        return len(self.point_map) if self.point_map is not None else len(self.values)

    def __len__(self) -> int:
        return self.num_points

    @property
    def num_unique_values(self) -> int:
        return len(self.values)

    @property
    def num_components(self) -> int:
        return self.values.shape[1]

    @property
    def component_type(self) -> ComponentType:
        return ComponentType.from_np_dtype(self.values.dtype)

    # --- access ---------------------------------------------------------
    def unique_indices(self) -> np.ndarray:
        """(P,) point -> unique value index (identity when no duplicates)."""
        if self.point_map is not None:
            return self.point_map
        return np.arange(self.num_points, dtype=np.int64)

    def unique_val_idx(self, p: int) -> int:
        return int(self.point_map[p]) if self.point_map is not None else int(p)

    def value_at_point(self, p: int) -> np.ndarray:
        return self.values[self.unique_val_idx(p)]

    def values_per_point(self) -> np.ndarray:
        """(P, N) array expanded to the point level."""
        return self.values[self.unique_indices()]

    def value_bytes_per_point(self, num_points: int) -> np.ndarray:
        """(num_points, W) uint8: the value bytes of each of the first
        ``num_points`` points (for point hashing)."""
        if self.point_map is None:
            per_point = self.values[:num_points]
        else:
            per_point = self.values[self.point_map[:num_points]]
        per_point = np.ascontiguousarray(per_point)
        return per_point.view(np.uint8).reshape(
            len(per_point), per_point.dtype.itemsize * per_point.shape[1])

    # --- mutation -------------------------------------------------------
    def select_points(self, keep_idx: np.ndarray) -> None:
        """Keep only the points at ``keep_idx`` (ascending order preserved),
        dropping values that become unreferenced — matching the net effect of
        the reference's repeated Attribute::remove (mod.rs:455-481): value
        order is preserved, indices compacted."""
        keep_idx = np.asarray(keep_idx, dtype=np.int64)
        if self.point_map is None:
            self.values = self.values[keep_idx]
            return
        new_map = self.point_map[keep_idx]
        referenced = np.zeros(len(self.values), dtype=bool)
        referenced[new_map] = True
        new_val_idx = np.cumsum(referenced) - 1
        self.values = self.values[referenced]
        new_map = new_val_idx[new_map]
        if len(self.values) == len(new_map) and np.array_equal(
                new_map, np.arange(len(new_map))):
            self.point_map = None
        else:
            self.point_map = new_map.astype(np.int64)

    def __repr__(self) -> str:
        return (f"Attribute({self.att_type.name}, {self.domain.name}, "
                f"P={self.num_points}, U={self.num_unique_values}, "
                f"N={self.num_components}, {self.values.dtype})")
