"""The least time the chip could take for a job, from the job's shapes:
each input byte read once, each output byte written once, and the
operations the job needs. Frozen with the benchmark, so that the same work
reads the same bound whatever kernel, or fusion of kernels, does it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM3 at 3.35 TB/s, and 67 T operations a second outside the tensor cores
(the float32 rate; these jobs are 32-bit integer and float scalar work)."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# integer operations a symbol of a rANS lane: the table reads' address
# arithmetic, the renormalisation compare and shift, the division, the
# remainder and the state update
RANS_OPS_PER_SYMBOL = 8
# a NORMAL ring entry (a face around a vertex): two edge vectors (6),
# their cross product (9) and its sum into the vertex's (3)
RING_OPS_PER_ENTRY = 18
# a vertex of the NORMAL chain: the normalisation, the octahedral
# transform and quantization of input and prediction, the flip test and
# the canonicalized residual
NORMAL_OPS_PER_VERTEX = 60


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def rans_lanes_work(streams) -> tuple[float, float]:
    """(bytes, operations) of coding ``streams`` as rANS lanes, each a
    dict with ``symbols``, ``table_entries`` and ``payload_bytes``: the
    symbols (int32) and the frequency table (int32) a lane reads, and the
    coded bytes it writes."""
    nbytes = ops = 0.0
    for s in streams:
        nbytes += 4 * s["symbols"] + 4 * s["table_entries"] \
            + s["payload_bytes"]
        ops += RANS_OPS_PER_SYMBOL * s["symbols"]
    return nbytes, ops


def normal_encode_work(meshes: int, vertices: int, faces: int
                       ) -> tuple[float, float]:
    """(bytes, operations) of the NORMAL encode chain over ``meshes``
    meshes of one topology: each mesh's quantized positions (3 int32) and
    normals (3 float32) a vertex, the rings' corners (three int32 vertex
    indices each, shared by the meshes) read once, and two int32 symbols and
    a flip byte written a vertex."""
    ring_entries = 3 * faces
    nbytes = meshes * vertices * (12 + 12 + 8 + 1) + ring_entries * 12
    ops = meshes * (ring_entries * RING_OPS_PER_ENTRY
                    + vertices * NORMAL_OPS_PER_VERTEX)
    return nbytes, ops
