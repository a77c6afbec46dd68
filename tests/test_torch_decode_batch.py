"""torchdraco's shared-topology batch decoder against tpudraco.decode.decode
and tpudraco's own BatchDecoder, and the stream-lane slice (port encode,
port device decode) in a process where neither JAX nor tpudraco can be
imported."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torchdraco  # noqa: E402
from torchdraco.parallel import BatchDecoder  # noqa: E402
from torchdraco.parallel import decode_batch as tdb  # noqa: E402
from tpudraco.decode import decode  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import (  # noqa: E402
    AttributeDomain, AttributeType, MeshBuilder,
)
from tpudraco.parallel import BatchDecoder as JaxBatchDecoder  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a finder that refuses jax and tpudraco, as on a machine with neither
_BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpudraco"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""


def _grid_mesh(n, seed, uv=False):
    """tests/test_parallel.py's grid mesh; with ``uv`` a TEX_COORD
    attribute too, so a blob carries more than one symbol stream."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32)], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    b = MeshBuilder()
    b.set_connectivity_attribute(np.asarray(faces))
    pid = b.add_attribute(pos, AttributeType.POSITION,
                          AttributeDomain.POSITION)
    if uv:
        b.add_attribute(rng.rand(n * n, 2).astype(np.float32),
                        AttributeType.TEX_COORD, AttributeDomain.POSITION,
                        parents=[pid])
    return b.build()


def _same_mesh(got, ref) -> bool:
    return (np.array_equal(got.faces, ref.faces)
            and len(got.attributes) == len(ref.attributes)
            and all(np.array_equal(np.asarray(a.values), np.asarray(b.values))
                    for a, b in zip(got.attributes, ref.attributes)))


def _mix(uv=False):
    """tests/test_parallel.py's device-entropy mix: four blobs of one
    topology, one of another, and a garbage blob."""
    blobs = [encode(_grid_mesh(8, s, uv)) for s in range(4)]
    blobs.append(encode(_grid_mesh(6, 9, uv)))
    blobs.append(b"garbage")
    return blobs


@pytest.mark.parametrize("uv", (False, True))
@pytest.mark.parametrize("entropy", ("host", "device"))
def test_shared_topology_decode_matches_decode_and_jax(entropy, uv):
    blobs = _mix(uv)
    bd = BatchDecoder()
    out = bd.decode_blobs_shared_topology(blobs, entropy=entropy,
                                          device="cpu")
    want_jax = JaxBatchDecoder().decode_blobs_shared_topology(
        blobs, entropy=entropy)
    assert out[-1] is None and want_jax[-1] is None
    for blob, got, j in zip(blobs[:-1], out[:-1], want_jax[:-1]):
        ref = decode(blob)
        assert _same_mesh(got, ref) and _same_mesh(got, j)
    assert bd.n_host_blobs == 2       # the other topology and the garbage
    if entropy == "device":  # no slot-table stage any more
        assert set(bd.timings) == {"collect_s", "lanes_s", "device_stage_s",
                                   "assemble_s"}


def test_device_stage_error_raises(monkeypatch):
    """No batch falls back to the host when the device stage fails."""
    def boom(streams, device, timings):
        raise RuntimeError("device decode broke")
    monkeypatch.setattr(tdb, "_device_decode_streams", boom)
    bd = BatchDecoder()
    with pytest.raises(RuntimeError, match="device decode broke"):
        bd.decode_blobs_shared_topology(_mix(), entropy="device",
                                        device="cpu")


def test_host_routing_is_per_blob_and_counted():
    """A LengthCoded blob of the group cannot become lanes, and a batch
    whose first blob is garbage has no group: those blobs take the host
    decoder, one by one, and are counted."""
    meshes = [_grid_mesh(7, s) for s in range(3)]
    blobs = [encode(m) for m in meshes]
    blobs[1] = encode(meshes[1], cfg=Config(symbol_coding="length"))
    bd = BatchDecoder()
    out = bd.decode_blobs_shared_topology(blobs, entropy="device",
                                          device="cpu")
    assert bd.n_host_blobs == 1
    assert all(_same_mesh(g, decode(b)) for g, b in zip(out, blobs))
    bd = BatchDecoder()
    out = bd.decode_blobs_shared_topology([b"junk"] + blobs,
                                          entropy="device", device="cpu")
    assert out[0] is None and bd.n_host_blobs == 4
    assert all(_same_mesh(g, decode(b)) for g, b in zip(out[1:], blobs))
    assert bd.decode_blobs_shared_topology([]) == []


def test_unknown_entropy_mode_raises():
    with pytest.raises(ValueError, match="entropy"):
        BatchDecoder().decode_blobs_shared_topology(_mix()[:2], entropy="gpu")


def test_lane_calls_split_by_slot_budget(monkeypatch):
    """A working-set budget of two lanes (streams, tables, output: there
    are no slot tables) splits the lanes into calls of at most two; the
    symbols do not change."""
    blobs = _mix()[:4]
    whole = BatchDecoder().decode_blobs_shared_topology(
        blobs, entropy="device", device="cpu")
    calls = []
    real = tdb.rans_decode_lanes

    def counted(buffers, *a, **k):
        calls.append(buffers.shape[0])
        return real(buffers, *a, **k)
    monkeypatch.setattr(tdb, "rans_decode_lanes", counted)
    assert not hasattr(tdb, "SLOT_BUDGET_BYTES")
    monkeypatch.setattr(tdb, "LANE_BUDGET_BYTES", 100_000)
    split = BatchDecoder().decode_blobs_shared_topology(
        blobs, entropy="device", device="cpu")
    assert len(calls) > 1 and max(calls) <= 2 and sum(calls) == 4
    assert all(_same_mesh(a, b) for a, b in zip(split, whole))


def test_stream_lane_slice_runs_without_jax():
    """The slice as a whole in a process that cannot import jax: the
    port's batch encoder makes the blobs, the port's device-entropy
    decoder decodes them; the meshes equal tpudraco's host decoder."""
    code = _BLOCK_JAX + f"""
import json
sys.path.insert(0, {ROOT!r})
import torchdraco
from torchdraco.parallel import BatchDecoder, BatchEncoder
pos, faces = torchdraco.make_mesh_batch(5, 9, 4)
meshes = torchdraco.build_meshes(pos, faces)
blobs = BatchEncoder().encode_meshes_device(meshes, device="cpu")
bd = BatchDecoder()
out = bd.decode_blobs_shared_topology(blobs, entropy="device", device="cpu")
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "tpudraco")]
print(json.dumps({{"blobs": [b.hex() for b in blobs],
                  "faces": [m.faces.tolist() for m in out],
                  "values": [m.attributes[0].values.tolist() for m in out],
                  "n_host_blobs": bd.n_host_blobs}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    pos, faces = torchdraco.make_mesh_batch(5, 9, 4)
    meshes = torchdraco.build_meshes(pos, faces)
    assert [bytes.fromhex(h) for h in got["blobs"]] == [encode(m)
                                                        for m in meshes]
    assert got["n_host_blobs"] == 0
    for k, m in enumerate(meshes):
        ref = decode(encode(m))
        assert np.array_equal(np.asarray(got["faces"][k]), ref.faces)
        assert np.array_equal(np.asarray(got["values"][k], np.float32),
                              np.asarray(ref.attributes[0].values))


def test_device_decode_builds_no_slot_table(monkeypatch):
    """The device stage hands D1 the streams, the frequency tables and the
    counts: nothing of 2^P entries is built, and D1 takes neither
    ``slots`` nor ``cums``."""
    import inspect

    assert not {"slots", "cums"} & set(inspect.signature(
        tdb.rans_decode_lanes).parameters)
    seen = []
    real = tdb.rans_decode_lanes

    def spy(buffers, nbytes, freqs, counts, precision):
        seen.append((precision, freqs.shape[-1]))
        return real(buffers, nbytes, freqs, counts, precision=precision)
    monkeypatch.setattr(tdb, "rans_decode_lanes", spy)
    blobs = _mix()[:4]
    out = BatchDecoder().decode_blobs_shared_topology(
        blobs, entropy="device", device="cpu")
    assert all(_same_mesh(g, decode(b)) for g, b in zip(out, blobs))
    assert seen and all(width < 1 << prec for prec, width in seen)
