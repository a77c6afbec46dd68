"""torchdraco's shared-topology batch decoder against tpudraco.decode.decode
and tpudraco's own BatchDecoder, the phased normal decode (the counterparts
of tests/test_phased_decode.py), and the stream-lane slice (port encode,
port device decode) in a process where neither JAX nor tpudraco can be
imported."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that a run of
    the whole suite in several worker processes is not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


def _normal_meshes(n, batch, seed=0):
    """Textured grids: per-corner normals and UVs, so real seams."""
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


def _assert_points_equal(got, ref):
    assert got is not None
    assert np.array_equal(got.faces, ref.faces)
    assert len(got.attributes) == len(ref.attributes)
    for ga, ra in zip(got.attributes, ref.attributes):
        assert np.array_equal(ga.values_per_point(), ra.values_per_point())


def _spy_on_fill(monkeypatch):
    """Counts the chains handed to the batched normal phase."""
    seen = []
    real = BatchDecoder._fill_deferred_normals

    def spy(conn, deferred, device):
        seen.append(len(deferred))
        return real(conn, deferred, device)
    monkeypatch.setattr(BatchDecoder, "_fill_deferred_normals",
                        staticmethod(spy))
    return seen


def test_phased_mixed_traversal_group(monkeypatch):
    """Blobs with different attribute-traversal bytes share the
    connectivity prefix but have DIFFERENT sequences: the phased groups
    key on the traversal, each sub-group decodes with its own rings and
    sequence, and both dialects equal per-blob decode() in one call."""
    mesh = _normal_meshes(9, 1, 1)[0]
    df = encode(mesh)
    pd = encode(mesh, cfg=Config(attribute_traversal="prediction-degree"))
    blobs = [df, pd, df, pd]
    assert df != pd
    ref = [decode(b) for b in blobs]
    batches = []
    real = tdb.normal_decode_chain

    def counted(q_pos, *a, **kw):
        batches.append(q_pos.shape[0])
        return real(q_pos, *a, **kw)
    monkeypatch.setattr(tdb, "normal_decode_chain", counted)
    for entropy in ("host", "device"):
        bd = BatchDecoder()
        got = bd.decode_blobs_shared_topology(
            blobs, entropy=entropy, normals="device", device="cpu")
        want_jax = JaxBatchDecoder().decode_blobs_shared_topology(
            blobs, entropy=entropy, normals="device")
        for g, r, j in zip(got, ref, want_jax):
            _assert_points_equal(g, r)
            _assert_points_equal(g, j)
        assert bd.n_host_blobs == 0
    assert batches == [2, 2, 2, 2]  # one batch a dialect, never one of 4


@pytest.mark.parametrize("entropy", ("host", "device"))
@pytest.mark.parametrize("mode", ("host", "device", "auto"))
def test_phased_normals_bit_exact(monkeypatch, mode, entropy):
    """Every mode equals per-blob decode() and tpudraco's BatchDecoder;
    "device" and, at 16 blobs and more, "auto" really take the batched
    phase."""
    seen = _spy_on_fill(monkeypatch)
    blobs = [encode(m) for m in _normal_meshes(9, 20)]
    ref = [decode(b) for b in blobs]
    bd = BatchDecoder()
    got = bd.decode_blobs_shared_topology(blobs, entropy=entropy,
                                          normals=mode, device="cpu")
    want_jax = JaxBatchDecoder().decode_blobs_shared_topology(
        blobs, entropy=entropy, normals=mode)
    for g, r, j in zip(got, ref, want_jax):
        _assert_points_equal(g, r)
        _assert_points_equal(g, j)
    assert bd.n_host_blobs == 0
    assert seen == ([] if mode == "host" else [20])
    assert ("normals_s" in bd.timings) == (mode != "host")


@pytest.mark.parametrize("qn", (7, 12, 16))
def test_phased_normals_with_device_entropy_and_depths(qn):
    meshes = _normal_meshes(9, 6, qn)
    cfg = Config(quant_bits={AttributeType.NORMAL: qn})
    blobs = [encode(m, cfg=cfg) for m in meshes]
    got = BatchDecoder().decode_blobs_shared_topology(
        blobs, entropy="device", normals="device", device="cpu")
    for g, b in zip(got, blobs):
        _assert_points_equal(g, decode(b))


@pytest.mark.parametrize("entropy", ("host", "device"))
def test_phased_decode_of_random_meshes(entropy):
    """The slice as a whole on meshes with holes and boundaries, random
    positions, normals of any length and random UVs: the port's batch
    encoder makes the blobs (encode()'s bytes), the phased decode gives
    decode()'s meshes back."""
    rng = np.random.RandomState(5)
    _, faces = torchdraco.make_mesh_batch(1, 8, 0)
    faces = faces[rng.rand(len(faces)) < 0.8]
    faces = faces[rng.permutation(len(faces))]
    meshes = torchdraco.build_meshes(
        (rng.randn(6, 64, 3) * 50).astype(np.float32), faces,
        rng.randn(6, 64, 3).astype(np.float32),
        rng.rand(6, 64, 2).astype(np.float32))
    from torchdraco.parallel import BatchEncoder
    enc = BatchEncoder()
    blobs = enc.encode_meshes_device(meshes, device="cpu")
    assert blobs == [encode(m) for m in meshes]
    assert enc.n_host_attributes == 0
    bd = BatchDecoder()
    got = bd.decode_blobs_shared_topology(blobs, entropy=entropy,
                                          normals="device", device="cpu")
    assert bd.n_host_blobs == 0 and "normals_s" in bd.timings
    for g, b in zip(got, blobs):
        _assert_points_equal(g, decode(b))


def test_phased_deep_position_depth():
    """-qp 18 on spread positions: ring sums pass 2^31 and the clamp
    reads the unwrapped sum, in the decoder's re-prediction too."""
    meshes = _normal_meshes(9, 4, 11)
    for m in meshes:
        m.attributes[0].values = (m.attributes[0].values
                                  * np.float32(1e4)).astype(np.float32)
    cfg = Config(quant_bits={AttributeType.POSITION: 18})
    blobs = [encode(m, cfg=cfg) for m in meshes]
    got = BatchDecoder().decode_blobs_shared_topology(
        blobs, normals="device", device="cpu")
    for g, b in zip(got, blobs):
        _assert_points_equal(g, decode(b))


def test_phased_ignores_normal_free_groups(monkeypatch):
    """Position-only groups pass through the phased gate untouched, and
    ask for no device."""
    seen = _spy_on_fill(monkeypatch)
    blobs = [encode(_grid_mesh(8, s)) for s in range(20)]
    bd = BatchDecoder()
    got = bd.decode_blobs_shared_topology(blobs, normals="device")
    for g, b in zip(got, blobs):
        _assert_points_equal(g, decode(b))
    assert seen == [] and "normals_s" not in bd.timings


@pytest.mark.parametrize("xf", (2, 4))
def test_phased_normals_opt_in_transforms_stay_host(monkeypatch, xf):
    """Opt-in transforms (OctReflection / Orthogonal) are not deferred:
    the host chains decode them, and the values stay equal."""
    seen = _spy_on_fill(monkeypatch)
    meshes = _normal_meshes(8, 18)
    cfg = Config(transform={AttributeType.NORMAL: xf})
    blobs = [encode(m, cfg=cfg) for m in meshes]
    got = BatchDecoder().decode_blobs_shared_topology(
        blobs, normals="device", device="cpu")
    for g, b in zip(got, blobs):
        _assert_points_equal(g, decode(b))
    assert seen == []


def test_phased_auto_is_the_two_thresholds(monkeypatch):
    """"auto" takes the batched phase at PHASED_NORMALS_MIN_BLOBS matching
    blobs, or for a lone mesh of PHASED_NORMALS_MIN_FACES faces, and asks
    nothing else: there is no link probe in the port."""
    import torchdraco.parallel.batch as tbatch_mod

    assert not hasattr(tbatch_mod, "_device_link_healthy")
    seen = _spy_on_fill(monkeypatch)
    bd = BatchDecoder()
    meshes = _normal_meshes(8, bd.PHASED_NORMALS_MIN_BLOBS)
    blobs = [encode(m) for m in meshes]
    for n, want in ((4, []), (bd.PHASED_NORMALS_MIN_BLOBS,
                              [bd.PHASED_NORMALS_MIN_BLOBS])):
        seen.clear()
        got = bd.decode_blobs_shared_topology(blobs[:n], normals="auto",
                                              device="cpu")
        for g, b in zip(got, blobs):
            _assert_points_equal(g, decode(b))
        assert seen == want
    seen.clear()
    monkeypatch.setattr(BatchDecoder, "PHASED_NORMALS_MIN_FACES", 64)
    got = bd.decode_blobs_shared_topology(blobs[:1], normals="auto",
                                          device="cpu")  # 98 faces
    assert seen == [1]
    _assert_points_equal(got[0], decode(blobs[0]))


def test_phased_device_failure_raises(monkeypatch):
    """A failure of the batched normal phase raises: the port refills no
    blob from the host. A blob whose own decode fails is still isolated,
    and a blob of another topology still goes to the host, counted."""
    blobs = [encode(m) for m in _normal_meshes(8, 5)]

    def boom(*a, **kw):
        raise RuntimeError("normal phase broke")
    monkeypatch.setattr(tdb, "normal_decode_chain", boom)
    for entropy in ("host", "device"):
        with pytest.raises(RuntimeError, match="normal phase broke"):
            BatchDecoder().decode_blobs_shared_topology(
                blobs, entropy=entropy, normals="device", device="cpu")
    monkeypatch.undo()
    other = encode(_normal_meshes(6, 1, 3)[0])
    cut = blobs[2][:-9]  # same topology, truncated attribute section
    bd = BatchDecoder()
    got = bd.decode_blobs_shared_topology(
        blobs[:2] + [cut, other] + blobs[3:], normals="device", device="cpu")
    assert got[2] is None and bd.n_host_blobs == 1
    for g, b in zip(got[:2] + got[3:], blobs[:2] + [other] + blobs[3:]):
        _assert_points_equal(g, decode(b))
    with pytest.raises(ValueError, match="normals"):
        BatchDecoder().decode_blobs_shared_topology(blobs, normals="card")


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
