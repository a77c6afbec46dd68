"""torchdraco's narrow upload layouts on the CPU: uint8 at up to 8 bits and
the 12-bit pack at up to 12 (``parallel/batch.py`` ``upload_layout``),
through K1's twin, ``device_encode_group``, the NORMAL and TEX_COORD
chains' entries, the resident single-mesh route and a shard axis, against
tpudraco's packed uploads (``_jit_step_gather_p12``, its
``device_encode_group`` and ``BatchEncoder`` under ``PACKED_UPLOAD``, on
the virtual CPU devices of tests/conftest.py), against the port's own
uint16 twin (``PACKED_UPLOAD`` off) and against ``encode()``. Inputs are
made from seeds with numpy; every comparison is equality."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco import native as tnative  # noqa: E402
from torchdraco.device import shard_bounds  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402
from torchdraco.models import AttributeType as PortAttributeType  # noqa: E402
from torchdraco.ops import device as tdev  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco import native as jnative  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import AttributeType  # noqa: E402
from tpudraco.ops import unpack12_kernel as j_unpack12  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(monkeypatch, on: bool) -> None:
    """Both packages' knob, set alike."""
    monkeypatch.setattr(tbatch, "PACKED_UPLOAD", on)
    monkeypatch.setattr(jbatch, "PACKED_UPLOAD", on)


def _textured(batch, n, seed):
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


def _cfg(qp, qt):
    return (Config(quant_bits={AttributeType.POSITION: qp,
                               AttributeType.TEX_COORD: qt}),
            PortConfig(quant_bits={PortAttributeType.POSITION: qp,
                                   PortAttributeType.TEX_COORD: qt}))


# ------------------------------------------------------------ the layouts

def test_upload_layout_rule(monkeypatch):
    _packed(monkeypatch, True)
    assert [tbatch.upload_layout(b) for b in (1, 8, 9, 12, 13, 16, 17, 20)] \
        == ["u8", "u8", "pack12", "pack12", "u16", "u16", "i32", "i32"]
    _packed(monkeypatch, False)
    assert [tbatch.upload_layout(b) for b in (8, 12, 16, 17)] == [
        "u16", "u16", "u16", "i32"]


@pytest.mark.parametrize("value,want", (("0", False), ("1", True),
                                        (None, True)))
def test_packed_upload_reads_its_environment_variable(value, want):
    env = {k: v for k, v in os.environ.items()
           if k != "TORCHDRACO_PACKED_UPLOAD"}
    if value is not None:
        env["TORCHDRACO_PACKED_UPLOAD"] = value
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); "
         "from torchdraco.parallel import batch; "
         "print(batch.PACKED_UPLOAD, batch.upload_layout(11))"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(want), "pack12" if want else "u16"]


@pytest.mark.parametrize("shape,bits", [((4, 100, 3), 11), ((3, 7, 3), 12),
                                        ((2, 5, 1), 9), ((1, 3, 3), 11),
                                        ((5, 33), 12), ((3, 1, 1), 12)])
def test_pack12_round_trip_and_twin(shape, bits):
    """``native.pack12`` then ``unpack12_kernel`` gives the values back
    for even and odd row lengths; the numpy twin's bytes equal the C++
    ones and tpudraco's, and tpudraco's unpack reads the port's pack."""
    q = np.random.default_rng(bits * 7 + shape[-1]).integers(
        0, 1 << bits, size=shape).astype(np.uint16)
    lo, hb = tnative.pack12(q)
    B, n = shape[0], q[0].size
    assert lo.shape == q.shape and hb.shape == (B, (n + 1) // 2)
    assert lo.nbytes + hb.nbytes == q.size + B * ((n + 1) // 2)
    out = tdev.unpack12_kernel(torch.from_numpy(lo), torch.from_numpy(hb))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), q)
    assert np.array_equal(np.asarray(j_unpack12(jnp.asarray(lo),
                                                jnp.asarray(hb))), q)
    jlo, jhb = jnative.pack12(q)
    assert np.array_equal(lo, jlo) and np.array_equal(hb, jhb)
    orig = tnative.load_library
    tnative.load_library = lambda: None
    try:
        lo2, hb2 = tnative.pack12(q)
    finally:
        tnative.load_library = orig
    assert np.array_equal(lo, lo2) and np.array_equal(hb, hb2)


def test_unpack12_of_empty_shards():
    """A shard of no meshes (``shard_bounds`` allows them) unpacks to an
    empty (0, V, C) tensor."""
    lo = torch.zeros((0, 7, 3), dtype=torch.uint8)
    hb = torch.zeros((0, 11), dtype=torch.uint8)
    assert tdev.unpack12_kernel(lo, hb).shape == (0, 7, 3)
    assert tdev.widen((lo, hb)).shape == (0, 7, 3)


# --------------------------------------------------------- K1 on a layout

def _step_case(n, batch, bits, seed):
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    mesh0 = torchdraco.build_meshes(pos[:1], faces)[0]
    topo = tbatch.PreparedTopology(mesh0)
    g_np = tbatch.topology_gathers_np(topo, mesh0.position_attribute())
    q, _, _ = tbatch.quantize_positions_host(pos, bits)
    return q.astype(np.uint16), g_np


@pytest.mark.parametrize("bits,layout", [(8, "u8"), (11, "pack12"),
                                         (12, "pack12"), (15, "u16")])
def test_k1_twin_on_each_layout_equals_tpudraco(monkeypatch, bits, layout):
    """An odd V * C (7 x 7 grids: 147 values a mesh) at B = 3: K1's twin
    and the fused step on the upload as ``_upload`` makes it equal
    tpudraco's step on its packed upload (``_jit_step_gather_p12`` for the
    pack, ``_jit_step_gather_q`` for uint8 and uint16), symbols and
    counts."""
    _packed(monkeypatch, True)
    q, g_np = _step_case(7, 3, bits, seed=bits)
    assert tbatch.upload_layout(bits) == layout
    (up,), nbytes = tbatch._upload(q, bits, [torch.device("cpu")])
    assert tdev.upload_layout_of(up) == layout
    assert nbytes == {"u8": 147, "pack12": 147 + 74, "u16": 294}[layout] * 3
    g = tbatch.gathers_to_torch(g_np, "cpu")
    vmin = torch.from_numpy(q.min(axis=(1, 2)).astype(np.int32))
    vmax = torch.from_numpy(q.max(axis=(1, 2)).astype(np.int32))
    sym = tdev.predict_residual(up, g, vmin, vmax)
    assert torch.equal(sym, tdev.predict_residual_ref(
        torch.from_numpy(q.astype(np.int32)), g, vmin, vmax))
    syms, counts = tdev.encode_step_from_q_cuda(up, g, vmin, vmax, bits=bits)
    assert torch.equal(syms, sym)
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    if layout == "pack12":
        lo, hb = tnative.pack12(q)
        js, jc = jbatch._jit_step_gather_p12(jnp.asarray(lo),
                                             jnp.asarray(hb), jg, bits)
    else:
        jq = q.astype(np.uint8) if layout == "u8" else q
        js, jc = jbatch._jit_step_gather_q(jnp.asarray(jq), jg, bits)
    assert np.array_equal(syms.numpy(), np.asarray(js).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(jc))


# ---------------------------------------------------- device_encode_group

@pytest.mark.parametrize("bits", (8, 11, 12, 13, 15))
def test_device_encode_group_layouts(monkeypatch, bits):
    """Five 6 x 6 meshes: the port's step on its narrow upload equals
    tpudraco's on its own (``PACKED_UPLOAD`` on in both) and the port's
    uint16 twin; the bytes sent are 0.5x the uint16 bytes at 8 bits and
    0.75x at 11 and 12, as tpudraco counts them."""
    pos, faces = torchdraco.make_mesh_batch(5, 6, seed=bits)
    m0 = torchdraco.build_meshes(pos[:1], faces)[0]
    att = m0.position_attribute()
    topo = tbatch.PreparedTopology(m0)
    _packed(monkeypatch, True)
    got = tbatch.device_encode_group(pos, topo, att, bits=bits, device="cpu")
    timings: dict = {}
    want = jbatch.device_encode_group(pos, jbatch.PreparedTopology(m0), att,
                                      bits=bits, return_device=True,
                                      _timings=timings)
    _packed(monkeypatch, False)
    u16 = tbatch.device_encode_group(pos, topo, att, bits=bits, device="cpu")
    layout = tdev.upload_layout_of(got["q_dev"][0])
    assert layout == {8: "u8", 11: "pack12", 12: "pack12"}.get(bits, "u16")
    assert tdev.upload_layout_of(u16["q_dev"][0]) == "u16"
    assert np.array_equal(got["symbols"][0].numpy(),
                          np.asarray(want["symbols"]).astype(np.int64))
    assert np.array_equal(got["counts"][0].numpy(), np.asarray(want["counts"]))
    for k in ("symbols", "counts"):
        assert torch.equal(got[k][0], u16[k][0])
    for k in ("vmin", "vmax", "mins", "delta_max", "q"):
        assert np.array_equal(got[k], u16[k])
        assert np.array_equal(got[k], want[k])
    assert torch.equal(tdev.widen(got["q_dev"][0]),
                       torch.from_numpy(got["q"].astype(np.int32)))
    share = {"u8": 0.5, "pack12": 0.75, "u16": 1.0}[layout]
    assert got["h2d_bytes"] == share * u16["h2d_bytes"] == share * pos.size * 2
    assert got["h2d_bytes"] / 1e6 == pytest.approx(timings["h2d_mb"],
                                                   rel=1e-12)


@pytest.mark.parametrize("n", (2, 3, 8))
def test_packed_shards_cut_on_rows(monkeypatch, n):
    """Five meshes of an odd row length (7 x 7 x 3 = 147 values) over n
    shards, empty ones at 8: lo and hb cut on their rows, and each
    shard's step and upload equal the unsharded run's rows."""
    _packed(monkeypatch, True)
    pos, faces = torchdraco.make_mesh_batch(5, 7, seed=n)
    m0 = torchdraco.build_meshes(pos[:1], faces)[0]
    topo = tbatch.PreparedTopology(m0)
    att = m0.position_attribute()
    whole = tbatch.device_encode_group(pos, topo, att, device="cpu")
    got = tbatch.device_encode_group(pos, topo, att, mesh_axis=["cpu"] * n)
    lo, hb = whole["q_dev"][0]
    assert hb.shape == (5, 74)
    for (a, b), (lo_i, hb_i), sym in zip(shard_bounds(5, n), got["q_dev"],
                                         got["symbols"]):
        assert torch.equal(lo_i, lo[a:b]) and torch.equal(hb_i, hb[a:b])
        assert torch.equal(sym, whole["symbols"][0][a:b])
    assert got["h2d_bytes"] == whole["h2d_bytes"] == 5 * (147 + 74)


# -------------------------------------------------------- the whole slice

@pytest.mark.parametrize("depths,knob", [((11, 12), True), ((11, 12), False),
                                         ((8, 10), True), ((12, 8), True)])
def test_packed_upload_byte_oracle(monkeypatch, depths, knob):
    """The counterpart of tests/test_parallel.py's test of the same name,
    with normals and UVs: the positions and the UVs cross in their
    layouts (or as uint16, knob off), and the blobs equal encode()'s and
    tpudraco's under the same knob, with no attribute sent to the
    host."""
    qp, qt = depths
    _packed(monkeypatch, knob)
    meshes = _textured(6, 5, qp + qt)
    cfg, port_cfg = _cfg(qp, qt)
    enc = tbatch.BatchEncoder(cfg=port_cfg)
    got = enc.encode_meshes_device(meshes, device="cpu")
    assert enc.n_host_attributes == 0
    assert got == [encode(m, cfg=cfg) for m in meshes]
    assert got == JaxBatchEncoder(strict_device=True, cfg=cfg) \
        .encode_meshes_device(meshes)
    # 75 values a mesh: 75 bytes, 75 + 38 packed, 150 as uint16
    mesh_bytes = {"u8": 75, "pack12": 113, "u16": 150}[
        tbatch.upload_layout(qp)]
    assert enc.timings["h2d_mb"] == pytest.approx(6 * mesh_bytes / 1e6,
                                                  rel=1e-12)


@pytest.mark.parametrize("qp", (8, 11))
def test_packed_upload_sharded_byte_oracle(monkeypatch, qp):
    """The counterpart of test_packed_upload_sharded_byte_oracle: 8
    textured meshes of 5 x 5 over an axis of 3 CPU shards (dividing
    neither the batch nor the traversal of 25 steps), the positions in
    their narrow layout, against encode() and tpudraco's sharded encoder
    on a 4-device data mesh."""
    _packed(monkeypatch, True)
    meshes = _textured(8, 5, qp)
    cfg, port_cfg = _cfg(qp, 10)
    got = tbatch.BatchEncoder(cfg=port_cfg, mesh_axis=["cpu"] * 3) \
        .encode_meshes_device(meshes)
    assert got == [encode(m, cfg=cfg) for m in meshes]
    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    assert got == JaxBatchEncoder(strict_device=True, cfg=cfg,
                                  mesh_axis=jmesh).encode_meshes_device(meshes)


@pytest.mark.parametrize("qp", (8, 11))
def test_resident_route_on_the_narrow_layouts(monkeypatch, qp):
    """``encode_mesh_device`` at B = 1 takes the layouts through
    ``device_encode_group``; the chains read the same upload, widened."""
    _packed(monkeypatch, True)
    mesh = _textured(1, 9, qp)[0]
    cfg, port_cfg = _cfg(qp, 10)
    enc = tbatch.BatchEncoder(cfg=port_cfg)
    seen = []
    real = tbatch._device_extra_attribute_entries

    def spy(*args, q_pos=None, **kw):
        seen.append(tdev.upload_layout_of(q_pos[0]))
        return real(*args, q_pos=q_pos, **kw)
    monkeypatch.setattr(tbatch, "_device_extra_attribute_entries", spy)
    assert enc.encode_mesh_device(mesh, device="cpu") == encode(mesh, cfg=cfg)
    assert enc.n_host_attributes == 0
    assert seen == [tbatch.upload_layout(qp)]


def test_chain_entries_upload_their_own(monkeypatch):
    """Without ``q_pos`` the entries quantize and upload the positions
    themselves, and the UVs always, each in its layout: the entries equal
    tpudraco's at -qp 8 / -qt 12 (u8 positions, packed UVs)."""
    _packed(monkeypatch, True)
    meshes = _textured(3, 6, 4)
    topo = tbatch.PreparedTopology(meshes[0])
    uploads = []
    real = tbatch._upload

    def spy(q, bits, axis):
        out = real(q, bits, axis)
        uploads.append((bits, tdev.upload_layout_of(out[0][0])))
        return out
    monkeypatch.setattr(tbatch, "_upload", spy)
    entries = tbatch._device_extra_attribute_entries(
        meshes, [0, 1, 2], topo, bits=8, uv_bits=12, device="cpu")
    assert uploads == [(8, "u8"), (12, "pack12")]
    want = jbatch._device_extra_attribute_entries(
        meshes, [0, 1, 2], jbatch.PreparedTopology(meshes[0]), bits=8,
        chunk=4, uv_bits=12)
    for k in range(3):
        assert sorted(entries[k]) == [1, 2]
        for ai in (1, 2):
            # tpudraco's payloads; the port's entries also carry their
            # portabilization (tests/test_torch_assembly_carry.py)
            e = entries[k][ai]
            assert {x: e[x] for x in want[k][ai]} == want[k][ai]
            assert "port_meta" in e


def test_dryrun_multichip_on_three_shards(monkeypatch, capsys):
    """The dry run's depth oracles name each layout and hold the
    packed-off twin (an odd axis: a 3 x 1 grid)."""
    _packed(monkeypatch, True)
    torchdraco.dryrun_multichip(3, device="cpu")
    out = capsys.readouterr().out
    assert "8 (u8), 11 (pack12), 15 (u16), 18 (i32)" in out
    assert "the packed-off twin equals them" in out
    assert tbatch.PACKED_UPLOAD is True
