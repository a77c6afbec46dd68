"""The NORMAL and TEX_COORD chains' entries carry their portabilization
into the assembly (``port_meta``, and the UVs' values ``port_values``),
which emits it instead of running ``portabilize`` again for each mesh.
On the CPU twins, held to tpudraco: the group path's and the resident
route's blobs equal tpudraco's ``encode()`` at every depth, each carried
entry holds the bytes and values tpudraco's ``portabilize`` gives, a
NORMAL named as a parent is portabilized by the assembly again, and the
chains' guards still send a zero normal and non-finite UVs to the host
encoder."""

import numpy as np
import pytest

pytest.importorskip("jax")  # tpudraco.ops imports it
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco import trace  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402
from torchdraco.models import (  # noqa: E402
    AttributeDomain, AttributeType, MeshBuilder)
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.encode.portabilization import (  # noqa: E402
    default_portabilization_for, portabilize)
from tpudraco.models import AttributeType as JaxAttributeType  # noqa: E402
from tpudraco.wire.byte_io import ByteWriter  # noqa: E402

# (-qn, -qt): -qt 20 takes the numpy quantize, past the C++ one's 16 bits
DEPTHS = [(7, 8), (8, 10), (12, 12), (16, 20)]
ROUTES = ["group", "resident"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(frames: int = 3, n: int = 9):
    pos, faces = torchdraco.make_mesh_batch(frames, n, seed=11)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed=12)
    return pos, faces, nrm, uvs


def _cfgs(qn: int, qt: int) -> tuple[Config, PortConfig]:
    """(tpudraco Config, port Config) at normal depth ``qn`` and UV depth
    ``qt``."""
    return (Config(quant_bits={JaxAttributeType.NORMAL: qn,
                               JaxAttributeType.TEX_COORD: qt}),
            PortConfig(quant_bits={AttributeType.NORMAL: qn,
                                   AttributeType.TEX_COORD: qt}))


def _encoded(meshes, cfg, route):
    """(blobs, the ``assembly`` spans' attributes, ``n_host_attributes``)
    of ``meshes`` through ``route`` on the CPU twins, traced; an error of
    the encoder raises."""
    enc = tbatch.BatchEncoder(cfg=cfg, device="cpu", route_cache_path=None)
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            if route == "group":
                blobs = enc.encode_meshes_device(meshes)
            else:
                blobs = [enc.encode_mesh_device(m) for m in meshes]
        notes = [s.attrs for s in trace.spans() if s.name == "assembly"]
    finally:
        trace.clear()
    return blobs, notes, enc.n_host_attributes


def _ports(notes) -> tuple[int, int]:
    return (sum(a["carried"] for a in notes),
            sum(a["ported"] for a in notes))


def _portabilized(att, cfg: Config):
    """(bytes, values) that tpudraco's ``portabilize`` gives ``att`` under
    the tpudraco ``cfg``."""
    w = ByteWriter()
    port_type, bits = default_portabilization_for(
        JaxAttributeType(int(att.att_type)), cfg.quant_bits)
    out = portabilize(att, port_type, bits, w)
    return bytes(w.getvalue()), out.values


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("qn,qt", DEPTHS)
def test_blobs_equal_encode_at_every_depth(route, qn, qt):
    pos, faces, nrm, uvs = _arrays()
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    cfg, port_cfg = _cfgs(qn, qt)
    blobs, notes, n_host = _encoded(meshes, port_cfg, route)
    assert blobs == [encode(m, cfg=cfg) for m in meshes]
    assert n_host == 0
    assert _ports(notes) == (2 * len(meshes), 0)


@pytest.mark.parametrize("qn,qt", DEPTHS)
def test_carried_entries_hold_what_portabilize_gives(qn, qt):
    pos, faces, nrm, uvs = _arrays(4)
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    cfg, _ = _cfgs(qn, qt)
    topo = tbatch.PreparedTopology(meshes[0])
    idxs = list(range(len(meshes)))
    entries = tbatch._device_extra_attribute_entries(
        meshes, idxs, topo, bits=11, normal_bits=qn, uv_bits=qt,
        device="cpu")
    assert sorted(entries) == idxs
    for k, i in enumerate(idxs):
        atts = meshes[i].attributes
        assert sorted(entries[k]) == [1, 2]
        for j, entry in entries[k].items():
            meta, values = _portabilized(atts[j], cfg)
            assert entry["port_meta"] == meta
            if atts[j].att_type == AttributeType.NORMAL:
                assert meta == bytes([qn]) and "port_values" not in entry
            else:
                assert len(meta) == 4 * 3 + 1
                np.testing.assert_array_equal(entry["port_values"], values)


def _with_child(parent_type: AttributeType):
    """Three meshes of one topology, POSITION, NORMAL and TEX_COORD as the
    chains take them, and a COLOR attribute that names the
    ``parent_type`` attribute as its parent."""
    pos, faces, nrm, uvs = _arrays()
    rng = np.random.RandomState(13)
    meshes = []
    for b in range(len(pos)):
        mb = MeshBuilder()
        mb.set_connectivity_attribute(faces)
        pid = mb.add_attribute(pos[b], AttributeType.POSITION,
                               AttributeDomain.POSITION)
        ids = {AttributeType.NORMAL: mb.add_attribute(
                   nrm[b], AttributeType.NORMAL, AttributeDomain.CORNER,
                   parents=[pid]),
               AttributeType.TEX_COORD: mb.add_attribute(
                   uvs[b], AttributeType.TEX_COORD, AttributeDomain.CORNER,
                   parents=[pid])}
        color = rng.rand(len(pos[b]), 3).astype(np.float32)
        mb.add_attribute(color, AttributeType.COLOR, AttributeDomain.CORNER,
                         parents=[ids[parent_type]])
        meshes.append(mb.build())
    return meshes


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("parent_type", [AttributeType.NORMAL,
                                         AttributeType.TEX_COORD])
def test_a_named_parent_reads_portabilized_values(monkeypatch, route,
                                                  parent_type):
    """A NORMAL entry carries no values, so a NORMAL named as a parent is
    portabilized by the assembly (``ported``); the UVs' entry carries
    theirs, which equal ``portabilize``'s. Either way the child reads the
    values tpudraco's ``portabilize`` gives, and the blobs equal tpudraco's
    ``encode()``."""
    from torchdraco.encode import attribute as tattr

    meshes = _with_child(parent_type)
    cfg, port_cfg = _cfgs(12, 12)
    seen = []
    real = tattr._encode_one

    def spy(att, att_data_id, parents, *args, **kwargs):
        if att.att_type == AttributeType.COLOR:
            seen.append([np.asarray(p.values).astype(np.int64)
                         for p in parents])
        return real(att, att_data_id, parents, *args, **kwargs)

    monkeypatch.setattr(tattr, "_encode_one", spy)
    blobs, notes, n_host = _encoded(meshes, port_cfg, route)
    got = list(seen)
    assert blobs == [encode(m, cfg=cfg) for m in meshes]
    assert n_host == 0
    n = len(meshes)
    assert _ports(notes) == ((n, n) if parent_type == AttributeType.NORMAL
                             else (2 * n, 0))
    assert len(got) == n
    for m, parents in zip(meshes, got):
        parent = next(a for a in m.attributes if a.att_type == parent_type)
        np.testing.assert_array_equal(parents[0],
                                      _portabilized(parent, cfg)[1])


@pytest.mark.parametrize("route", ROUTES)
def test_a_zero_normal_takes_the_host_path(route):
    pos, faces, nrm, uvs = _arrays(4)
    nrm[2, 5] = 0.0
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    cfg, port_cfg = _cfgs(8, 10)
    blobs, notes, n_host = _encoded(meshes, port_cfg, route)
    assert blobs == [encode(m, cfg=cfg) for m in meshes]
    assert n_host == 1
    assert _ports(notes) == (2 * len(meshes) - 1, 1)


@pytest.mark.parametrize("route", ROUTES)
def test_non_finite_uvs_raise_the_host_encoders_error(route):
    pos, faces, nrm, uvs = _arrays()
    uvs[1, 3, 0] = np.nan
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    cfg, port_cfg = _cfgs(8, 10)
    with pytest.raises(ValueError) as want:
        encode(meshes[1], cfg=cfg)
    with pytest.raises(ValueError) as got:
        _encoded(meshes, port_cfg, route)
    assert str(got.value) == str(want.value)
    assert "TEX_COORD contains non-finite values" in str(got.value)
