"""torchdraco's batched position encoder, end to end on the CPU: its .drc
bytes against tpudraco.encode.encode and against tpudraco's own device
batch encoder, in process, and in processes that show the port loads
nothing of JAX or of the tpudraco package."""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.device import resolve  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402
from torchdraco.models import AttributeType as PortAttributeType  # noqa: E402
from torchdraco.ops import rans_lanes as trl  # noqa: E402
from torchdraco.parallel import BatchDecoder  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import AttributeType  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402

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

# the slice on the CPU: a batch encode, a device-entropy group decode and
# the host codec's own encode() and decode(); then what got loaded
_RUN_SLICE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import torchdraco
from torchdraco.decode import decode
from torchdraco.encode import encode
from torchdraco.parallel import BatchDecoder, BatchEncoder
pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
meshes = torchdraco.build_meshes(pos, faces)
blobs = BatchEncoder().encode_meshes_device(meshes, bits=11, device="cpu")
assert blobs == [encode(m) for m in meshes]
bd = BatchDecoder()
out = bd.decode_blobs_shared_topology(blobs, entropy="device", device="cpu")
assert bd.n_host_blobs == 0
for b, m in zip(blobs, out):
    ref = decode(b)
    assert np.array_equal(m.faces, ref.faces)
    assert np.array_equal(m.attributes[0].values, ref.attributes[0].values)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tpudraco"))
print(json.dumps({{"foreign": foreign,
                  "blobs": [b.hex() for b in blobs]}}))
"""


def _run_slice(prefix=""):
    proc = subprocess.run(
        [sys.executable, "-c", prefix + _RUN_SLICE.format(root=ROOT)],
        capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _slice_meshes():
    """4 grids of 8 x 8 and one of 6 x 6: two topology groups."""
    pos8, faces8 = torchdraco.make_mesh_batch(4, 8, seed=2)
    pos6, faces6 = torchdraco.make_mesh_batch(1, 6, seed=3)
    m8 = torchdraco.build_meshes(pos8, faces8)
    m6 = torchdraco.build_meshes(pos6, faces6)
    return [m8[0], m8[1], m6[0], m8[2], m8[3]]


@pytest.mark.parametrize("bits", (11, 13))
def test_slice_bytes_match_encode_and_jax_batch(bits):
    meshes = _slice_meshes()
    cfg = None if bits == 11 else Config(quant_bits={AttributeType.POSITION:
                                                     bits})
    port_cfg = None if bits == 11 else PortConfig(
        quant_bits={PortAttributeType.POSITION: bits})
    enc = tbatch.BatchEncoder()
    got = enc.encode_meshes_device(meshes, bits=bits, entropy="device",
                                   device="cpu")
    assert len(enc._topo_cache) == 2
    want_jax = JaxBatchEncoder(strict_device=True).encode_meshes_device(
        meshes, bits=bits, entropy="device")
    for m, g, j in zip(meshes, got, want_jax):
        assert g == encode(m, cfg=cfg)
        assert g == j
    # the same depth set through the encoder's Config
    assert tbatch.BatchEncoder(cfg=port_cfg).encode_meshes_device(
        meshes, device="cpu") == got


def _slice_reference_blobs():
    pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
    return [encode(m) for m in torchdraco.build_meshes(pos, faces)]


def test_slice_runs_without_jax():
    """The port's slice in a process whose import system refuses jax and
    tpudraco: it runs on the port's own host codec, and the bytes are
    tpudraco's host encoder's."""
    got = _run_slice(_BLOCK_JAX)
    assert got["foreign"] == []
    assert [bytes.fromhex(h) for h in got["blobs"]] \
        == _slice_reference_blobs()


def test_port_loads_nothing_of_jax_or_tpudraco():
    """Where jax and tpudraco ARE installed, an encode and a decode
    through the port still load no module of either (so no JAX backend can
    start, which on a GPU machine would take most of the card's memory)."""
    got = _run_slice()
    assert got["foreign"] == []
    assert [bytes.fromhex(h) for h in got["blobs"]] \
        == _slice_reference_blobs()


def test_port_sources_import_neither_jax_nor_tpudraco():
    """No import line of the port or of chip_smoke.py names jax or
    tpudraco (docstrings may name a counterpart by path), and the bridge
    module is gone."""
    files = glob.glob(os.path.join(ROOT, "torchdraco", "**", "*.py"),
                      recursive=True)
    files += [os.path.join(ROOT, n) for n in ("chip_smoke.py", "chip_ab.py")]
    assert len(files) > 40
    pat = re.compile(
        r"^\s*(import|from)\s+\.*(jax|jaxlib|tpudraco)\b|"
        r"^\s*import\s+.*\b(jax|jaxlib|tpudraco)\b|"
        r"import_module\(\s*['\"](jax|tpudraco)", re.M)
    hits = []
    for path in files:
        with open(path) as f:
            text = f.read()
        hits += [(os.path.relpath(path, ROOT), m.group(0).strip())
                 for m in pat.finditer(text)]
    assert hits == []
    assert not os.path.exists(os.path.join(ROOT, "torchdraco", "_host.py"))


def test_mesh_batch_and_entry_match_graft_entry():
    import __graft_entry__ as ge

    for args in ((3, 5, 0), (2, 9, 4)):
        a, fa = torchdraco.make_mesh_batch(*args)
        b, fb = ge._make_mesh_batch(*args)
        assert np.array_equal(a, b) and np.array_equal(fa, fb)
    fn, args = torchdraco.entry(device="cpu")
    syms, counts = fn(*args)
    jfn, jargs = ge.entry()
    jsyms, jcounts = jfn(*jargs)
    assert np.array_equal(syms.numpy(), np.asarray(jsyms).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))


def test_host_helpers_match_tpudraco():
    pos, faces = torchdraco.make_mesh_batch(3, 7, seed=9)
    m0 = torchdraco.build_meshes(pos[:1], faces)[0]
    assert tbatch.topology_signature(m0) == jbatch.topology_signature(m0)
    t_topo, j_topo = tbatch.PreparedTopology(m0), jbatch.PreparedTopology(m0)
    assert t_topo.conn_bytes == j_topo.conn_bytes
    assert t_topo.sequences == j_topo.sequences
    gt = tbatch.topology_gathers_np(t_topo, m0.position_attribute())
    gj = jbatch.topology_gathers_np(j_topo, m0.position_attribute())
    assert gt.keys() == gj.keys()
    assert all(np.array_equal(gt[k], gj[k]) for k in gt)
    for bits in (8, 11, 20):
        for a, b in zip(tbatch.quantize_positions_host(pos, bits),
                        jbatch.quantize_positions_host(pos, bits)):
            assert np.array_equal(a, b)
    # each package takes its own Config (equal fields, its own classes)
    for kw in (None, {"quant_bits": {"POSITION": 14}},
               {"quant_bits": {"NORMAL": 3}}, {"symbol_coding": "length"}):
        cfgs = []
        for cls, types in ((PortConfig, PortAttributeType),
                           (Config, AttributeType)):
            if kw is None:
                cfgs.append(None)
            elif "quant_bits" in kw:
                cfgs.append(cls(quant_bits={
                    types[k]: v for k, v in kw["quant_bits"].items()}))
            else:
                cfgs.append(cls(**kw))
        assert (tbatch._device_quant_bits(cfgs[0])
                == jbatch._device_quant_bits(cfgs[1]))
    import dataclasses
    assert (dataclasses.asdict(tbatch._merged_quant_cfg(None, 13, 8, 10))
            == dataclasses.asdict(jbatch._merged_quant_cfg(None, 13, 8, 10)))


def test_gathers_to_torch_layout():
    pos, faces = torchdraco.make_mesh_batch(1, 6)
    m0 = torchdraco.build_meshes(pos, faces)[0]
    g_np = tbatch.topology_gathers_np(tbatch.PreparedTopology(m0),
                                      m0.position_attribute())
    g = tbatch.gathers_to_torch(g_np, "cpu")
    for k, v in g.items():
        want = torch.bool if k in ("can_para", "has_fallback") else \
            torch.int32
        assert v.dtype == want and np.array_equal(v.numpy(), g_np[k])
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    assert all(np.array_equal(np.asarray(jg[k]), g[k].numpy()) for k in g)


def test_attributes_beyond_position_raise():
    from tpudraco.models import AttributeDomain, MeshBuilder

    pos, faces = torchdraco.make_mesh_batch(1, 5)
    mb = MeshBuilder()
    mb.set_connectivity_attribute(faces)
    pid = mb.add_attribute(pos[0], AttributeType.POSITION,
                           AttributeDomain.POSITION)
    nrm = np.tile(np.float32([0, 0, 1]), (pos.shape[1], 1))
    mb.add_attribute(nrm, AttributeType.NORMAL, AttributeDomain.CORNER,
                     parents=[pid])
    with pytest.raises(NotImplementedError, match="item 6"):
        tbatch.BatchEncoder().encode_meshes_device([mb.build()],
                                                   device="cpu")
    with pytest.raises(ValueError):
        tbatch.BatchEncoder().encode_meshes_device([], entropy="host")


def test_resolve_never_drops_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve("cpu") == torch.device("cpu")
    for asked in (None, "cuda"):  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve(asked)
    with pytest.raises(ValueError):
        resolve("meta")


def _entry_point_calls():
    pos, faces = torchdraco.make_mesh_batch(2, 5, seed=11)
    meshes = torchdraco.build_meshes(pos, faces)
    topo = tbatch.PreparedTopology(meshes[0])
    att = meshes[0].position_attribute()
    g_np = tbatch.topology_gathers_np(topo, att)
    blobs = [encode(m) for m in meshes]
    streams = [np.arange(20) % 5, np.arange(9) % 3]
    return {
        "entry": lambda **kw: torchdraco.entry(**kw),
        "encode_meshes_device": lambda **kw: tbatch.BatchEncoder()
        .encode_meshes_device(meshes, **kw),
        "device_encode_group": lambda **kw: tbatch.device_encode_group(
            pos, topo, att, **kw),
        "gathers_to_torch": lambda **kw: tbatch.gathers_to_torch(
            g_np, kw.get("device")),
        "decode_blobs_shared_topology": lambda **kw: BatchDecoder()
        .decode_blobs_shared_topology(blobs, entropy="device", **kw),
        "encode_streams_device": lambda **kw: trl.encode_streams_device(
            streams, np.bincount(np.concatenate(streams)), **kw),
        "encode_direct_coded_streams_device": lambda **kw:
        trl.encode_direct_coded_streams_device(streams, **kw),
    }


@pytest.mark.parametrize("name", (
    "entry", "encode_meshes_device", "device_encode_group",
    "gathers_to_torch", "decode_blobs_shared_topology",
    "encode_streams_device", "encode_direct_coded_streams_device"))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Without ``device`` an entry point asks for the card and, where there
    is none, raises the error that names CUDA; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_point_calls()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert call(device="cpu") is not None
