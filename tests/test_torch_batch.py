"""torchdraco's batched position encoder, end to end on the CPU: its .drc
bytes against tpudraco.encode.encode and against tpudraco's own device
batch encoder, in process and in a process where JAX cannot be imported."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.device import resolve  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import AttributeType  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a finder that refuses jax, as on a machine where it is not installed
_BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""

_RUN_SLICE = """
import json, sys
sys.path.insert(0, {root!r})
import torchdraco
from torchdraco.parallel import BatchEncoder
pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
meshes = torchdraco.build_meshes(pos, faces)
blobs = BatchEncoder().encode_meshes_device(meshes, bits=11, device="cpu")
"""


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
    assert tbatch.BatchEncoder(cfg=cfg).encode_meshes_device(
        meshes, device="cpu") == got


def test_slice_runs_without_jax():
    """The port's slice in a process that cannot import jax: the bridge
    loads only tpudraco's numpy host modules, and the bytes are the
    host encoder's."""
    code = _BLOCK_JAX + _RUN_SLICE.format(root=ROOT) + """
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print(json.dumps([b.hex() for b in blobs]))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    blobs = [bytes.fromhex(h) for h in json.loads(
        proc.stdout.strip().splitlines()[-1])]
    pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
    meshes = torchdraco.build_meshes(pos, faces)
    assert blobs == [encode(m) for m in meshes]


def test_port_initializes_no_jax_backend():
    """With jax installed, a full port encode imports it (through the host
    codec's tpudraco.ops) but never starts a backend, which on a GPU
    machine would take most of the card's memory."""
    code = _RUN_SLICE.format(root=ROOT) + """
from jax._src import xla_bridge
assert "tpudraco.ops.pallas_kernels" in sys.modules  # no stub: real ops
print(json.dumps(sorted(xla_bridge._backends)))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_mesh_batch_and_entry_match_graft_entry():
    import __graft_entry__ as ge

    for args in ((3, 5, 0), (2, 9, 4)):
        a, fa = torchdraco.make_mesh_batch(*args)
        b, fb = ge._make_mesh_batch(*args)
        assert np.array_equal(a, b) and np.array_equal(fa, fb)
    fn, args = torchdraco.entry()
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
    for cfg in (None, Config(quant_bits={AttributeType.POSITION: 14}),
                Config(quant_bits={AttributeType.NORMAL: 3}),
                Config(symbol_coding="length")):
        assert (tbatch._device_quant_bits(cfg)
                == jbatch._device_quant_bits(cfg))
    assert (tbatch._merged_quant_cfg(None, 13, 8, 10)
            == jbatch._merged_quant_cfg(None, 13, 8, 10))


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
    assert resolve(None) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve("cuda")
    with pytest.raises(ValueError):
        resolve("meta")
