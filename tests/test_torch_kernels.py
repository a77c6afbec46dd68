"""torchdraco's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and skips without one; on a machine
with a card run them with ``python -m pytest -m cuda
tests/test_torch_kernels.py``. Equality is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import torchdraco
from torchdraco import _host
from torchdraco.ops import device as tdev
from torchdraco.ops import rans_lanes as trl
from torchdraco.parallel import batch as tbatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _step_inputs(n, bits, batch, dev, seed=0):
    positions, faces = torchdraco.make_mesh_batch(batch, n, seed)
    mesh0 = torchdraco.build_meshes(positions[:1], faces)[0]
    topo = tbatch.PreparedTopology(mesh0)
    g_np = tbatch.topology_gathers_np(topo, mesh0.position_attribute())
    q, _, _ = tbatch.quantize_positions_host(positions, bits)
    q_up = q.astype(np.uint16) if bits <= 16 else q
    return (torch.from_numpy(q_up).to(dev), tbatch.gathers_to_torch(g_np, dev),
            torch.from_numpy(q.min(axis=(1, 2))).to(dev),
            torch.from_numpy(q.max(axis=(1, 2))).to(dev))


@pytest.mark.parametrize("bits", (11, 16, 20))
def test_predict_residual_kernel_matches_twin(cuda, bits):
    q, g, vmin, vmax = _step_inputs(24, bits, 16, cuda, seed=bits)
    n0 = tdev.predict_residual.n_launches
    got = tdev.predict_residual(q, g, vmin, vmax)
    torch.cuda.synchronize()
    assert tdev.predict_residual.n_launches == n0 + 1
    assert torch.equal(got, tdev.predict_residual_ref(q, g, vmin, vmax))


@pytest.mark.parametrize("bits", (11, 16))
def test_histogram_kernel_matches_twin(cuda, bits):
    bins = tdev.default_hist_bins(bits)
    assert (bins <= tdev.HIST_SMEM_MAX_BINS) == (bits == 11)
    rng = np.random.default_rng(bits)
    sym = torch.from_numpy(rng.integers(-9, bins + 9, size=(33, 5000),
                                        dtype=np.int32)).to(cuda)
    got = tdev.histogram(sym, bins)
    torch.cuda.synchronize()
    assert torch.equal(got, tdev.bincount_kernel(sym, bins))
    drop = torch.tensor([[-3, 0, 0, 5, bins + 7, bins - 1, -1, bins]],
                        dtype=torch.int32, device=cuda)
    assert tdev.histogram(drop, bins).sum().item() == 4


def test_rans_words_kernel_matches_twin(cuda):
    rng = np.random.default_rng(7)
    L, n = 64, 700
    syms = (rng.integers(0, 40, size=(L, n)) ** 2 % 1500).astype(np.int32)
    syms[3] = rng.integers(0, 1 << 12, size=n)
    prec = (12 + np.arange(L) % 9).astype(np.int32)
    counts = np.stack([np.bincount(r, minlength=1 << 12) for r in syms])
    dist, _ = _host.normalize_freq_counts_batch(counts, prec)
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    lengths = rng.integers(0, n + 1, size=L).astype(np.int32)
    lengths[0] = n
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda)
            for a in (syms, dist, cums, prec, lengths)]
    words, meta = trl.rans_words_scan(*args)
    torch.cuda.synchronize()
    ref_w, ref_m = trl.rans_words_scan_ref(*args)
    assert torch.equal(meta, ref_m)
    assert torch.equal(words, ref_w)


def test_slice_on_cuda_matches_host(cuda):
    pos, faces = torchdraco.make_mesh_batch(20, 12, seed=5)
    meshes = torchdraco.build_meshes(pos, faces)
    blobs = tbatch.BatchEncoder().encode_meshes_device(meshes, device=cuda)
    assert blobs == [_host.encode(m) for m in meshes]
