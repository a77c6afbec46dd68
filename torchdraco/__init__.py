"""torchdraco — a Draco-bitstream mesh codec with its batch planes on
PyTorch and CUDA.

A port of tpudraco to one NVIDIA Hopper card, standing on its own: no
module here imports JAX or anything of the ``tpudraco`` package. The host
codec (``wire/``, ``models/``, ``entropy/``, ``encode/``, ``decode/``,
``shared/``, ``utils/``, ``native/``: numpy and C++) is the port's own copy
of tpudraco's, at the same relative paths and byte for byte the same
codec; the device work is hand-written CUDA kernels, each beside a plain
PyTorch twin:

  ops/device.py             K1 predict_residual, K2 histogram (fused step)
  ops/rans_lanes.py         K3 rans_words_scan, K4 rans_scan_dense (the
                            multi-lane rANS coder), D1 rans_decode_lanes
  ops/normals.py            the NORMAL chains: C1 normal_encode_cuda and
                            C2 normal_decode_cuda, behind
                            normal_encode_chain and normal_decode_chain
  ops/texcoords.py          the TEX_COORD chain: C3 uv_encode_cuda, behind
                            uv_encode_chain
  parallel/batch.py         BatchEncoder.encode_meshes_device, and for
                            one large mesh encode_mesh (host plane),
                            encode_mesh_device (resident),
                            encode_mesh_device_chunked (streaming)
  parallel/decode_batch.py  BatchDecoder.decode_blobs_shared_topology

(tpudraco's chains are XLA programs, no Pallas kernel of their own).

Several devices: a shard axis (``mesh_axis``, device.py ``resolve_axis``)
splits the batch path, the lane coder, the encode chains
(``*_sharded``) and one mesh's traversal
(``encode_mesh_device_stream_sharded``); parallel/multihost.py runs the
corpus over processes; ``dryrun_multichip`` holds all of it to the
unsharded results.
"""

from __future__ import annotations

import numpy as np


def make_mesh_batch(batch: int, n: int, seed: int = 0, fan: int = 0):
    """A batch of n x n grid meshes with shared topology: (positions
    (batch, V, 3) float32, faces (F, 3) int64), V = n*n. ``fan`` > 0 adds
    one vertex (V = n*n + 1) joined to the first fan + 1 vertices of the
    first row by ``fan`` triangles, as a CAD tessellation fans a cap: a
    vertex of valence ``fan`` (at most n - 1), which sets the width of the
    normal rings."""
    if not 0 <= fan < n:
        raise ValueError(f"fan must lie in [0, {n - 1}], got {fan}")
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    base = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n, np.float32)],
                    axis=1)
    positions = base[None] + rng.rand(batch, n * n, 3).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    if fan:
        apex = np.float32([fan / 2, -1, 0]) + rng.rand(batch, 1, 3).astype(
            np.float32)
        positions = np.concatenate([positions, apex], axis=1)
        faces += [[j + 1, j, n * n] for j in range(fan)]
    return positions, np.asarray(faces, dtype=np.int64)


def make_normal_uv_batch(positions: np.ndarray, n: int, seed: int = 0):
    """The other two attributes of the default set for ``positions`` (batch,
    n*n, 3): unit normals drawn from ``seed`` (batch, n*n, 3) float32, and
    UVs (batch, n*n, 2) float32, each position's x and y over n."""
    rng = np.random.RandomState(seed)
    nrm = rng.randn(*positions.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uvs = (positions[..., :2] / np.float32(n)).astype(np.float32)
    return nrm, uvs


def build_meshes(positions: np.ndarray, faces: np.ndarray,
                 normals: np.ndarray | None = None,
                 uvs: np.ndarray | None = None) -> list:
    """One Mesh per row of ``positions``: POSITION, and with ``normals`` /
    ``uvs`` (one row a mesh) a NORMAL / TEX_COORD attribute per corner,
    parented to the positions."""
    from .models import AttributeDomain, AttributeType, MeshBuilder

    meshes = []
    for b, p in enumerate(positions):
        mb = MeshBuilder()
        mb.set_connectivity_attribute(faces)
        pid = mb.add_attribute(p, AttributeType.POSITION,
                               AttributeDomain.POSITION)
        if normals is not None:
            mb.add_attribute(normals[b], AttributeType.NORMAL,
                             AttributeDomain.CORNER, parents=[pid])
        if uvs is not None:
            mb.add_attribute(uvs[b], AttributeType.TEX_COORD,
                             AttributeDomain.CORNER, parents=[pid])
        meshes.append(mb.build())
    return meshes


def entry(device=None):
    """Returns (fn, args): the fused encode step (K1 + K2) on a batch of 8
    grid meshes, 16 x 16 each, quantized at 11 bits on the host, with its
    tensors on ``device`` (None: the card; ``"cpu"`` for the plain twins).
    ``fn(q)`` returns (symbols (8, 256, 3) int32, counts (8, 4096) int32)."""
    import torch

    from .device import resolve
    from .ops import encode_step_from_q_cuda
    from .parallel.batch import (PreparedTopology, gathers_to_torch,
                                 quantize_positions_host,
                                 topology_gathers_np)

    dev = resolve(device)
    positions, faces = make_mesh_batch(batch=8, n=16)
    mesh0 = build_meshes(positions[:1], faces)[0]
    topo = PreparedTopology(mesh0)
    gathers = gathers_to_torch(
        topology_gathers_np(topo, mesh0.position_attribute()), dev)
    q, _, _ = quantize_positions_host(positions, 11)
    vmin = torch.from_numpy(q.min(axis=(1, 2))).to(dev)
    vmax = torch.from_numpy(q.max(axis=(1, 2))).to(dev)

    def fn(q_dev):
        return encode_step_from_q_cuda(q_dev, gathers, vmin, vmax, bits=11)

    return fn, (torch.from_numpy(q).to(dev),)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The several-device plane on a shard axis of ``n_devices``, the
    counterpart of ``__graft_entry__.dryrun_multichip``: n distinct cards
    where the machine has them, else ``resolve(device)`` n times (None:
    the card; ``"cpu"`` runs the plain twins). Raises RuntimeError where a
    result diverges; prints one line where none does. The oracles, in
    tpudraco's order:

    - the step on a dp x sp grid (dp = n / 2 for an even n above 1, else
      n; sp = n / dp): batches split over dp rows, the traversal of each
      over sp devices, the histograms summed over the stream axis, against
      the step on one device;
    - ``BatchEncoder(mesh_axis=)`` over all n devices against ``encode()``
      with both coders, then with normals and UVs through the sharded
      chains, then at ``-qp`` 8 (uint8 upload), 11 (the 12-bit pack), 15
      (uint16) and 18 (int32), and at 8 and 11 again with
      ``parallel.batch.PACKED_UPLOAD`` off (uint16), whose bytes must
      equal the narrow layouts';
    - ``encode_mesh_device_stream_sharded`` over all n against
      ``encode()``."""
    import torch

    from .device import resolve, shard_bounds
    from .encode import Config, encode
    from .models import AttributeType
    from .ops import encode_step_from_q_cuda, encode_step_stream_sharded
    from .parallel import batch as pbatch
    from .parallel.batch import (BatchEncoder, PreparedTopology,
                                 device_encode_group, upload_layout)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"dryrun_multichip: {what}")

    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices > 1:
        axis = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        axis = [dev] * n_devices
    dp = n_devices // 2 if n_devices % 2 == 0 and n_devices > 1 \
        else n_devices
    sp = n_devices // dp
    grid = [axis[r * sp:(r + 1) * sp] for r in range(dp)]

    batch = 2 * dp
    positions, faces = make_mesh_batch(batch=batch, n=8)
    meshes = build_meshes(positions, faces)
    topo = PreparedTopology(meshes[0])
    pos_att = meshes[0].position_attribute()
    ref = device_encode_group(positions, topo, pos_att, bits=11,
                              device=axis[0])
    q, vmin, vmax = ref["q"], ref["vmin"], ref["vmax"]
    gathers = topo.dev_gathers[str(axis[0])]
    syms, counts = [], []
    for r, (a, b) in enumerate(shard_bounds(batch, dp)):
        parts, cnt = encode_step_stream_sharded(
            q[a:b], gathers, vmin[a:b], vmax[a:b], bits=11,
            mesh_axis=grid[r])
        syms.append(torch.cat([p.to(axis[0]) for p in parts], dim=1))
        counts.append(cnt.to(axis[0]))
    want_s, want_c = encode_step_from_q_cuda(
        ref["q_dev"][0], gathers, torch.from_numpy(vmin).to(axis[0]),
        torch.from_numpy(vmax).to(axis[0]), bits=11)
    check(torch.equal(torch.cat(syms), want_s),
          "sharded symbols diverge from the single-device step")
    check(torch.equal(torch.cat(counts), want_c),
          "summed histograms diverge from the single-device step")

    few = meshes[:4]
    for entropy in ("host", "device"):
        got = BatchEncoder(mesh_axis=axis).encode_meshes_device(
            few, entropy=entropy)
        check(got == [encode(m) for m in few],
              f"sharded batch bytes (entropy={entropy!r}) diverge from "
              "encode()")
    nrm, uvs = make_normal_uv_batch(positions[:4], 8, seed=5)
    textured = build_meshes(positions[:4], faces, nrm, uvs)
    enc = BatchEncoder(mesh_axis=axis)
    got = enc.encode_meshes_device(textured)
    check(got == [encode(m) for m in textured] and enc.n_host_attributes == 0,
          "sharded NORMAL/UV chain bytes diverge from encode()")
    layouts, by_depth = {}, {}
    for depth in (8, 11, 15, 18):
        cfg = Config(quant_bits={AttributeType.POSITION: depth})
        layouts[depth] = upload_layout(depth)
        got = BatchEncoder(mesh_axis=axis, cfg=cfg).encode_meshes_device(few)
        check(got == [encode(m, cfg=cfg) for m in few],
              f"sharded {layouts[depth]} upload bytes at -qp {depth} "
              f"diverge from encode()")
        by_depth[depth] = got
    packed_was = pbatch.PACKED_UPLOAD
    try:
        pbatch.PACKED_UPLOAD = False
        for depth in (8, 11):
            cfg = Config(quant_bits={AttributeType.POSITION: depth})
            got = BatchEncoder(mesh_axis=axis,
                               cfg=cfg).encode_meshes_device(few)
            check(got == by_depth[depth], f"the packed-off twin diverges "
                  f"from the {layouts[depth]} upload at -qp {depth}")
    finally:
        pbatch.PACKED_UPLOAD = packed_was
    blob = BatchEncoder().encode_mesh_device_stream_sharded(meshes[0], axis)
    check(blob == encode(meshes[0]),
          "stream-sharded single-mesh bytes diverge from encode()")
    print(f"dryrun_multichip OK: {n_devices} shards on "
          f"{[str(d) for d in axis]}, grid {dp}x{sp}; step symbols "
          f"{tuple(want_s.shape)} and histograms {tuple(want_c.shape)} equal "
          f"the single-device step; {len(few)} meshes equal encode() with "
          f"both coders, {len(textured)} with normals and UVs, and at -qp "
          + ", ".join(f"{d} ({v})" for d, v in layouts.items())
          + "; the packed-off twin equals them at -qp 8 and 11; the "
          "stream-sharded mesh equals encode()")
