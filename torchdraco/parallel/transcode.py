"""glTF transcoding of a corpus with the primitive encodes on the device:
the batched counterpart of the per-file DracoTranscoder.

Counterpart of ``tpudraco/parallel/transcode.py``. The driver collects
every primitive sub-mesh across the corpus (through the same
``iter_scene_primitives`` generator the writer encodes from, so the two
cannot drift), encodes the unique ones on the device plane grouped by
topology (``BatchEncoder``, with the NORMAL and TEX_COORD chains), and then
writes each GLB with the precomputed blobs injected through the writer's
encoder hook. Output files equal per-file DracoTranscoder runs byte for
byte; per-file error isolation, resume and collision detection follow
``encode_corpus``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np


def mesh_content_key(mesh) -> str:
    """Full content hash keying the precomputed blobs across the writer's
    re-split meshes. Covers every attribute field the wire depends on
    (type/domain/components/dtype/ids/parents/shapes, delimited): two
    meshes share a key iff encode() would emit identical bytes."""
    h = hashlib.sha256()
    h.update(repr(mesh.faces.shape).encode())
    h.update(np.ascontiguousarray(mesh.faces).tobytes())
    for a in mesh.attributes:
        h.update(repr((int(a.att_type), int(a.domain),
                       int(a.num_components), a.att_id, a.unique_id,
                       tuple(a.parents), a.values.dtype.str,
                       a.values.shape)).encode())
        h.update(np.ascontiguousarray(a.unique_indices()).tobytes())
        h.update(np.ascontiguousarray(a.values).tobytes())
    return h.hexdigest()


def transcode_corpus(inputs: list[str], out_dir: str,
                     use_device: bool = True, resume: bool = True,
                     khr_ids: str = "unique", cfg=None,
                     device=None, mesh_axis=None) -> dict:
    """Transcode glTF/GLB files into Draco-compressed GLBs in ``out_dir``,
    with the primitive encodes batched on ``device`` (None: the card;
    ``"cpu"`` runs the kernels' plain twins), or over the shard axis
    ``mesh_axis`` (``BatchEncoder``'s), across all files: topology
    groups span the corpus, and duplicate primitives encode once. ``cfg``
    is an optional encoder Config for every primitive (the reference's
    DracoTranscodingOptions.geometry). A quantization-only cfg (-qp/-qt/-qn,
    all else default) stays on the device plane; any other override takes
    the host encoder for every primitive. ``use_device=False`` is the host
    plane. A device failure raises; a primitive the host encoder refuses
    (non-finite values) stays out of the device plane, and the writer's
    own encode fails its file. The report (``transcode_report.json``)
    counts ``encoder_hook_misses``: primitives the writer had to encode
    itself."""
    from ..io.gltf import (iter_scene_primitives, load_gltf_to_scene,
                           save_scene_glb)
    from .batch import (BatchEncoder, _device_quant_bits,
                        _drop_output_collisions)

    if _device_quant_bits(cfg) is None:
        use_device = False  # beyond the device plane's config space
        cfg_for_batch = None
    else:
        cfg_for_batch = cfg  # depths resolve inside encode_meshes_device
    be = BatchEncoder(cfg=cfg_for_batch, use_device=use_device,
                      device=device, mesh_axis=mesh_axis)
    dev = be._dev(None) if use_device else None

    os.makedirs(out_dir, exist_ok=True)
    report = {"transcoded": 0, "skipped": 0, "failed": [],
              "total_in_bytes": 0, "total_out_bytes": 0}
    t0 = time.perf_counter()

    def out_path_for(path):
        return os.path.join(
            out_dir, os.path.splitext(os.path.basename(path))[0] + ".glb")

    # drop exact duplicate inputs, then output-name collisions
    deduped = list(dict.fromkeys(inputs))
    inputs, collided = _drop_output_collisions(deduped, out_path_for)
    for path in collided:
        report["failed"].append(
            {"path": path, "error": "output name collision"})

    # phase 1: load scenes, collect the unique primitive sub-meshes (the
    # enumeration the writer will encode)
    scenes: dict[str, object] = {}
    unique_subs: dict[str, object] = {}
    for path in inputs:
        if resume and os.path.isfile(out_path_for(path)):
            continue
        try:
            scene = load_gltf_to_scene(path)
            scenes[path] = scene
            for _gi, inst, _mat, sub in iter_scene_primitives(scene):
                if inst.morph_targets:
                    # the writer stores morph-target primitives
                    # uncompressed and never asks the encoder hook
                    continue
                unique_subs.setdefault(mesh_content_key(sub), sub)
        except Exception as e:
            report["failed"].append({"path": path, "error": repr(e)})

    # phase 2: the unique sub-meshes on the device plane, corpus-wide
    blob_map: dict[str, bytes] = {}
    if use_device and unique_subs:
        keys = list(unique_subs)
        blobs = be._device_plane([unique_subs[k] for k in keys], dev)
        for k, blob in zip(keys, blobs):
            if blob is not None:
                blob_map[k] = blob

    misses = 0

    def encoder(mesh):
        nonlocal misses
        blob = blob_map.get(mesh_content_key(mesh))
        if blob is None:
            misses += 1
        return blob

    # phase 3: write each scene with the precomputed blobs injected
    for path in inputs:
        out_path = out_path_for(path)
        if resume and os.path.isfile(out_path) and path not in scenes:
            report["skipped"] += 1
            continue
        if path not in scenes:
            continue  # already reported as failed
        try:
            tmp = out_path + f".tmp{os.getpid()}"
            save_scene_glb(scenes[path], tmp,
                           encoder=encoder if use_device else None,
                           khr_ids=khr_ids, cfg=cfg)
            os.replace(tmp, out_path)
            report["transcoded"] += 1
            report["total_in_bytes"] += os.path.getsize(path)
            report["total_out_bytes"] += os.path.getsize(out_path)
        except Exception as e:
            report["failed"].append({"path": path, "error": repr(e)})

    report["seconds"] = round(time.perf_counter() - t0, 3)
    if use_device:
        report["encoder_hook_misses"] = misses
    tmp_rep = os.path.join(out_dir, f"transcode_report.json.tmp{os.getpid()}")
    with open(tmp_rep, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp_rep, os.path.join(out_dir, "transcode_report.json"))
    return report
