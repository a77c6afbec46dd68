"""``BatchEncoder.encode_meshes_device`` over one group of frames that
share a topology, from the arrays a capture pipeline holds: the program's
mesh building (``torchdraco.build_meshes``), then the group path's
quantize, upload, K1, K2, K3, the NORMAL and TEX_COORD chains (C1, C3),
their host payloads and the assembly."""

from __future__ import annotations

import time

import numpy as np


def program_config(quantization: dict):
    from torchdraco.encode import Config
    from torchdraco.models import AttributeType

    types = {"position": AttributeType.POSITION,
             "normal": AttributeType.NORMAL,
             "tex_coord": AttributeType.TEX_COORD}
    return Config(quant_bits={types[k]: int(v)
                              for k, v in quantization.items()})


class Frames:
    """A request: its frames' attributes stacked, one row a frame, as the
    user hands them over, and the faces they share."""

    def __init__(self, faces, positions, normals, uvs) -> None:
        self.faces = faces
        self.positions, self.normals, self.uvs = positions, normals, uvs

    def __len__(self) -> int:
        return len(self.positions)

    def __getitem__(self, rows: slice) -> "Frames":
        return Frames(self.faces, self.positions[rows], self.normals[rows],
                      self.uvs[rows])


class Entry:
    def __init__(self, config: dict, traffic: dict, device: str) -> None:
        from torchdraco.parallel.batch import BatchEncoder

        self.encoder = BatchEncoder(
            cfg=program_config(config["quantization"]), device=device,
            route_cache_path=None)
        self.build_s = None

    def prepare(self, takes) -> Frames:
        if len(takes) != 1:
            raise ValueError(f"one take a request, not {len(takes)}")
        faces, frames = takes[0]
        return Frames(faces, *(np.stack([f[k] for f in frames])
                               for k in range(3)))

    def meshes(self, request: Frames) -> list:
        """The program's meshes of ``request``, timed into ``build_s``."""
        from torchdraco import build_meshes

        t = time.perf_counter()
        out = build_meshes(request.positions, request.faces,
                           request.normals, request.uvs)
        self.build_s = time.perf_counter() - t
        return out

    def run(self, request: Frames) -> list:
        return self.encoder.encode_meshes_device(self.meshes(request))

    def timings(self) -> dict:
        return dict(self.encoder.timings, build_s=self.build_s)
