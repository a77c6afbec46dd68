"""``BatchEncoder.encode_mesh_device``, the resident single-mesh route, a
request a frame, from the frame's arrays: the program's mesh building,
then K1 (tiled), K2 (split row), the chains at one mesh, one readback and
the host rANS coder and assembly."""

from __future__ import annotations

from . import encode_group


class Entry(encode_group.Entry):
    def run(self, request: encode_group.Frames) -> list:
        return [self.encoder.encode_mesh_device(m)
                for m in self.meshes(request)]
