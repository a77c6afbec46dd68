"""``BatchEncoder.encode_meshes_auto``, the router, over a request of
several takes, each of its own topology and size, from the arrays a
capture pipeline holds: the program's mesh building
(``torchdraco.build_meshes``) a take, then one router call over every
frame of the request, which groups the meshes by topology and sends each
group to the host plane or the device plane (the group path: K1-K3, C1,
C3), probing both on a take's first frames and keeping the decision. No
decision is kept on disk (``route_cache_path=None``): each run decides
afresh.

The request's builds run under one ``build_meshes`` root, which each
take's own ``build_meshes`` root nests in: ``core/program_spans.py`` pairs
one such root a request with the request's span to find the clock of the
program's spans. A nested root's own time counts as its own in
``idle.unexplained``, where a root's counts as unexplained: on this cell
that reader leaves out the takes' builds' and the device-plane calls'
own time."""

from __future__ import annotations

import time

import numpy as np

from . import encode_group


class Entry(encode_group.Entry):
    def prepare(self, takes) -> list:
        return [encode_group.Frames(faces, *(np.stack([f[k] for f in frames])
                                             for k in range(3)))
                for faces, frames in takes]

    def meshes(self, request: list) -> list:
        """The program's meshes of every take of ``request``, in take and
        frame order, timed into ``build_s``."""
        from torchdraco import build_meshes, trace

        t = time.perf_counter()
        out = []
        with trace.root("build_meshes", takes=len(request)):
            for take in request:
                out += build_meshes(take.positions, take.faces,
                                    take.normals, take.uvs)
        self.build_s = time.perf_counter() - t
        return out

    def run(self, request: list) -> list:
        return self.encoder.encode_meshes_auto(self.meshes(request))
