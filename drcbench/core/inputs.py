"""The benchmark's inputs, made from ``--seed`` in numpy: the frames of a
tracked surface whose topology is a lattice with quad diagonals drawn from
the seed. The template's vertices sit off the lattice by a seeded jitter,
a smooth in-plane drift moves them from frame to frame, and a height field
of sinusoids, whose phases advance with the frame index, lifts them. Each
frame carries the default attribute set: POSITION, NORMAL (area-weighted
vertex normals) and TEX_COORD (a texture atlas of charts, each a warped,
rotated and shuffled patch, fixed over the take as a tracked capture's
atlas is). Every seed gives the same sizes and the same kind of surface;
the seed moves the diagonals, the jitter, the waves, the drift, the atlas
and the noise.

A run holds one or more takes, each with its own topology (``Takes``).
Take 0 is the configuration's lattice on the run's seed. Take ``t >= 1``
is take 0 of a seed drawn from ``(seed, TAKE_STREAM, t)``, a stream that
no draw on the run's own seed opens, on the lattice
``takes[t % len(takes)]`` where the configuration lists ``takes``
(``[{"lattice": [rows, cols]}, ...]``), else on the configuration's."""

from __future__ import annotations

from functools import cached_property

import numpy as np

# the stream of the take seeds: _rng opens streams 0 to 5 on a run's seed
TAKE_STREAM = 0x74616B65


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def lattice(config: dict) -> tuple[int, int]:
    """(rows, columns) of the configuration's lattice."""
    rows, cols = config["lattice"]
    return int(rows), int(cols)


def lattice_faces(rows: int, cols: int, seed: int) -> np.ndarray:
    """(2 (rows-1) (cols-1), 3) int64 triangles of a rows x cols lattice
    (vertex r * cols + c at row r, column c), each quad split along the
    diagonal the seed picks, so that vertex valences run from 4 to 8 as in
    a scanned surface."""
    rng = _rng(seed, 0)
    i, j = np.meshgrid(np.arange(rows - 1), np.arange(cols - 1),
                       indexing="ij")
    a = (i * cols + j).ravel().astype(np.int64)
    b, c, d = a + 1, a + cols, a + cols + 1
    flip = rng.integers(0, 2, size=a.size).astype(bool)
    t0 = np.where(flip[:, None], np.stack([a, b, d], 1),
                  np.stack([a, b, c], 1))
    t1 = np.where(flip[:, None], np.stack([a, d, c], 1),
                  np.stack([b, d, c], 1))
    return np.stack([t0, t1], axis=1).reshape(-1, 3)


def _waves(waves: dict, seed: int, stream: int):
    """Amplitudes, wave vectors (kx, ky), phases and phase steps of a sum
    of sinusoids whose directions and phases come from the seed."""
    rng = _rng(seed, stream)
    n = len(waves["amplitudes"])
    angle = rng.uniform(0.0, 2.0 * np.pi, n)
    k = 2.0 * np.pi / np.asarray(waves["wavelengths"], dtype=np.float64)
    return (np.asarray(waves["amplitudes"], dtype=np.float64),
            k * np.cos(angle), k * np.sin(angle),
            rng.uniform(0.0, 2.0 * np.pi, n),
            np.asarray(waves["phase_steps"], dtype=np.float64))


def _wave_sum(waves, x, y, frame: int) -> np.ndarray:
    amp, kx, ky, phase, step = waves
    return np.sin(np.outer(x, kx) + np.outer(y, ky) + phase
                  + frame * step) @ amp


def template(config: dict, seed: int):
    """(x, y) float64 in-plane positions of the take's template: the
    lattice points moved by a seeded jitter of up to ``jitter`` of the
    spacing in each direction."""
    rows, cols = lattice(config)
    y, x = np.meshgrid(np.arange(rows, dtype=np.float64),
                       np.arange(cols, dtype=np.float64), indexing="ij")
    rng = _rng(seed, 3)
    j = float(config["sampling"]["jitter"])
    return (x.ravel() + j * rng.uniform(-1.0, 1.0, rows * cols),
            y.ravel() + j * rng.uniform(-1.0, 1.0, rows * cols))


def atlas_uvs(config: dict, seed: int, x, y) -> np.ndarray:
    """(V, 2) float64 UVs in [0, 1): the surface cut along the lattice
    into square patches of ``chart_size`` vertices a side; each patch's
    local coordinates are warped (a non-affine map of strength ``warp``),
    turned by a seeded quarter turn and placed, with a margin, in a seeded
    cell of a square atlas. A triangle that straddles two patches spans a
    seam."""
    rows, cols = lattice(config)
    uv = config["uv"]
    size = int(uv["chart_size"])
    w = float(uv["warp"])
    margin = float(uv["margin"])
    rng = _rng(seed, 4)
    nx, ny = -(-cols // size), -(-rows // size)
    gi, gj = np.indices((rows, cols))  # lattice row (y) and column (x)
    cx, cy = (gj // size).ravel(), (gi // size).ravel()
    chart = cy * nx + cx
    s = np.clip((x - cx * size + 0.5) / size, 0.0, 1.0)
    t = np.clip((y - cy * size + 0.5) / size, 0.0, 1.0)
    phase = rng.uniform(0.0, 2.0 * np.pi, (nx * ny, 2))
    s, t = (s + w * np.sin(np.pi * s) * np.sin(2 * np.pi * t
                                                 + phase[chart, 0]),
            t + w * np.sin(np.pi * t) * np.sin(2 * np.pi * s
                                                 + phase[chart, 1]))
    turn = rng.integers(0, 4, nx * ny)[chart]
    for _ in range(3):  # a quarter turn about the patch's centre, turn times
        m = turn > 0
        s, t = np.where(m, 1.0 - t, s), np.where(m, s, t)
        turn = turn - m
    n = int(np.ceil(np.sqrt(nx * ny)))  # atlas cells a side
    cell = rng.permutation(n * n)[chart]
    inner = 1.0 - 2.0 * margin
    u = ((cell % n) + margin + inner * s) / n
    v = ((cell // n) + margin + inner * t) / n
    return np.stack([u, v], axis=1)


def frame_attributes(config: dict, seed: int, frame: int,
                     faces: np.ndarray):
    """(positions (V, 3), normals (V, 3), uvs (V, 2)), float32, of frame
    ``frame`` of the configuration's take."""
    x0, y0 = template(config, seed)
    drift = _waves(config["drift"], seed, 5)
    x = x0 + _wave_sum(drift, x0, y0, frame)
    y = y0 + _wave_sum(drift, y0, x0, frame)
    surface = config["surface"]
    z = _wave_sum(_waves(surface, seed, 1), x, y, frame)
    z += float(surface["noise"]) * _rng(seed, 2, frame).standard_normal(
        x.size)
    pos = np.stack([x, y, z], axis=1)
    e1 = pos[faces[:, 1]] - pos[faces[:, 0]]
    e2 = pos[faces[:, 2]] - pos[faces[:, 0]]
    fn = np.cross(e1, e2)  # twice the area times the unit normal
    corners = faces.ravel()
    nrm = np.stack([np.bincount(corners, weights=np.repeat(fn[:, k], 3),
                                minlength=x.size) for k in range(3)], axis=1)
    norm = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(norm > 0, nrm / np.where(norm > 0, norm, 1.0),
                   np.array([0.0, 0.0, 1.0]))
    uvs = atlas_uvs(config, seed, x0, y0)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            uvs.astype(np.float32))


def raw_bytes(config: dict) -> int:
    """float32 bytes of one frame's attributes (3 + 3 + 2 values a
    vertex)."""
    rows, cols = lattice(config)
    return rows * cols * 8 * 4


def take_seed(seed: int, t: int) -> int:
    """The seed of take ``t``: the run's own for take 0, else a 64-bit
    draw of a SeedSequence over ``(seed, TAKE_STREAM, t)``."""
    if t == 0:
        return int(seed)
    ss = np.random.SeedSequence([int(seed), TAKE_STREAM, int(t)])
    return int(ss.generate_state(1, np.uint64)[0])


def take_config(config: dict, t: int) -> dict:
    """The configuration of take ``t``: the file's, with the lattice of
    ``takes[t % len(takes)]`` where it lists ``takes``."""
    takes = config.get("takes")
    if not takes:
        return config
    return dict(config, lattice=takes[t % len(takes)]["lattice"])


class Take:
    """Take ``t`` of a run on ``seed``: its configuration, seed, lattice,
    vertex and face counts, raw bytes a frame, and its faces (made at the
    first use)."""

    def __init__(self, config: dict, seed: int, t: int) -> None:
        self.config = take_config(config, t)
        self.seed = take_seed(seed, t)
        self.lattice = lattice(self.config)
        rows, cols = self.lattice
        self.vertices = rows * cols
        self.num_faces = 2 * (rows - 1) * (cols - 1)
        self.frame_bytes = raw_bytes(self.config)

    @cached_property
    def faces(self) -> np.ndarray:
        return lattice_faces(*self.lattice, self.seed)

    def frame(self, frame: int):
        """``frame_attributes`` of frame ``frame`` of the take."""
        return frame_attributes(self.config, self.seed, frame, self.faces)


class Takes:
    """The takes of a run, made once each: ``takes[t]``."""

    def __init__(self, config: dict, seed: int) -> None:
        self.config, self.seed = config, seed
        self._made: dict[int, Take] = {}

    def __getitem__(self, t: int) -> Take:
        if t not in self._made:
            self._made[t] = Take(self.config, self.seed, t)
        return self._made[t]
