"""The cells of one take read what they read before requests could span
takes: at the tiny size and two seeds, the SHA-256 of the faces and of
every frame's three attribute arrays that the harness hands the entry (in
the order it hands them, the warm request last), and of the reference's
blobs and stream stats, as the harness of one take per run gave them."""

import hashlib
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from drcbench.core import harness

PINNED = {
    ("dfaust.encode", 12345): {
        "faces": "ee52312293c4669e2e3d6e952fbaef4a2e7f01babdc71b6acd8eacd534345a36",
        "frames": "5f51c82a7743989a1305d967ac949d844870132e985b26a992559f31e0edb1f4",
        "blobs": "e747bd2a4375635c331a5db5c23612d90d613d536a304ce1e2049b49278800dd",
        "stats": "a537c9d60978e50dd20dd9102864e649791586ab849e3bcd5d5c3d2de9d2e832"},
    ("dfaust.encode", 2 ** 33 + 17): {
        "faces": "0998470d52191e02a1e19bf5f2df0e3485fb5b354c3ad3b3e22addf6b5d8bce8",
        "frames": "2752417fc56c1f9592656969512fa1555e3ed55725e60f9e74ed31aaed2f42f6",
        "blobs": "0ee3876725dcf2efd424f4208f0a99ea43ec0f1085ba520772033d4a916c70a3",
        "stats": "5d55f45f4654d41d531d8dd6f0d1c155b829495b40ca94670eb10c41e53eee01"},
    ("sim1m.encode", 12345): {
        "faces": "4dbe4d97d74d4c2ed82c1508e3cc7a0508228f3932115cbc6bc6d2404cf88b5d",
        "frames": "0fc52570f5d50c3ac5ed16e3fbdbd54a0cbdb794056b5bfcc5b5aaedd3770d21",
        "blobs": "41cde8ca3acd95db7a34c55f5879242a0c2027cf19628e76d0378a3a71849e9b",
        "stats": "d7108e1b9f1eff20eaad800c66b0e819533b6af80fa38e53826cf0e135ba2733"},
    ("sim1m.encode", 2 ** 33 + 17): {
        "faces": "01a0bdd29cdc3cb8e1f1e08edff71ec0de408d3811a36dc1f4ddd255663a0307",
        "frames": "c9ed7edcd198e467c12cff80ae7a23a77d0aacbcfee195c082e4dc22d55ed8a9",
        "blobs": "4fdb321f5744bc4a38d58458b2a81f6253a23c5572db8103ac7f009f5c079a46",
        "stats": "fab03f1a795c7c06957d7d3ae5235cbe1ddf5c4be473b1d4b9df18faac4ed063"},
}
STAT_KEYS = ("scheme", "xform", "symbols", "table_entries", "precision",
             "payload_bytes")


def _array(h, a) -> None:
    a = np.ascontiguousarray(a)
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())


def _digests(requests: list, blobs: list, stats: list) -> dict:
    faces, frames, b, s = (hashlib.sha256() for _ in range(4))
    for takes in requests:
        for f, attrs in takes:
            _array(faces, f)
            for frame in attrs:
                for a in frame:
                    _array(frames, a)
    for blob in blobs:
        b.update(len(blob).to_bytes(8, "little"))
        b.update(blob)
    s.update(json.dumps([[{k: int(st[k]) for k in STAT_KEYS} for st in fr]
                         for fr in stats]).encode())
    return {"faces": faces.hexdigest(), "frames": frames.hexdigest(),
            "blobs": b.hexdigest(), "stats": s.hexdigest()}


@pytest.mark.parametrize("cell,seed", sorted(PINNED))
def test_one_take_cells_read_what_they_read(tiny_root, monkeypatch, cell,
                                            seed):
    handed, reference = [], []

    class Keep:
        def __init__(self, entry):
            self.entry = entry

        def prepare(self, takes):
            handed.append(takes)
            return self.entry.prepare(takes)

        def run(self, request):
            return self.entry.run(request)

        def timings(self):
            return self.entry.timings()

    encode = harness.pool.encode

    def kept(*args, **kwargs):
        reference.append(encode(*args, **kwargs))
        return reference[-1]

    monkeypatch.setattr(harness.pool, "encode", kept)
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", "0.1", "--trace", "0"],
                          device="cpu", require_cuda=False, root=tiny_root,
                          workers=1, entry_wrapper=Keep, max_requests=1)
    assert rc == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] is True
    assert all(len(takes) == 1 for takes in handed)
    (blobs, stats), = reference
    assert _digests(handed, blobs, stats) == PINNED[(cell, seed)]
