"""Builds and loads the port's CUDA kernels.

Every ``torchdraco/ops/csrc/*.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. The
library is built at first use into ``torchdraco/_build/<hash>/``, keyed by
a hash of the sources and the flags, so an edit rebuilds and an unchanged
tree reuses what is there. A missing ``nvcc`` or a failed compile raises:
there is no fallback to the plain versions, which would hide a broken
kernel behind a slow correct answer.

``-fmad=false`` keeps ``nvcc`` from contracting a float multiply and add
into an FMA; the integer kernels here do not care, but the float chains
that later kernels port (normals, UVs) are held bit-exact to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info: dict = {}  # seconds, path, ptxas report of the loaded library

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32

# entry point -> argtypes; every pointer (and the stream) is c_void_p
_SIGNATURES = {
    **{f"tdr_predict_residual_{layout}": [_P] * 10 + [_P, _I64, _I64, _I64,
                                                     _I32, _I32, _P]
       for layout in ("u8", "u16", "i32")},
    "tdr_predict_residual_p12": [_P] * 11 + [_P, _I64, _I64, _I64, _I32,
                                            _I32, _P],
    **{f"tdr_predict_tiled_{layout}": [_P] * 7 + [_I64, _I64, _I64, _I32,
                                                 _I32, _I32, _I32, _P]
       for layout in ("u8", "u16", "i32")},
    "tdr_predict_tiled_p12": [_P] * 8 + [_I64, _I64, _I64, _I32, _I32, _I32,
                                         _I32, _P],
    "tdr_histogram": [_P, _I64, _I64, _I32, _P, _I32, _I32, _P],
    "tdr_rans_words": [_P, _P, _P, _I64, _P, _P, _I64, _I64, _I64, _P, _P,
                       _P],
    "tdr_rans_dense": [_P, _P, _I32, _P, _I64, _I64, _I32, _P, _P, _P, _P,
                       _P],
    "tdr_rans_decode": [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _I64, _I32,
                        _I32, _I32, _P, _P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(_SRC, n) for n in os.listdir(_SRC)
                  if n.endswith((".cu", ".cuh")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the torchdraco CUDA kernels cannot be "
                           "built")
    return found


def load():
    """The ctypes library of every kernel, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    build_dir = os.path.join(_BUILD_ROOT, _source_hash())
    so_path = os.path.join(build_dir, "libtorchdraco_kernels.so")
    log_path = os.path.join(build_dir, "ptxas.log")
    t0 = time.perf_counter()
    if not os.path.isfile(so_path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        cu = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(build_dir, os.path.basename(p)
                             + f".{os.getpid()}.o") for p in cu]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, p],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for p, o in zip(cu, objs)]
        logs = [proc.communicate()[1] for proc in procs]  # wait for all
        for p, proc, err in zip(cu, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(p)} "
                                   f"({proc.returncode}):\n{err[-4000:]}")
        link = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-4000:]}")
        for o in objs:
            os.remove(o)
        with open(log_path, "w") as f:
            f.write("".join(logs))
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tdr_error_string.argtypes = [ctypes.c_int]
    lib.tdr_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=so_path)
    if os.path.isfile(log_path):
        with open(log_path) as f:
            build_info["ptxas"] = f.read()
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point (a launch
    the runtime refused never runs, and a later synchronize would not
    report it)."""
    if rc != 0:
        msg = _lib.tdr_error_string(rc).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
