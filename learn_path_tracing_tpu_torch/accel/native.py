"""ctypes binding for the native (C++) SAH BVH builder.

Counterpart of ``learn_path_tracing_tpu.accel.native``, with the port's own
copy of the source (``csrc/bvh_builder.cpp``). It gives the numpy builder's
arrays byte for byte (``accel/bvh.py``; ``tests/test_torch_native_bvh.py``)
in a fraction of its time.

The library is built at first use with ``g++`` into ``_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, as
``ops/build.py`` names the kernels, and loaded with ``ctypes``. Nothing
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "bvh_builder.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
# No -march=native (the JAX package's Makefile has it): the library in
# _build/ may be reused on another host, and the builder's float semantics
# must not depend on the CPU it was built on. -ffp-contract=off keeps the
# compiler from fusing multiply-adds, which numpy never does.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None
builds = 0  # native builds run by this process (build_bvh_native calls)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"bvh_builder_{digest.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded builder library, compiling it if needed. Raises
    ``RuntimeError`` if the compiler is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            cxx = shutil.which(CXX)
            if cxx is None:
                raise RuntimeError(f"native BVH builder: compiler {CXX!r} not found")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"native BVH builder: {CXX} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
        lib = ctypes.CDLL(str(so))
        f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.lpt_build_bvh.restype = ctypes.c_int
        lib.lpt_build_bvh.argtypes = [
            f32p, f32p, f32p,                 # plow, phigh, centroid
            ctypes.c_int64,                   # n
            ctypes.c_int32, ctypes.c_int32,   # max_depth, max_leaf
            i32p, i32p,                       # left, right
            f32p, f32p,                       # low, high
            i32p, i32p, i32p,                 # data, cut, prim
            ctypes.POINTER(ctypes.c_int64),   # counts
        ]
        _lib = lib
        return lib


def build_bvh_native(plow, phigh, centroid, max_depth: int, max_leaf: int):
    """Run the C++ builder; returns ``(left, right, low, high, data, cut,
    prim)`` as the numpy builder lays them out. Raises ``RuntimeError`` if
    the library cannot be built or the build fails."""
    global builds
    lib = load()
    plow = np.ascontiguousarray(plow, np.float32)
    phigh = np.ascontiguousarray(phigh, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    n = plow.shape[0]
    cap = 2 * n + 8
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    low = np.empty((cap, 3), np.float32)
    high = np.empty((cap, 3), np.float32)
    data = np.empty(cap, np.int32)
    cut = np.empty(n + 2, np.int32)
    prim = np.empty(n, np.int32)
    counts = np.zeros(2, np.int64)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    f, i = ctypes.c_float, ctypes.c_int32
    rc = lib.lpt_build_bvh(ptr(plow, f), ptr(phigh, f), ptr(centroid, f), n, max_depth,
                           max_leaf, ptr(left, i), ptr(right, i), ptr(low, f), ptr(high, f),
                           ptr(data, i), ptr(cut, i), ptr(prim, i), ptr(counts, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native BVH builder returned {rc}")
    builds += 1
    m, n_leaves = int(counts[0]), int(counts[1])
    return (left[:m].copy(), right[:m].copy(), low[:m].copy(), high[:m].copy(),
            data[:m].copy(), cut[:n_leaves + 1].copy(), prim)
