"""ctypes binding to the C++ marching-cubes host library; counterpart of
honerf_tpu.extract.marching_cubes, with the same C interface.

The source is the repository's native/marching_cubes.cpp, shared with the
JAX package.  It is compiled with g++ at first use into
build/honerf_native/ at the repository root, under a name that carries a
hash of the source and flags (an edited source is rebuilt), and never
beside the source, where the JAX package keeps its own build.  A failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "marching_cubes.cpp"
BUILD_DIR = ROOT / "build" / "honerf_native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _build() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libmarching_cubes-{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.mc_run.restype = ctypes.c_int
            lib.mc_run.argtypes = [fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                   ctypes.POINTER(fp), ctypes.POINTER(ctypes.c_long),
                                   ctypes.POINTER(ip), ctypes.POINTER(ctypes.c_long)]
            lib.mc_free.restype = None
            lib.mc_free.argtypes = [fp, ip]
            _lib = lib
    return _lib


def marching_cubes(grid: np.ndarray, iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-surface of a (nx, ny, nz) scalar grid: (vertices (V, 3)
    float32 in grid-index coordinates, triangles (T, 3) int64)."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D, got shape {grid.shape}")
    lib = _load()
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int)()
    n_verts, n_tris = ctypes.c_long(), ctypes.c_long()
    rc = lib.mc_run(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *grid.shape,
                    ctypes.c_float(iso), ctypes.byref(verts_p), ctypes.byref(n_verts),
                    ctypes.byref(tris_p), ctypes.byref(n_tris))
    if rc != 0:
        raise MemoryError("marching cubes allocation failed")
    try:
        v = (np.ctypeslib.as_array(verts_p, shape=(n_verts.value, 3)).copy()
             if n_verts.value else np.zeros((0, 3), np.float32))
        t = (np.ctypeslib.as_array(tris_p, shape=(n_tris.value, 3)).astype(np.int64)
             if n_tris.value else np.zeros((0, 3), np.int64))
    finally:
        lib.mc_free(verts_p, tris_p)
    return v, t
