"""Minimal PLY mesh IO in pure numpy (host side only); a copy of
honerf_tpu.utils.ply, which the port cannot import without JAX, whose
writer packs the faces in one numpy record array (the same bytes).

Replaces the reference's open3d dependency (`load_ply`,
utils/dataset.py:17-21).  Supports ascii and binary_little_endian, vertex
x/y/z (+ extra properties, skipped) and triangular faces; writes binary
little-endian.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vertices (V, 3) float64, faces (F, 3) int64)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_kind, dtype...)...])
        cur_props = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            parts = line.decode("ascii").strip().split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur_props = []
                elements.append((parts[1], int(parts[2]), cur_props))
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur_props.append(("list", _PLY_DTYPES[parts[2]], _PLY_DTYPES[parts[3]], parts[4]))
                else:
                    cur_props.append(("scalar", _PLY_DTYPES[parts[1]], parts[2]))
            elif parts[0] == "end_header":
                break
        verts = np.zeros((0, 3))
        faces = np.zeros((0, 3), dtype=np.int64)
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().decode("ascii").split() for _ in range(count)]
                if name == "vertex":
                    idx = {p[2]: i for i, p in enumerate(props) if p[0] == "scalar"}
                    arr = np.asarray(rows, dtype=np.float64)
                    verts = arr[:, [idx["x"], idx["y"], idx["z"]]]
                elif name == "face":
                    faces = np.asarray([r[1:4] for r in rows], dtype=np.int64)
            else:  # binary_little_endian
                if name == "vertex" and all(p[0] == "scalar" for p in props):
                    dt = np.dtype([(p[2], "<" + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], axis=-1
                    ).astype(np.float64)
                elif name == "face":
                    (kind, cnt_dt, idx_dt, _pname) = props[0]
                    cnt_size = np.dtype(cnt_dt).itemsize
                    idx_size = np.dtype(idx_dt).itemsize
                    out = np.zeros((count, 3), dtype=np.int64)
                    for i in range(count):
                        n = int(np.frombuffer(f.read(cnt_size), dtype="<" + cnt_dt)[0])
                        idxs = np.frombuffer(f.read(idx_size * n), dtype="<" + idx_dt)
                        out[i] = idxs[:3]
                    faces = out
                else:
                    # skip unknown fixed-size element
                    dt = np.dtype([(f"p{i}", "<" + p[1]) for i, p in enumerate(props)])
                    f.read(dt.itemsize * count)
    return verts, faces


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian writer (replaces trimesh .export for .ply)."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(vertices.astype("<f4").tobytes())
        # one packed (count, 3 indices) record per face, written at once
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        rec["n"] = 3
        rec["idx"] = faces.reshape(-1, 3)
        f.write(rec.tobytes())
