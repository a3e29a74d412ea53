"""SDF grid evaluation on the device and mesh extraction; counterpart of
honerf_tpu.extract.grid.

The grid's axes are built with numpy in f32 as in the JAX package, then
moved to the device; each chunk's points are gathered there from the
axes, every chunk's values stay on the device, and the grid comes to the
host once for the C++ marching cubes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from honerf_torch.extract.marching_cubes import marching_cubes
from honerf_torch.utils.device import resolve_device


def evaluate_sdf_grid(sdf_fn: Callable, bound_min, bound_max, resolution: int,
                      chunk: int = 1 << 16, device=None) -> np.ndarray:
    """`sdf_fn((N, 3) tensor) -> (N,)` on the resolution^3 grid spanning
    [bound_min, bound_max] (indexing 'ij'), in chunks of `chunk` points;
    on the card unless device="cpu"."""
    device = resolve_device(device)
    lo = np.asarray(bound_min, np.float32)
    hi = np.asarray(bound_max, np.float32)
    axes = [torch.as_tensor(np.linspace(lo[i], hi[i], resolution, dtype=np.float32),
                            device=device) for i in range(3)]
    R = resolution
    n = R ** 3
    out = torch.empty((n,), dtype=torch.float32, device=device)
    with torch.no_grad():
        for s in range(0, n, chunk):
            idx = torch.arange(s, min(s + chunk, n), device=device)
            pts = torch.stack([axes[0][idx // (R * R)], axes[1][(idx // R) % R],
                               axes[2][idx % R]], dim=-1)
            out[s:s + idx.shape[0]] = sdf_fn(pts)
    return out.reshape(R, R, R).cpu().numpy()


def extract_geometry(sdf_fn: Callable, bound_min, bound_max, resolution: int,
                     threshold: float = 0.0, device=None,
                     timings: Optional[Dict[str, float]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Grid evaluation + marching cubes -> (world-space vertices,
    triangles), with the reference's rescale from grid-index space to
    [bound_min, bound_max] and reversed winding.  `timings`, if given,
    receives the seconds of the grid ('grid_s') and of marching cubes
    ('mc_s') on the host clock (the grid ends in its copy to the host)."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    t0 = time.perf_counter()
    u = evaluate_sdf_grid(sdf_fn, bound_min, bound_max, resolution, device=device)
    t1 = time.perf_counter()
    verts, tris = marching_cubes(u, threshold)
    if timings is not None:
        timings.update(grid_s=t1 - t0, mc_s=time.perf_counter() - t1)
    tris = tris[:, ::-1]
    verts = verts / (resolution - 1.0) * (bound_max - bound_min)[None, :] + bound_min
    return verts, tris


def inner_point_ids(hand_sdf_fn: Callable, pts_world: np.ndarray, chunk: int = 1 << 14,
                    device=None) -> np.ndarray:
    """Indices of the points inside the surface (sdf <= 0): the
    penetration query."""
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(pts_world, np.float32).reshape(-1, 3), device=device)
    with torch.no_grad():
        vals = [hand_sdf_fn(pts[s:s + chunk]) for s in range(0, pts.shape[0], chunk)]
    vals = torch.cat(vals).cpu().numpy() if vals else np.zeros((0,), np.float32)
    return np.where(vals <= 0)[0]


def bounds_from_points(pts: np.ndarray, padding: float) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned bounding box of the points, +- padding."""
    pts = np.asarray(pts)
    return pts.min(0) - padding, pts.max(0) + padding
