"""Mesh extraction in the port (honerf_torch.extract), mirroring
tests/test_extract.py with torch SDF functions on the CPU, and against
the JAX package's extraction: both bind the same native
marching_cubes.cpp, so one grid gives the same mesh bit for bit, and the
grid's points are the same f32 values."""

import jax.numpy as jnp
import numpy as np
import torch

from honerf_torch.extract import (
    bounds_from_points,
    evaluate_sdf_grid,
    extract_geometry,
    inner_point_ids,
    marching_cubes,
)

torch.set_num_threads(1)


def _sphere_grid(n=48):
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    return np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6


def test_marching_cubes_sphere_surface():
    n = 48
    verts, tris = marching_cubes(_sphere_grid(n), 0.0)
    assert len(verts) > 200 and len(tris) > 200
    world = verts / (n - 1) * 2.0 - 1.0
    np.testing.assert_allclose(np.linalg.norm(world, axis=-1), 0.6, atol=0.05)
    assert tris.max() < len(verts)
    assert len(verts) < 3 * len(tris)  # shared vertices


def test_marching_cubes_empty_grid():
    verts, tris = marching_cubes(np.ones((8, 8, 8), np.float32), 0.0)
    assert len(verts) == 0 and len(tris) == 0


def test_marching_cubes_matches_jax_binding():
    from honerf_tpu.extract import marching_cubes as jax_mc

    u = _sphere_grid(40) + 0.05 * np.sin(7 * np.arange(40 ** 3)).reshape(40, 40, 40)
    for iso in (0.0, 0.1):
        got, want = marching_cubes(u, iso), jax_mc(u, iso)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _sphere_fn(center, r):
    c = torch.as_tensor(center, dtype=torch.float32)
    return lambda pts: torch.linalg.norm(pts - c, dim=-1) - r


def test_extract_geometry_world_space():
    verts, tris = extract_geometry(_sphere_fn([0.1, 0.0, -0.2], 0.25), [-0.5, -0.5, -0.7],
                                   [0.7, 0.5, 0.3], 40, device="cpu")
    r = np.linalg.norm(verts - np.asarray([0.1, 0.0, -0.2]), axis=-1)
    np.testing.assert_allclose(r, 0.25, atol=0.03)


def test_grid_points_match_jax():
    """The grid's points are the JAX package's (np.linspace in f32,
    indexing 'ij'), in the same order: the identity field returns them."""
    from honerf_tpu.extract.grid import evaluate_sdf_grid as jax_grid

    lo, hi, R = [-0.2, -0.1, -0.3], [0.2, 0.25, 0.1], 9
    for c in range(3):
        got = evaluate_sdf_grid(lambda p: p[:, c], lo, hi, R, chunk=100, device="cpu")
        want = jax_grid(lambda p: p[:, c], lo, hi, R, chunk=128)
        np.testing.assert_array_equal(got, want)


def test_extract_geometry_matches_jax():
    from honerf_tpu.extract import extract_geometry as jax_extract

    lo, hi = [-0.5, -0.5, -0.7], [0.7, 0.5, 0.3]
    got = extract_geometry(_sphere_fn([0.1, 0.0, -0.2], 0.25), lo, hi, 32, 0.02, device="cpu")
    want = jax_extract(lambda p: jnp.linalg.norm(p - jnp.asarray([0.1, 0.0, -0.2]), axis=-1)
                       - 0.25, lo, hi, 32, 0.02)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)


def test_inner_point_ids():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    ids = inner_point_ids(_sphere_fn([0.0, 0.0, 0.0], 0.5), pts, chunk=128, device="cpu")
    np.testing.assert_array_equal(ids, np.where(np.linalg.norm(pts, axis=-1) <= 0.5)[0])


def test_bounds_from_points():
    lo, hi = bounds_from_points(np.asarray([[0.0, 1.0, -1.0], [2.0, -1.0, 3.0]]), 0.1)
    np.testing.assert_allclose(lo, [-0.1, -1.1, -1.1])
    np.testing.assert_allclose(hi, [2.1, 1.1, 3.1])


def test_save_ply_writes_the_jax_bytes(tmp_path):
    from honerf_tpu.utils.ply import save_ply as jax_save
    from honerf_torch.utils.ply import load_ply, save_ply

    verts, tris = marching_cubes(_sphere_grid(24), 0.0)
    save_ply(str(tmp_path / "a.ply"), verts * 1000.0, tris)
    jax_save(str(tmp_path / "b.ply"), verts * 1000.0, tris)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    v, f = load_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(f, tris)
    np.testing.assert_allclose(v, verts * 1000.0, rtol=1e-6)
