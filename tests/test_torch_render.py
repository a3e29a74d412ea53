"""honerf_torch camera, sampling and NeuS renderer against the JAX
package on the same inputs (CPU, f32).  Renderer tolerance 2e-4, as the
JAX suite's renderer checks; exact where the computation is a
permutation (merges)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.camera import Camera as JCamera
from honerf_tpu.camera import full_image_ndc_grid as j_grid
from honerf_tpu.camera import xy_to_ray_bundle as j_rays
from honerf_tpu.data.synthetic import posed_hand_example
from honerf_tpu.render import neus as JN
from honerf_tpu.render import sampling as JS
from honerf_torch.camera import Camera, full_image_ndc_grid, xy_to_ray_bundle
from honerf_torch.render import neus as TN
from honerf_torch.render import sampling as TS
from test_torch_parity import SMALL, configs, hand_pose, net_params, t

torch.set_num_threads(1)


def test_rays_match_jax():
    _, R, T = posed_hand_example()
    focal, principal = np.asarray([3.0, 3.0], np.float32), np.zeros(2, np.float32)
    grid_j = np.asarray(j_grid(23, 27))
    grid_t = full_image_ndc_grid(23, 27)
    np.testing.assert_allclose(grid_t.numpy(), grid_j, atol=1e-6)
    rb_j = j_rays(JCamera(jnp.asarray(R), jnp.asarray(T), jnp.asarray(focal),
                          jnp.asarray(principal)), jnp.asarray(grid_j))
    rb_t = xy_to_ray_bundle(Camera(t(R), t(T), t(focal), t(principal)), t(grid_j))
    np.testing.assert_allclose(rb_t.origins.numpy(), np.asarray(rb_j.origins), atol=1e-5)
    np.testing.assert_allclose(rb_t.directions.numpy(), np.asarray(rb_j.directions), atol=1e-5)


def test_upsample_and_pdf_match_jax():
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(0.4, 1.5, (6, 32)).astype(np.float32), -1)
    sdf = (1.0 - z + 0.05 * rng.normal(size=z.shape)).astype(np.float32)
    w_j = np.asarray(JS.neus_upsample_weights(jnp.asarray(z), jnp.asarray(sdf), 128.0))
    w_t = TS.neus_upsample_weights(t(z), t(sdf), 128.0).numpy()
    np.testing.assert_allclose(w_t, w_j, atol=1e-6)
    np.testing.assert_allclose(TS.sample_pdf_det(t(z), t(w_j), 16).numpy(),
                               np.asarray(JS.sample_pdf_det(jnp.asarray(z), jnp.asarray(w_j), 16)),
                               atol=2e-6)


@pytest.mark.parametrize("S,n", [(64, 16), (112, 16), (5, 3), (1, 7)])
def test_merge_sorted_matches_full_sort(S, n):
    rng = np.random.default_rng(S)
    z_a = np.sort(rng.uniform(0, 1, (4, S)).astype(np.float32), -1)
    z_b = np.sort(rng.uniform(0, 1, (4, n)).astype(np.float32), -1)
    z_m, sdf_m = TS.merge_sorted(t(z_a), t(z_b), t(z_a * 3 + 1), t(z_b * 3 + 1))
    np.testing.assert_array_equal(z_m.numpy(), np.sort(np.concatenate([z_a, z_b], -1), -1))
    np.testing.assert_array_equal(sdf_m.numpy(), z_m.numpy() * 3 + 1)
    jz, jsdf = JS.merge_sorted(jnp.asarray(z_a), jnp.asarray(z_b), jnp.asarray(z_a * 3 + 1),
                               jnp.asarray(z_b * 3 + 1))
    np.testing.assert_array_equal(z_m.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(sdf_m.numpy(), np.asarray(jsdf))


def test_merge_sorted_with_ties_matches_jax():
    """Ties across the two inputs: the same z and the same paired sdf as
    the JAX bitonic merge."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 5, size=(3, 12)).astype(np.float32)
    z_a, z_b = np.sort(vals[:, :8], -1), np.sort(vals[:, 8:], -1)
    z_m, sdf_m = TS.merge_sorted(t(z_a), t(z_b), t(z_a * 2), t(z_b * 2))
    jz, jsdf = JS.merge_sorted(jnp.asarray(z_a), jnp.asarray(z_b), jnp.asarray(z_a * 2),
                               jnp.asarray(z_b * 2))
    np.testing.assert_array_equal(z_m.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(sdf_m.numpy(), np.asarray(jsdf))
    z_only, none = TS.merge_z_vals(t(z_a), t(z_b), None, None)
    assert none is None and torch.equal(z_only, z_m)


def test_sdf_to_alpha_matches_jax():
    rng = np.random.default_rng(4)
    sdf, dists = rng.normal(size=(2, 50)).astype(np.float32) * 0.05
    grad, dirs = rng.normal(size=(2, 50, 3)).astype(np.float32)
    a_j, c_j = JN.sdf_to_alpha(jnp.asarray(sdf), jnp.asarray(grad), jnp.asarray(dirs),
                               jnp.abs(jnp.asarray(dists)), jnp.asarray(20.0))
    a_t, c_t = TN.sdf_to_alpha(t(sdf), t(grad), t(dirs), t(np.abs(dists)), torch.tensor(20.0))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)


def test_render_single_matches_jax():
    """render_single with perturb=0 through the exact (autograd) hand
    field, 2e-4 (the renderer tolerance)."""
    jcfg, jccfg, tcfg, tccfg = configs(SMALL)
    jp, tp = net_params(SMALL)
    bt, tpose, joints = hand_pose()
    center = joints.mean(0)
    rng = np.random.default_rng(5)
    d = rng.normal(size=(24, 3)) * 0.1 + np.asarray([0.0, 0.0, 1.0])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (center - 0.5 * d).astype(np.float32)
    o = o - 0.4 * d  # near plane before the hand
    rcfg_j = JN.RenderConfig(n_samples=16, n_importance=16, up_sample_steps=2, perturb=0.0)
    rcfg_t = TN.RenderConfig(n_samples=16, n_importance=16, up_sample_steps=2, perturb=0.0)
    fj = JN.make_hand_field(jp, jcfg, jccfg, jnp.asarray(bt), jnp.asarray(tpose))
    want = JN.render_single(fj, rcfg_j, jax.random.PRNGKey(0), jnp.asarray(o), jnp.asarray(d),
                            0.4, 1.5)
    ft = TN.make_hand_field(tp, tcfg, tccfg, t(bt), t(tpose))
    with torch.no_grad():
        got = TN.render_single(ft, rcfg_t, None, t(o), t(d), 0.4, 1.5)
    assert float(np.asarray(want["weight_sum"]).max()) > 0.1  # the rays hit the hand
    for k in ("color_fine", "weight_sum", "weight_max"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
    # per-sample values follow each sample's z, which the inverse-CDF
    # places with cumsums summed in a different order: 1e-3
    np.testing.assert_allclose(got["cdf_fine"].numpy(), np.asarray(want["cdf_fine"]), atol=1e-3)
    np.testing.assert_allclose(float(got["gradient_error"]), float(want["gradient_error"]),
                               rtol=2e-4)
