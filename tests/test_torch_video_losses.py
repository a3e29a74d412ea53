"""The video fitter's losses and window sampler (honerf_torch.render.losses
smooth_loss / stable_loss_cross, honerf_torch.data.FrameWindowSampler)
against the JAX package's on the same seeded numpy inputs, within 1e-6 of
max(1, max |want|) (and 1e-6 relative): the values, and the gradient of
stable_loss_cross in the sdf values against jax.grad.  stable_loss_cross
keeps the reference's quirks (see its docstring); the cases pin them: a
fully penetrating frame (vertex id 0 a candidate), one frame in contact
(loss 0), frames with no contact, fewer than three vertices, and mixes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.data import FrameWindowSampler as JSampler
from honerf_tpu.render import losses as JL
from honerf_torch.data import FrameWindowSampler as TSampler
from honerf_torch.render import losses as TL

torch.set_num_threads(1)
TOL = 1e-6


def close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max(initial=0.0))))


def _sdf(case, rng):
    """(F, V) sdf values and (V, 3) vertices of a named case."""
    F, V = {"fully_in": (4, 30), "single_contact": (4, 30), "no_contact": (3, 30),
            "two_verts": (4, 2), "one_vert": (3, 1), "mixed": (5, 40),
            "mixed_dense": (4, 25)}[case]
    verts = rng.normal(0, 0.05, (V, 3)).astype(np.float32)
    sdf = rng.uniform(0.001, 0.02, (F, V)).astype(np.float32)
    if case == "fully_in":
        sdf[1] = -rng.uniform(0.001, 0.02, V)          # frame 1 entirely inside
        sdf[2, rng.choice(V, 5, replace=False)] *= -1  # frame 2 in contact
    elif case == "single_contact":
        sdf[2, rng.choice(V, 6, replace=False)] *= -1
    elif case in ("two_verts", "one_vert"):
        sdf[:2] *= -1
        if V > 1:
            sdf[2, 1] *= -1
    elif case == "mixed":
        sdf[rng.uniform(size=(F, V)) < 0.3] *= -1
        sdf[3] = np.abs(sdf[3])                        # a frame with no contact
        sdf[:, :2] *= -1                               # ids 0 and 1 inside
    elif case == "mixed_dense":
        sdf[rng.uniform(size=(F, V)) < 0.7] *= -1
    return sdf, verts


CASES = ("fully_in", "single_contact", "no_contact", "two_verts", "one_vert", "mixed",
         "mixed_dense")


@pytest.mark.parametrize("case", CASES)
def test_stable_loss_cross_matches_jax(case):
    sdf, verts = _sdf(case, np.random.default_rng(CASES.index(case)))
    want = float(JL.stable_loss_cross(jnp.asarray(sdf), jnp.asarray(verts)))
    got = float(TL.stable_loss_cross(torch.as_tensor(sdf), torch.as_tensor(verts)))
    close(got, want)
    in_time = int(((sdf < 0).sum(1) > 0).sum())
    if in_time <= 1:
        assert got == 0.0
    else:
        assert got > 0.0


@pytest.mark.parametrize("case", ("fully_in", "mixed", "mixed_dense", "two_verts"))
def test_stable_loss_cross_gradient_matches_jax(case):
    sdf, verts = _sdf(case, np.random.default_rng(10 + CASES.index(case)))
    want = np.asarray(jax.grad(lambda s: JL.stable_loss_cross(s, jnp.asarray(verts)))(
        jnp.asarray(sdf)))
    x = torch.as_tensor(sdf).requires_grad_(True)
    TL.stable_loss_cross(x, torch.as_tensor(verts)).backward()
    close(x.grad.numpy(), want)
    assert np.abs(want).max() > 0


def test_stable_loss_cross_counts_a_nearest_candidate_once():
    """Two in-points whose nearest candidate is the same vertex add its
    negative sdf once (the reference's np.unique), and id 0 is a candidate
    only in a fully penetrating frame."""
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0.1, 0, 0], [5, 0, 0]], np.float32)
    sdf = np.asarray([[-0.01, -0.02, 0.03, 0.04], [-0.01, -0.02, -0.03, -0.04]], np.float32)
    want = float(JL.stable_loss_cross(jnp.asarray(sdf), jnp.asarray(verts)))
    got = float(TL.stable_loss_cross(torch.as_tensor(sdf), torch.as_tensor(verts)))
    close(got, want)


def test_smooth_loss_matches_jax():
    rng = np.random.default_rng(5)
    joints = rng.normal(0, 0.1, (4, 21, 3)).astype(np.float32)
    verts = rng.normal(0, 0.1, (4, 50, 3)).astype(np.float32)
    want = float(JL.smooth_loss(jnp.asarray(joints), jnp.asarray(verts)))
    got = float(TL.smooth_loss(torch.as_tensor(joints), torch.as_tensor(verts)))
    close(got, want)


@pytest.mark.parametrize("n_frames", (1, 3, 4, 7))
def test_frame_window_sampler_matches_jax(n_frames):
    want, got = JSampler(n_frames, 4), TSampler(n_frames, 4)
    assert list(got) == list(want) and len(got) == len(want)
    assert list(TSampler(n_frames, 4, n_iter=2)) == list(JSampler(n_frames, 4, n_iter=2))
