"""The video fit step, fit types '123' and '1234' (honerf_torch.fit.video),
plain versions on the CPU, against the JAX package's make_video_fit_step
on the same seeded inputs, small nets, f32: one window of four distinct
frames of a six-frame sequence (each frame's hand and object 1 cm further
along, its own noisy estimates; the stable term's vertices inside the
hand in some frames), from tables near their start.  Every metric, every
table's gradient and the tables after Adam: the port's autograd field
within 2e-4 of max(1, max |want|), its 'full' mode (the plain versions of
K2 and the frozen K3) within 1e-3 (tests/test_torch_fit_step.py's
tolerances).  The JAX step vmaps the frames and runs its XLA field (it
has no Pallas switch).  JAX's gradients are read from its Adam state.

Then: two steps on two windows ([0, 3] then [1, 4]) against JAX's (the
first window's row 0 keeps moving on its moments in the second step, row
5 never moves); the boundary anchors (first and last exclusive,
anchor_enabled = 0 removes both); the stable term alone moves
joint_angle.
"""

import functools

import numpy as np
import pytest
import torch

from honerf_torch.fit import single as TS
from honerf_torch.fit import video as TV
from honerf_torch.render import neus as TN
from honerf_torch.render.losses import pose_l2
from torch_fit_common import (
    N_FRAMES,
    N_RAYS,
    RC,
    close,
    jax_video_steps,
    port_batch,
    port_video_steps,
    setup,
    t,
    tables0,
    window_batch,
)

torch.set_num_threads(1)
WINDOWS = ([0, 1, 2, 3], [1, 2, 3, 4])


@functools.lru_cache(maxsize=None)
def jax_steps(fit_type):
    return jax_video_steps(setup(), fit_type, [window_batch(w) for w in WINDOWS])


def _held(got, want, tol):
    (tm, tg, tt), (jm, jg, jt) = got, want
    assert set(tm) == set(jm)
    for k in jm:
        close(tm[k], jm[k], tol)
    for k in TS.POSE_KEYS:
        close(tg[k], jg[k], tol)
        close(tt[k], jt[k], tol)


@pytest.mark.parametrize("fit_type", ("123", "1234"))
def test_video_step_matches_jax(fit_type):
    s = setup()
    want = jax_steps(fit_type)[0]
    assert len(set(np.round(window_batch(WINDOWS[0])["joints_pred"][:, 0, 0], 4))) == 4
    for fine, tol in ((None, 2e-4), ("full", 1e-3)):
        got = port_video_steps(s, fit_type, [window_batch(WINDOWS[0])], fine)[0]
        _held(got, want, tol)
        tg = got[1]
        # the window's rows have a gradient, the others none
        assert np.abs(tg["joint_angle"][:4]).max() > 0 and np.abs(tg["obj_trans"][:4]).max() > 0
        assert not np.abs(tg["joint_angle"][4:]).any()
    if fit_type == "1234":
        assert want[0]["stable_loss"] > 0


def test_two_windows_match_jax():
    """Adam on whole tables: a row of the first window moves on its
    moments in the second step as JAX's, a row of neither window stays."""
    s = setup()
    want = jax_steps("123")
    got = port_video_steps(s, "123", [window_batch(w) for w in WINDOWS])
    for g, w in zip(got, want):
        _held(g, w, 2e-4)
    start = tables0()
    (_, g1, t1), (_, g2, t2) = got
    for k in TS.POSE_KEYS:
        assert not np.abs(g2[k][0]).any()                       # row 0: out of window 2
        assert np.abs(t2[k][0] - t1[k][0]).max() > 0            # ... and still moving
        np.testing.assert_array_equal(t2[k][5], start[k][5])    # row 5: in neither


def _loss(fit_type="123"):
    s = setup()
    tcfg, tccfg, tocfg, toccfg = s["tcfgs"]
    return TV.make_video_fit_loss(s["tnets"], tcfg, tccfg, tocfg, toccfg, TN.RenderConfig(**RC),
                                  TS.FitHyper(batch_size=N_RAYS, fit_type=fit_type), N_FRAMES)


def _tables():
    tables = TV.init_video_tables(N_FRAMES, "cpu")
    with torch.no_grad():
        for k, v in tables0().items():
            tables[k].copy_(t(v))
    return tables


@pytest.mark.parametrize("idx", ([0, 1, 2, 3], [2, 3, 4, 5], [1, 2, 3, 4], [0, 1, 2, 3, 4, 5]))
def test_boundary_anchors(idx):
    """smooth_loss = adjacent-frame terms + the first frame's anchor if the
    window starts the sequence, else the last frame's if it ends it; with
    anchor_enabled = 0 the adjacent-frame terms alone."""
    loss_fn, tables = _loss(), _tables()
    with torch.no_grad():
        joint_3d, obj_r, obj_t = TV.window_pose(tables, port_batch(window_batch(idx)))
        b = port_batch(window_batch(idx))
        verts = b["obj_verts"]
        pred_v = torch.einsum("fij,vj->fvi", obj_r, verts) + obj_t[:, None]
        comp_v = torch.einsum("fij,vj->fvi", b["Ro_pred"], verts) + b["To_pred"][:, None]
        adjacent = float(pose_l2(joint_3d[1:], joint_3d[:-1]) + pose_l2(pred_v[1:], pred_v[:-1]))
        first = float(pose_l2(joint_3d[:1], b["joints_pred"][:1]) + pose_l2(pred_v[:1],
                                                                            comp_v[:1]))
        last = float(pose_l2(joint_3d[-1:], b["joints_pred"][-1:])
                     + pose_l2(pred_v[-1:], comp_v[-1:]))
        want = adjacent + (first if idx[0] == 0 else last if idx[-1] == N_FRAMES - 1 else 0.0)
        for anchor, expect in ((1.0, want), (0.0, adjacent)):
            got = float(loss_fn(tables, port_batch(window_batch(idx, anchor)))[1]["smooth_loss"])
            close(got, expect, 1e-6)


def test_stable_term_moves_the_hand_pose():
    """The '1234' stable term alone has a non-zero gradient in joint_angle
    (through the autograd field's sdf at the object's vertices)."""
    loss_fn, tables = _loss("1234"), _tables()
    terms, metrics = loss_fn(tables, port_batch(window_batch(WINDOWS[0])))
    assert float(metrics["stable_loss"].detach()) > 0
    (g,) = torch.autograd.grad(terms["stable"], [tables["joint_angle"]])
    assert float(g[:4].abs().max()) > 0
