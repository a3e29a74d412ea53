"""The fine pass's f32 modes that pose fitting runs (K2 in f32, K3 in f32
with frozen nets): the port's plain versions on the CPU against the JAX
package's hand_fine_color with FineMeta(dtype='f32', want_dw=False) in
Pallas interpret mode (piece layout), as
tests/test_fused_fine_full.py::test_frozen_color_pose_grads runs it, on
the same weights, within 1e-3 of max(1, max |want|):

  * the forward (sdf, g, color);
  * the frozen backward on seeded cotangents: the gradients in the points
    and the pose (bt_inv, through pack_hand_pose's rotT and off), and no
    weight cotangent (JAX returns zeros; the port's op on weights that
    need no gradient runs the backward with want_dw=False, which forms no
    dW).
The CUDA kernels are held against these plain versions on the card by
test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from honerf_tpu.models.fields import hand_fine_color_apply as jax_fine
from honerf_torch.models import fields as TF
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops.fused_hand import pack_hand_pose
from test_torch_parity import WIDE_EMB, configs, points_near, t
from torch_fit_common import hand_nets, hand_pose_np

torch.set_num_threads(1)

TOL = 1e-3
N = 40


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _jax_op(jp, jcfg, jccfg, tpose):
    return lambda p, pts, bt: jax_fine(p, jcfg, jccfg, pts, bt, jnp.asarray(tpose), block=32,
                                       interpret=True, layout="piece", frozen=True)


def test_f32_frozen_matches_jax():
    """A narrow trunk on the full 1386-channel embedding."""
    jcfg, jccfg, tcfg, tccfg = configs(WIDE_EMB, "f32")
    jp, tp = hand_nets(WIDE_EMB)
    bt, tpose, joints = hand_pose_np()
    pts = points_near(joints, N, seed=6)
    rng = np.random.default_rng(3)
    cts = [rng.normal(size=s).astype(np.float32) for s in ((N,), (N, 3), (N, 3))]

    want, vjp = jax.vjp(_jax_op(jp, jcfg, jccfg, tpose), jp, jnp.asarray(pts), jnp.asarray(bt))
    d_params, d_pts, d_bt = vjp(tuple(jnp.asarray(c) for c in cts))
    # the JAX contract of the frozen kernel: zero weight cotangents
    assert all(float(jnp.abs(x).max()) == 0.0 for x in jax.tree.leaves(d_params))

    pack = TF.pack_fine_color(tp, tcfg, tccfg)
    assert pack.meta.dtype == "f32"
    leaves = [x for net in ("sdf", "color") for layer in tp[net]["layers"]
              for x in layer.values()]
    assert not any(x.requires_grad for x in leaves)      # the nets are constants
    tpts, tbt = t(pts).requires_grad_(True), t(bt).requires_grad_(True)
    got = TF.hand_fine_color_apply(tp, tcfg, tccfg, tpts, tbt, t(tpose))
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)
    torch.autograd.backward(got, [t(c) for c in cts])
    _close(tpts.grad.numpy(), d_pts)
    _close(tbt.grad.numpy(), d_bt)
    assert float(tbt.grad.abs().max()) > 0

    # the plain backward itself: dp, drotT and doff, and no dW
    rotT, off, cut = pack_hand_pose(t(bt), t(tpose))
    grads = FF.hand_fine_color_plain_bwd(t(pts), rotT, off, cut, pack, *[t(c) for c in cts],
                                         want_dw=False)
    assert grads.dws is None and grads.dbs is None and grads.dcws is None
    _close(grads.dp.numpy(), d_pts)
