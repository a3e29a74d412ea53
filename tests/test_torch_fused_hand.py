"""The ladder SDF kernel module (honerf_torch.ops.fused_hand).

CPU: its plain version against the JAX package's FusedHandSDF in Pallas
interpret mode, atol 2e-3 / rtol 1e-3 (the JAX suite's own bound for that
kernel against the XLA forward, test_pallas_ops.py), once at a narrow
trunk with the full 1386-channel embedding; the fused trunk's plain
version (fused_fine.trunk_fwd's sdf column on embed_plain's e) against
the same JAX run.  The CUDA kernel itself is
held against the plain version on the card by test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops.fused_hand import FusedHandSDF as JaxFusedHandSDF
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_hand as FH
from test_torch_parity import SMALL, WIDE_EMB, configs, hand_pose, net_params, points_near, t

torch.set_num_threads(1)


@pytest.mark.parametrize("sdf_kw", [SMALL, WIDE_EMB], ids=["small", "wide_emb"])
def test_plain_matches_jax_kernel(sdf_kw):
    jcfg, _, tcfg, _ = configs(sdf_kw)
    jp, tp = net_params(sdf_kw)
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, 300, scale=0.1)
    want = np.asarray(JaxFusedHandSDF(jp["sdf"], jcfg, interpret=True, layout="piece")(
        jnp.asarray(pts), jnp.asarray(bt), jnp.asarray(tpose)))
    got = FH.FusedHandSDF(tp["sdf"], tcfg)(t(pts), t(bt), t(tpose))
    assert got.shape == (300,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)
    # the fused trunk's plain version (fused_fine.trunk_fwd on CPU tensors:
    # trunk_fwd_plain's sdf column) on embed_plain's e, against the same run
    ws, bs, meta = FH.pack_hand_sdf_weights(tp["sdf"], tcfg)
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    e = FH.embed_plain(t(pts), rotT, off, cut, meta.v_multires, meta.r_multires, meta.trunk.Ep)
    sdf = torch.empty(300)
    FT.trunk_fwd(e, 300, ws, bs, meta.trunk, sdf=sdf)
    np.testing.assert_allclose(sdf.numpy(), want, atol=2e-3, rtol=1e-3)


def test_cpu_path_does_not_count_launches():
    _, _, tcfg, _ = configs(SMALL)
    _, tp = net_params(SMALL)
    bt, tpose, joints = hand_pose()
    before = FH.KERNEL.launches
    FH.FusedHandSDF(tp["sdf"], tcfg)(t(points_near(joints, 5)), t(bt), t(tpose))
    assert FH.KERNEL.launches == before


def test_rejects_bad_operands():
    _, _, tcfg, _ = configs(SMALL)
    _, tp = net_params(SMALL)
    bt, tpose, joints = hand_pose()
    ws, bs, meta = FH.pack_hand_sdf_weights(tp["sdf"], tcfg)
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    with pytest.raises(ValueError):
        FH.fused_hand_sdf(t(points_near(joints, 4))[:, :2], rotT, off, cut, ws, bs, meta)
    with pytest.raises(ValueError):
        FH.fused_hand_sdf(t(points_near(joints, 4)).double(), rotT, off, cut, ws, bs, meta)
