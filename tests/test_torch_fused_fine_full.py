"""The color-fused fine-pass forward (honerf_torch.ops.fused_fine_full).

CPU: its plain version against the JAX package's hand_fine_color_apply
in Pallas interpret mode (piece layout), on the same weights:
  * f32: sdf 1e-4, g 1e-3, color 1e-4 (the JAX suite's bounds for that op
    against its XLA path, test_fused_fine_full.py);
  * bf16: sdf 2e-3 abs / 1e-3 rel, the JAX suite's bound for the bf16
    ladder kernel on the same trunk (test_pallas_ops.py); g 2e-3 of
    max|g|, color 1e-3.  Both sides round the same operands to bf16, but
    f32 sums in another order can flip one rounding, which moves the sdf
    of a point by a few 1e-4 (most points agree to ~1e-6).
The CUDA kernel itself is held against the plain version on the card by
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.models.fields import hand_fine_color_apply as jax_fine
from honerf_torch.models import fields as TF
from honerf_torch.ops import fused_fine_full as FF
from test_torch_parity import SMALL, WIDE_EMB, configs, hand_pose, net_params, points_near, t

torch.set_num_threads(1)

TOL = {"f32": (1e-4, 1e-3, 1e-4), "bf16": (2e-3, 2e-3, 1e-3)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sdf_kw", [SMALL, WIDE_EMB], ids=["small", "wide_emb"])
def test_plain_matches_jax_kernel(sdf_kw, dtype):
    jcfg, jccfg, tcfg, tccfg = configs(sdf_kw, dtype)
    jp, tp = net_params(sdf_kw)
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, 40, seed=6)
    want = [np.asarray(x) for x in jax_fine(jp, jcfg, jccfg, jnp.asarray(pts), jnp.asarray(bt),
                                             jnp.asarray(tpose), block=32, interpret=True,
                                             layout="piece")]
    got = [x.numpy() for x in TF.hand_fine_color_apply(tp, tcfg, tccfg, t(pts), t(bt), t(tpose))]
    s_tol, g_tol, c_tol = TOL[dtype]
    np.testing.assert_allclose(got[0], want[0], atol=s_tol, rtol=min(s_tol, 1e-3))
    np.testing.assert_allclose(got[1], want[1], atol=g_tol * max(1.0, np.abs(want[1]).max()),
                               rtol=g_tol)
    np.testing.assert_allclose(got[2], want[2], atol=c_tol, rtol=c_tol)


def test_color_row_map_covers_reference_rows():
    meta = FF.FineMeta(v_multires=3, r_multires=2, d_hidden=64, n_layers=4, skip=2, d_out=65,
                       c_hidden=64, c_layers=3, grad_L=4)
    rows = FF.color_row_map(meta)
    ref_width = meta.emb_width + 64 + 3 + 6 * 4
    live = rows[rows >= 0]
    assert len(rows) == meta.color_dims[0][0]
    np.testing.assert_array_equal(np.sort(live), np.arange(ref_width))

