"""The fine pass without the color net (honerf_torch.ops.fused_fine_full.
hand_fine_color with FineMeta.with_color False: K2 / K3 in their no-color
mode, plain versions on the CPU) against the JAX package's hand_fine_full
in Pallas interpret mode (piece layout), on the same weights, points, pose and seeded cotangents
on (out, g, e):

  * forward: out 1e-4 (f32) / 2e-3 abs and 1e-3 rel (bf16), g 1e-3 / 2e-3
    of max |g|, as test_torch_fused_fine_full.py holds the color-fused
    op; e 1e-6 in f32, and in bf16 one bf16 step (2^-8 relative) where the
    two frameworks' f32 embeddings round to neighbouring bf16 values;
  * VJP (dp, drotT, doff, every dW and db) against max(1, max |want|):
    1e-3 in f32 and 3e-3 in bf16, test_torch_fine_bwd.py's bounds for the
    color-fused op on the same net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.models.fields import _fine_trunk_weights as jax_trunk_weights
from honerf_tpu.ops.fused_fine_full import FineMeta as JFineMeta
from honerf_tpu.ops.fused_fine_full import hand_fine_full as jax_fine_full
from honerf_tpu.ops.fused_hand import pack_hand_pose as jax_pack_pose
from honerf_torch.models import fields as TF
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops.fused_hand import pack_hand_pose
from test_torch_parity import SMALL, configs, hand_pose, net_params, points_near, t

torch.set_num_threads(1)

N = 40
FWD_TOL = {"f32": (1e-4, 1e-4, 1e-3), "bf16": (2e-3, 1e-3, 2e-3)}
VJP_TOL = {"f32": 1e-3, "bf16": 3e-3}


def _setup(dtype, seed=1):
    jcfg, _, tcfg, _ = configs(SMALL, dtype)
    jp, tp = net_params(SMALL)
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, N, seed=6)
    rng = np.random.default_rng(seed)
    E = tcfg.input_width
    cts = [rng.normal(size=s).astype(np.float32) for s in ((N, tcfg.d_out), (N, 3), (N, E))]
    jmeta = JFineMeta(v_multires=jcfg.v_multires, r_multires=jcfg.r_multires,
                      d_hidden=jcfg.d_hidden, n_layers=len(jcfg.dims) - 1,
                      skip=jcfg.skip_in[0], d_out=jcfg.d_out, dtype=dtype)
    return jcfg, tcfg, jp, tp, bt, tpose, pts, cts, jmeta


def _jax(jcfg, jp, bt, tpose, pts, cts, jmeta):
    rotT, off, _ = jax_pack_pose(jnp.asarray(bt), jnp.asarray(tpose))
    ws, bs = jax_trunk_weights(jp["sdf"], jcfg)

    def f(p, r, o, w, b):
        return jax_fine_full(p, r, o, w, b, jmeta, 32, True)

    outs, vjp = jax.vjp(f, jnp.asarray(pts), rotT, off, tuple(ws), tuple(bs))
    dp, drotT, doff, dws, dbs = vjp(tuple(jnp.asarray(c) for c in cts))
    grads = [dp, drotT[:3, :63], doff[0, :63], *dws, *dbs]
    return [np.asarray(x) for x in outs], [np.asarray(x) for x in grads]


def _torch(tcfg, tp, bt, tpose, pts, cts):
    rotT, off, cut = pack_hand_pose(t(bt), t(tpose))
    rotT, off = rotT.requires_grad_(True), off.requires_grad_(True)
    ws, bs = TF._fine_trunk_weights(tp["sdf"], tcfg)
    ws = [w.detach().requires_grad_(True) for w in ws]
    bs = [b.detach().requires_grad_(True) for b in bs]
    x = t(pts).requires_grad_(True)
    outs = FF.hand_fine_color(x, rotT, off, cut, ws, bs, (), (),
                           TF.fine_nocolor_meta(tcfg))
    torch.autograd.backward(outs, [t(c) for c in cts])
    grads = [x.grad, rotT.grad[:3, :63], off.grad[0, :63], *[w.grad for w in ws],
             *[b.grad for b in bs]]
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_vjp_match_jax(dtype):
    jcfg, tcfg, jp, tp, bt, tpose, pts, cts, jmeta = _setup(dtype)
    (w_out, w_g, w_e), want = _jax(jcfg, jp, bt, tpose, pts, cts, jmeta)
    (g_out, g_g, g_e), got = _torch(tcfg, tp, bt, tpose, pts, cts)
    assert g_out.shape == w_out.shape == (N, tcfg.d_out)
    assert g_e.shape == w_e.shape == (N, tcfg.input_width)
    o_atol, o_rtol, g_tol = FWD_TOL[dtype]
    np.testing.assert_allclose(g_out, w_out, atol=o_atol, rtol=o_rtol)
    np.testing.assert_allclose(g_g, w_g, atol=g_tol * max(1.0, np.abs(w_g).max()), rtol=g_tol)
    if dtype == "f32":
        np.testing.assert_allclose(g_e, w_e, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_allclose(g_e, w_e, atol=1e-6, rtol=2.0 ** -8)
    assert len(got) == len(want)
    tol = VJP_TOL[dtype]
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0, err_msg=f"leaf {i}")


def test_frozen_and_pack_paths():
    """Weights that need no gradient: no dW work and the same point and
    pose gradients; the forward on a pack (the eval render's) gives the
    op's outputs."""
    _, tcfg, _, tp, bt, tpose, pts, cts, _ = _setup("bf16")
    rotT, off, cut = pack_hand_pose(t(bt), t(tpose))
    pack = TF.pack_fine_nocolor(tp["sdf"], tcfg)
    full = FF.hand_fine_color_bwd(t(pts), rotT, off, cut, pack, *map(t, cts))
    frozen = FF.hand_fine_color_bwd(t(pts), rotT, off, cut, pack, *map(t, cts), want_dw=False)
    assert frozen.dws is None and full.dcws is None and len(full.dws) == tcfg.n_layers + 1
    for name in ("dp", "drotT", "doff"):
        assert torch.equal(getattr(frozen, name), getattr(full, name))
    ws, bs = TF._fine_trunk_weights(tp["sdf"], tcfg)
    with torch.no_grad():
        op = FF.hand_fine_color(t(pts), rotT, off, cut, ws, bs, (), (),
                                TF.fine_nocolor_meta(tcfg))
    for a, b in zip(FF.hand_fine_color_fwd(t(pts), rotT, off, cut, pack), op):
        assert torch.equal(a, b)
