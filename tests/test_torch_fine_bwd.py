"""The fine pass's backward (K3's plain version, through the autograd op
honerf_torch.ops.fused_fine_full.hand_fine_color) against jax.vjp of the
JAX package's hand_fine_color_apply in Pallas interpret mode (piece
layout), on the same weights, points, pose and seeded cotangents on
(sdf, g, color).  Gradients on every parameter leaf, the points and
bt_inv, each against max(1, max |want|):

  * f32: 1e-3, the JAX suite's bound for this op against its XLA path
    (test_fused_fine_full.py); measured ~1e-6 (narrow) and ~4e-5 (1386
    channels);
  * bf16: 3e-3 on the narrow net, 2e-2 with the full 1386-channel
    embedding (test_torch_fine_bwd_wide.py).  Both sides round the same
    operands to bf16, but sums in another order flip single roundings;
    the forward's g already differs by ~1e-3 of its range, and the
    second-order terms (beta = 100) carry a flip into every gradient that
    sums over the points.  Measured 2.3e-3 (narrow) and 1.2e-2 (wide).

Also the frozen case (no weight needs a gradient: no dW work, the same
pose and point gradients) and the kernel-layout unpadding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.models.fields import hand_fine_color_apply as jax_fine
from honerf_torch.models import fields as TF
from honerf_torch.ops import fused_fine_full as FF
from test_torch_parity import SMALL, configs, hand_pose, net_params, points_near, t

torch.set_num_threads(1)

TOL = {("small", "f32"): 1e-3, ("small", "bf16"): 3e-3,
       ("wide_emb", "f32"): 1e-3, ("wide_emb", "bf16"): 2e-2}


def _inputs(sdf_kw, n=40):
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, n, seed=6)
    rng = np.random.default_rng(1)
    cts = [rng.normal(size=s).astype(np.float32) for s in ((n,), (n, 3), (n, 3))]
    return bt, tpose, pts, cts


def _leaves(tree):
    return [x for net in ("sdf", "color") for layer in tree[net]["layers"]
            for x in layer.values()]


def torch_grads(tp, tcfg, tccfg, bt, tpose, pts, cts):
    nets = {"sdf": tp["sdf"], "color": tp["color"]}
    for leaf in _leaves(nets):
        leaf.requires_grad_(True)
    x, b = t(pts).requires_grad_(True), t(bt).requires_grad_(True)
    outs = TF.hand_fine_color_apply(nets, tcfg, tccfg, x, b, t(tpose))
    torch.autograd.backward(outs, [t(c) for c in cts])
    return [leaf.grad.numpy() for leaf in _leaves(nets)] + [x.grad.numpy(), b.grad.numpy()]


def check_against_jax(sdf_kw, name, dtype):
    jcfg, jccfg, tcfg, tccfg = configs(sdf_kw, dtype)
    jp, tp = net_params(sdf_kw)
    bt, tpose, pts, cts = _inputs(sdf_kw)

    def f(p, x, b):
        return jax_fine(p, jcfg, jccfg, x, b, jnp.asarray(tpose), block=64, interpret=True,
                        layout="piece")

    _, vjp = jax.vjp(f, {"sdf": jp["sdf"], "color": jp["color"]}, jnp.asarray(pts),
                     jnp.asarray(bt))
    dparams, dpts, dbt = vjp(tuple(jnp.asarray(c) for c in cts))
    # the JAX tree flattens each layer's keys sorted (b, g, v), the port's
    # in insertion order: pair them by key
    want = [np.asarray(dparams[net]["layers"][i][k]) for net in ("sdf", "color")
            for i, layer in enumerate(tp[net]["layers"]) for k in layer]
    want += [np.asarray(dpts), np.asarray(dbt)]
    got = torch_grads(tp, tcfg, tccfg, bt, tpose, pts, cts)
    tol = TOL[(name, dtype)]
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0, err_msg=f"leaf {i}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_bwd_matches_jax_vjp(dtype):
    check_against_jax(SMALL, "small", dtype)


def test_frozen_nets_skip_weight_work(monkeypatch):
    """Weights that need no gradient: the backward is asked for no dW
    work, returns no weight gradients, and the pose and point gradients
    are those of the full backward."""
    _, _, tcfg, tccfg = configs(SMALL, "bf16")
    _, tp = net_params(SMALL)
    bt, tpose, pts, cts = _inputs(SMALL, n=24)
    seen = []
    real = FF.hand_fine_color_plain_bwd

    def spy(*a, **k):
        seen.append(a[-1] if len(a) > 8 else k.get("want_dw", True))
        return real(*a, **k)

    monkeypatch.setattr(FF, "hand_fine_color_plain_bwd", spy)
    full = torch_grads(tp, tcfg, tccfg, bt, tpose, pts, cts)
    nets = {"sdf": tp["sdf"], "color": tp["color"]}
    for leaf in _leaves(nets):
        leaf.grad = None
        leaf.requires_grad_(False)
    x, b = t(pts).requires_grad_(True), t(bt).requires_grad_(True)
    outs = TF.hand_fine_color_apply(nets, tcfg, tccfg, x, b, t(tpose))
    torch.autograd.backward(outs, [t(c) for c in cts])
    assert seen == [True, False]
    assert all(leaf.grad is None for leaf in _leaves(nets))
    np.testing.assert_array_equal(x.grad.numpy(), full[-2])
    np.testing.assert_array_equal(b.grad.numpy(), full[-1])


def test_unpadded_gradients_land_on_the_reference_rows():
    """The backward's kernel-layout dW maps back onto the (in, out) inputs:
    the skip layer's [Hp | Ep] rows and color layer 0's row map."""
    _, _, tcfg, tccfg = configs(SMALL, "f32")
    _, tp = net_params(SMALL)
    meta, ws, bs, cws, cbs = TF.fine_color_weights(tp, tcfg, tccfg)
    pack = FF.pack_fine_weights(ws, bs, cws, cbs, meta)
    # a gradient equal to the padded weights maps back to the weights
    grads = FF.FineGrads(None, None, None, tuple(w.float() for w in pack.ws), pack.bs,
                         tuple(w.float() for w in pack.cws), pack.cbs)
    grads = grads._replace(dp=torch.zeros(1))
    dws, dbs, dcws, dcbs = FF._unpad_grads(grads, meta, [tuple(w.shape) for w in ws],
                                           [tuple(w.shape) for w in cws])
    for got, want in zip(dws + dbs + dcws + dcbs, list(ws) + list(bs) + list(cws) + list(cbs)):
        torch.testing.assert_close(got, want.detach(), atol=0, rtol=0)
