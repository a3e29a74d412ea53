"""The trunk + u-chain op (honerf_torch.ops.fused_fine.hand_trunk_sdf_u,
K5 forward and K6 backward, their plain versions on the CPU) against the
JAX package's hand_trunk_sdf_u in Pallas interpret mode and its pure-JAX
spec, at tests/test_fused_fine.py's META (E 30, H 16, 5 layers, skip 2,
d_out 17), on the same seeded numpy inputs:

  * f32 forward within 1e-4 (the JAX suite's bound for its kernel against
    the spec);
  * f32 VJP: de, every dW and db within 1e-3 of max(1, max |want|), the
    JAX suite's bound (test_fused_fine.py);
  * bf16: both sides round the same operands at the same points, f32 sums
    in another order: median within 1e-4 and max within 1e-2 of the
    output's range.  One exception: the skip layer's dW, median 1e-3.
    XLA's excess precision (xla_allow_excess_precision, on by default)
    keeps the scaled skip concat in f32 inside the JAX dW product, where
    the kernels round it to bf16; measured 1.2e-4 to 2.0e-4 at these
    seeds, and 0 with the flag off;
  * frozen weights: the same de, and no dW work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine as JF
from honerf_torch.ops import fused_fine as TF

torch.set_num_threads(1)

DIMS = dict(emb_width=30, d_hidden=16, n_layers=5, skip=2, d_out=17)


def _metas(dtype):
    return JF.TrunkMeta(**DIMS, dtype=dtype), TF.TrunkMeta(**DIMS, dtype=dtype)


def _inputs(n, seed=0):
    """(ws, bs, e, dout, du) as numpy, the JAX suite's weight scales."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for d_in, d_out in TF._dims(TF.TrunkMeta(**DIMS)):
        ws.append((rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(np.float32))
        bs.append((rng.normal(size=(d_out,)) * 0.05).astype(np.float32))
    e = rng.normal(size=(n, DIMS["emb_width"])).astype(np.float32)
    dout = rng.normal(size=(n, DIMS["d_out"])).astype(np.float32)
    du = rng.normal(size=(n, DIMS["emb_width"])).astype(np.float32)
    return ws, bs, e, dout, du


def t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=grad)


def _jax_vjp(jmeta, ws, bs, e, dout, du):
    def loss(e_, ws_, bs_):
        out, u = JF.hand_trunk_sdf_u(e_, tuple(ws_), tuple(bs_), jmeta, 32, True)
        return jnp.sum(out * dout) + jnp.sum(u * du)

    de, dws, dbs = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(e), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    return [np.asarray(x) for x in [de, *dws, *dbs]]


def _torch_vjp(tmeta, ws, bs, e, dout, du):
    et, wt, bt = t(e, True), [t(w, True) for w in ws], [t(b, True) for b in bs]
    out, u = TF.hand_trunk_sdf_u(et, wt, bt, tmeta)
    (out * t(dout)).sum().add((u * t(du)).sum()).backward()
    return [x.grad.numpy() for x in [et, *wt, *bt]]


@pytest.mark.parametrize("n", [40, 100])
def test_forward_matches_jax_f32(n):
    jmeta, tmeta = _metas("f32")
    ws, bs, e, _, _ = _inputs(n)
    want = JF.hand_trunk_sdf_u(jnp.asarray(e), tuple(map(jnp.asarray, ws)),
                               tuple(map(jnp.asarray, bs)), jmeta, 32, True)
    spec = JF.trunk_sdf_u_ref(jnp.asarray(e), list(map(jnp.asarray, ws)),
                              list(map(jnp.asarray, bs)), jmeta)
    with torch.no_grad():
        got = TF.hand_trunk_sdf_u(t(e), [t(w) for w in ws], [t(b) for b in bs], tmeta)
        got_spec = TF.trunk_sdf_u_ref(t(e), [t(w) for w in ws], [t(b) for b in bs], tmeta)
    for g, gs, w, ws_ in zip(got, got_spec, want, spec):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws_), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [40, 100])
def test_vjp_matches_jax_f32(n):
    jmeta, tmeta = _metas("f32")
    ws, bs, e, dout, du = _inputs(n, seed=4)
    want = _jax_vjp(jmeta, ws, bs, e, dout, du)
    got = _torch_vjp(tmeta, ws, bs, e, dout, du)
    spec = JF.trunk_sdf_u_bwd_ref(jnp.asarray(e), list(map(jnp.asarray, ws)),
                                  list(map(jnp.asarray, bs)), jmeta, jnp.asarray(dout),
                                  jnp.asarray(du))
    de, dws, dbs = TF.trunk_sdf_u_bwd_ref(t(e), [t(w) for w in ws], [t(b) for b in bs], tmeta,
                                          t(dout), t(du))
    got_spec = [x.numpy() for x in [de, *dws, *dbs]]
    want_spec = [np.asarray(x) for x in [spec[0], *spec[1], *spec[2]]]
    assert len(got) == len(want) == 1 + 2 * DIMS["n_layers"]
    for i, (g, w, gs, ws_) in enumerate(zip(got, want, got_spec, want_spec)):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-3, rtol=0, err_msg=f"leaf {i}")
        np.testing.assert_allclose(gs / scale, ws_ / scale, atol=1e-3, rtol=0,
                                   err_msg=f"spec leaf {i}")


def _close_in_range(got, want, median=1e-4):
    err = np.abs(got - want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.median(err) <= median * scale and err.max() <= 1e-2 * scale, (
        f"median {np.median(err) / scale:.2e}, max {err.max() / scale:.2e} of {scale:.3e}")


@pytest.mark.parametrize("n", [40, 100])
def test_bf16_matches_jax(n):
    jmeta, tmeta = _metas("bf16")
    ws, bs, e, dout, du = _inputs(n, seed=2)
    want = JF.hand_trunk_sdf_u(jnp.asarray(e), tuple(map(jnp.asarray, ws)),
                               tuple(map(jnp.asarray, bs)), jmeta, 32, True)
    with torch.no_grad():
        got = TF.hand_trunk_sdf_u(t(e), [t(w) for w in ws], [t(b) for b in bs], tmeta)
    for g, w in zip(got, want):
        _close_in_range(g.numpy(), np.asarray(w))
    skip_dw = 1 + DIMS["skip"]
    for i, (g, w) in enumerate(zip(_torch_vjp(tmeta, ws, bs, e, dout, du),
                                   _jax_vjp(jmeta, ws, bs, e, dout, du))):
        _close_in_range(g, w, 1e-3 if i == skip_dw else 1e-4)


def test_frozen_weights_give_the_same_de_without_dw(monkeypatch):
    _, tmeta = _metas("bf16")
    ws, bs, e, dout, du = _inputs(40, seed=5)
    seen = []
    real = TF.hand_trunk_sdf_u_plain_bwd

    def spy(*a, **k):
        seen.append(a[-1] if len(a) > 4 else k.get("want_dw", True))
        return real(*a, **k)

    monkeypatch.setattr(TF, "hand_trunk_sdf_u_plain_bwd", spy)
    full = _torch_vjp(tmeta, ws, bs, e, dout, du)
    et, wt, bt = t(e, True), [t(w) for w in ws], [t(b) for b in bs]
    out, u = TF.hand_trunk_sdf_u(et, wt, bt, tmeta)
    (out * t(dout)).sum().add((u * t(du)).sum()).backward()
    assert seen == [True, False]
    assert all(x.grad is None for x in wt + bt)
    np.testing.assert_array_equal(et.grad.numpy(), full[0])


def test_unused_output_has_a_zero_cotangent():
    """Only u reaches the loss: the backward takes dout = 0."""
    _, tmeta = _metas("f32")
    ws, bs, e, _, du = _inputs(40, seed=6)
    et = t(e, True)
    _out, u = TF.hand_trunk_sdf_u(et, [t(w) for w in ws], [t(b) for b in bs], tmeta)
    (u * t(du)).sum().backward()
    pack = TF.pack_trunk_weights([t(w) for w in ws], [t(b) for b in bs], tmeta)
    want, _, _ = TF.hand_trunk_sdf_u_plain_bwd(t(e), pack, torch.zeros((40, DIMS["d_out"])),
                                               t(du), want_dw=False)
    np.testing.assert_array_equal(et.grad.numpy(), want.numpy())
