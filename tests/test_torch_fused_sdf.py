"""K4, the object SDF: the port's plain version (what the CUDA kernel is
held against on the card) against the JAX package's Pallas kernel in
interpret mode and against its XLA forward, and the weight pack against
the JAX pack, on the same seeded weights and points (CPU).

Tolerances (measured on these seeds):
  * against the Pallas kernel (`_make_kernel`, interpret mode): both round
    the same operands to bf16 with f32 sums, in another order, so a rare
    activation rounds to the neighbouring bf16 value: max |err| within
    1e-3 of max(1, max |want|) (measured 5.8e-4 at full width), median
    within 1e-6 (f32 noise, measured <= 6e-8);
  * against `sdf_obj_apply` (f32 XLA): the JAX suite's own 5e-3 abs /
    1e-2 rel for its bf16 kernel (measured 2.5e-3 abs);
  * the pack: bit for bit on the unpadded block where both frameworks
    hold the same f32 weights (no weight norm); with weight norm the two
    f32 row norms differ in the last bit, which flips a bf16 rounding now
    and then (1 element of ~600k at full width), by one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.models import SDFConfig as JSDFConfig
from honerf_tpu.models import init_sdf_params, sdf_obj_apply
from honerf_tpu.ops import fused_sdf as JF
from honerf_torch.models.fields import SDFConfig
from honerf_torch.ops import fused_sdf as FS
from honerf_torch.train.checkpoints import params_from_jax
from test_pallas_ops import fused_eval
from test_torch_parity import perturb

torch.set_num_threads(1)

NETS = {"full": {},
        "small": dict(n_layers=4, d_hidden=128, d_out=129, skip_in=(2,), v_multires=6)}


def _setup(net, n, seed=0, **extra):
    kw = dict(NETS[net], **extra)
    jcfg = JSDFConfig(kind="obj", **kw)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(jnp.asarray, perturb(init_sdf_params(jax.random.PRNGKey(seed), jcfg), rng))
    pts = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    return jcfg, SDFConfig(kind="obj", **kw), jp, pts


@pytest.mark.parametrize("net,n", [("full", 64), ("full", 700), ("small", 100)])
def test_plain_matches_pallas_interpret(net, n):
    jcfg, cfg, jp, pts = _setup(net, n)
    want = np.asarray(fused_eval(jp, jcfg, jnp.asarray(pts)))
    fused = FS.FusedObjSDF(params_from_jax(jp, device="cpu"), cfg)
    before = FS.KERNEL.launches
    got = fused(torch.as_tensor(pts)).numpy()
    assert FS.KERNEL.launches == before  # the CPU runs the plain version
    err = np.abs(got - want) / max(1.0, float(np.abs(want).max()))
    assert err.max() <= 1e-3 and np.median(err) <= 1e-6, (err.max(), np.median(err))


@pytest.mark.parametrize("net", list(NETS))
def test_plain_matches_xla_forward(net):
    jcfg, cfg, jp, pts = _setup(net, 300, seed=1)
    want = np.asarray(sdf_obj_apply(jp, jcfg, jnp.asarray(pts))[:, 0])
    fused = FS.FusedObjSDF(params_from_jax(jp, device="cpu"), cfg)
    np.testing.assert_allclose(fused(torch.as_tensor(pts)).numpy(), want, atol=5e-3, rtol=1e-2)


def test_scale_divides_the_sdf():
    jcfg, cfg, jp, pts = _setup("small", 50, scale=2.5)
    want = np.asarray(fused_eval(jp, jcfg, jnp.asarray(pts)))
    got = FS.FusedObjSDF(params_from_jax(jp, device="cpu"), cfg)(torch.as_tensor(pts)).numpy()
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("weight_norm", [False, True])
def test_pack_matches_jax(weight_norm):
    jcfg, cfg, jp, _ = _setup("full", 1, weight_norm=weight_norm)
    jws, jbs, _ = JF.pack_obj_sdf_weights(jp, jcfg)
    ws, bs, meta = FS.pack_obj_sdf_weights(params_from_jax(jp, device="cpu"), cfg)
    E, n = cfg.input_width, len(ws)
    assert meta.out_widths == (256, 256, 256, 193, 256, 256, 256, 256, 1)
    flips = total = 0
    for l in range(n):
        jw = np.asarray(jws[l].astype(jnp.float32))
        w = ws[l].float().numpy()
        d_out = meta.out_widths[l]
        if l in meta.skips:
            d_prev = meta.out_widths[l - 1]
            ap = w.shape[0] - meta.Ep
            pairs = [(w[:d_prev, :d_out], jw[:d_prev, :d_out]),
                     (w[ap:ap + E, :d_out], jw[d_prev:d_prev + E, :d_out])]
            assert not w[d_prev:ap].any() and not w[ap + E:].any()
        else:
            d_in = E if l == 0 else meta.out_widths[l - 1]
            pairs = [(w[:d_in, :d_out], jw[:d_in, :d_out])]
            assert not w[d_in:].any()
        assert not w[:, d_out:].any()
        np.testing.assert_array_equal(bs[l].numpy()[:d_out], np.asarray(jbs[l])[0, :d_out])
        for a, b in pairs:
            diff = a != b
            flips += int(diff.sum())
            total += a.size
            # a flip is one bf16 ulp: 2^-7 of the value's binade
            ulp = 2.0 ** (np.floor(np.log2(np.abs(b[diff]))) - 7)
            assert np.all(np.abs(a[diff] - b[diff]) <= ulp)
    if weight_norm:
        assert flips <= 1e-5 * total, flips
    else:
        assert flips == 0
