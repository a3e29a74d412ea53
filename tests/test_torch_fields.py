"""honerf_torch fields and checkpoints against the JAX package (f32 on
the CPU, same weights through params_from_jax).  Tolerances: 1e-5 on
values (f32, differing only in summation order, as test_models.py's
flat-vs-bone-major check), 1e-4 on spatial gradients (autograd vs jax.vjp
through softplus(beta=100))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.models import fields as JF
from honerf_tpu.train.checkpoints import save_checkpoint
from honerf_torch.models import fields as TF
from honerf_torch.models.embedding import channel_major_dest, positional_encoding
from honerf_torch.train.checkpoints import load_checkpoint, params_from_jax
from test_torch_parity import SMALL, WIDE_EMB, configs, hand_pose, net_params, points_near, t

torch.set_num_threads(1)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "bone_major"])
@pytest.mark.parametrize("sdf_kw", [SMALL, WIDE_EMB], ids=["small", "wide_emb"])
def test_sdf_hand_apply_matches_jax(sdf_kw, flat):
    jcfg, _, tcfg, _ = configs(sdf_kw)
    jp, tp = net_params(sdf_kw)
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, 64)
    want, want_e, _, _ = JF.sdf_hand_apply(jp["sdf"], jcfg._replace(flat_embedding=flat),
                                           jnp.asarray(pts), jnp.asarray(bt), jnp.asarray(tpose))
    got, got_e, _, _ = TF.sdf_hand_apply(tp["sdf"], tcfg._replace(flat_embedding=flat),
                                         t(pts), t(bt), t(tpose))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_value_feat_grad_and_color_match_jax():
    jcfg, jccfg, tcfg, tccfg = configs(SMALL)
    jp, tp = net_params(SMALL)
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, 64, seed=1)
    js, jf, je, _, _, jg = JF.sdf_hand_value_feat_grad(
        jp["sdf"], jcfg, jnp.asarray(pts), jnp.asarray(bt), jnp.asarray(tpose))
    with torch.no_grad():  # eval use: the gradient is returned, not differentiated
        ts, tf, te, _, _, tg = TF.sdf_hand_value_feat_grad(tp["sdf"], tcfg, t(pts), t(bt),
                                                           t(tpose))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)
    want_c = JF.color_hand_apply(jp["color"], jccfg, je, jf, jg)
    got_c = TF.color_hand_apply(tp["color"], tccfg, te, tf, tg)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)


def test_variance_and_pe_match_jax():
    x = np.random.default_rng(2).normal(size=(7, 3)).astype(np.float32)
    from honerf_tpu.models.embedding import positional_encoding as jpe
    from honerf_tpu.models.embedding import channel_major_dest as jdest

    np.testing.assert_allclose(positional_encoding(t(x), 4).numpy(), np.asarray(jpe(jnp.asarray(x), 4)),
                               atol=1e-6)
    np.testing.assert_array_equal(channel_major_dest(10, 7), jdest(10, 7))
    v = {"variance": np.float32(0.3)}
    np.testing.assert_allclose(float(TF.variance_apply(params_from_jax(v, device="cpu"))),
                               float(JF.variance_apply(v)), rtol=1e-6)


def test_params_from_jax_roundtrips_checkpoint(tmp_path):
    """An npz written by the JAX package's save_checkpoint loads into the
    port's tree with identical values and structure."""
    jp, _ = net_params(SMALL)
    path = str(tmp_path / "ckpt_000001.npz")
    save_checkpoint(path, {"params": jp, "iter_step": np.int64(1)})
    tree = load_checkpoint(path)
    assert int(tree["iter_step"]) == 1
    port = params_from_jax(tree["params"], device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(port["sdf"]["layers"]) == len(jp["sdf"]["layers"])
    for path_j, leaf in flat_j:
        node = port
        for k in path_j:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_torch_init_matches_shapes():
    """The port's own (torch.Generator) init builds the JAX tree's shapes."""
    jcfg, jccfg, tcfg, tccfg = configs(SMALL)
    g = torch.Generator().manual_seed(0)
    tp = TF.init_sdf_params(g, tcfg, device="cpu")
    jp = JF.init_sdf_params(jax.random.PRNGKey(0), jcfg)
    for a, b in zip(tp["layers"], jp["layers"]):
        for k in ("v", "g", "b"):
            assert tuple(a[k].shape) == tuple(b[k].shape)
    tc = TF.init_color_params(g, tccfg, device="cpu")
    jc = JF.init_color_params(jax.random.PRNGKey(1), jccfg)
    assert [tuple(l["v"].shape) for l in tc["layers"]] == [tuple(l["v"].shape) for l in jc["layers"]]
