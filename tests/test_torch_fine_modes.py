"""The hand model's fine pass under each kernel mode of train.fused_fine
('pallas': K5/K6 on the embedding; 'full_nocolor': K2/K3 without the
color net; 'full': K2/K3 with it), plain versions on the CPU, against the
JAX package:

the render loss (color + mask + eikonal, the eikonal a gradient of the
spatial gradient) of make_hand_field in each mode against JAX's
make_hand_field(fused_fine=mode, interpret=True), f32: loss within 1e-4
and every gradient leaf (sdf, color, variance) within 1e-3 of max(1, max
|want|), tests/test_fused_fine.py's bounds for JAX's fused pass against
its XLA path.  The train step and the runner in the 'pallas' mode:
test_torch_fine_modes_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.render import losses as JL
from honerf_tpu.render import neus as JN
from honerf_torch.render import losses as TL
from honerf_torch.render import neus as TN
from test_torch_parity import SMALL, configs, hand_pose, net_params, t

torch.set_num_threads(1)

RC = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)


def _rays(n_rays=8):
    _, _, joints = hand_pose()
    rng = np.random.default_rng(0)
    o = (joints.mean(0) + [0.0, 0.0, -0.9] + rng.normal(size=(n_rays, 3)) * 0.05)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]]), (n_rays, 1))
    rgb = rng.uniform(0, 1, (n_rays, 3))
    mask = (rng.uniform(0, 1, (n_rays, 1)) > 0.4).astype(np.float32)
    return [x.astype(np.float32) for x in (o, d, rgb, mask)]


def _jax_path(path):
    return [k.key if hasattr(k, "key") else k.idx for k in path]


def _node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", ["pallas", "full_nocolor", "full"])
def test_field_mode_matches_jax(mode):
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, "f32")
    jp, tp = net_params(SMALL)
    bt, tpose, _ = hand_pose()
    o, d, rgb, mask = _rays()

    def jloss(p):
        field = JN.make_hand_field(p, jcfg, jccfg, jnp.asarray(bt), jnp.asarray(tpose),
                                   fused_fine=mode, interpret=True)
        out = JN.render_single(field, JRenderConfig(**RC), jax.random.PRNGKey(0),
                               jnp.asarray(o), jnp.asarray(d), 0.4, 1.5)
        return (JL.masked_l1_color(out["color_fine"], jnp.asarray(rgb), jnp.asarray(mask))
                + JL.mask_bce(out["weight_sum"], jnp.asarray(mask)) + out["gradient_error"])

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = [(_jax_path(p), np.asarray(w))
              for p, w in jax.tree_util.tree_flatten_with_path(want)[0]]
    for _, x in [(k, _node(tp, k)) for k, _ in leaves]:
        x.requires_grad_(True)
    field = TN.make_hand_field(tp, tcfg, tccfg, t(bt), t(tpose), TN.HandPacks(fine=mode))
    out = TN.render_single(field, TN.RenderConfig(**RC), None, t(o), t(d), 0.4, 1.5)
    loss = (TL.masked_l1_color(out["color_fine"], t(rgb), t(mask))
            + TL.mask_bce(out["weight_sum"], t(mask)) + out["gradient_error"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-4, rtol=1e-4)
    assert len(leaves) == 2 * (len(tcfg.dims) - 1 + len(tccfg.dims) - 1) * 1.5 + 1
    for keys, w in leaves:
        g = _node(tp, keys).grad
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-3, rtol=0, err_msg=str(keys))
