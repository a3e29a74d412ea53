"""One hand train step of the port from a train state carried over from
the JAX package (train_state_from_jax after two JAX steps: params, Adam
moments, update count) against the JAX package's next step: metrics,
grad_norm and the updated params.  f32 (the autograd field path), a
grad clip of 50 that binds (grad_norm ~900), the warmup's learning rate.

refine_pose is off here: with it on, both frameworks' f32 bt_inv differ
by ~1e-5 and the stiff random field turns that into ~1e-2 gradient
differences on small leaves (test_torch_train.py), which Adam's
normalisation then shows as updates that differ by up to ~1 lr.  The
pose-refinement path is compared on its own there."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from honerf_tpu.models.fields import init_se3_refine
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import train_state_from_jax
from test_torch_parity import SMALL, configs, jax_batch, net_params, torch_batch, train_batch

torch.set_num_threads(1)

RC = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)
HYPER = dict(learning_rate=1e-3, warm_up_end=5.0, end_iter=100, vgg_weight=0.0,
             refine_pose=False, grad_clip=50.0, batch_size=36)
# the third update runs at lr 1e-3 * 2/5 (warmup)
LR = 4e-4


def _leaves(jtree, ttree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        out.append((jax.tree_util.keystr(path), np.asarray(leaf), node.detach().numpy()))
    return out


def test_step_from_carried_state_matches_jax():
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, "f32")
    jp, _ = net_params(SMALL)
    params = dict(jp, se3_refine=init_se3_refine(2, "hand"))
    jt = JO.TrainHyper(**HYPER)
    jstep = jax.jit(JO.make_hand_train_step(jcfg, jccfg, JRenderConfig(**RC), jt))
    b = train_batch()
    jb = jax_batch(b)
    state = JO.init_train_state(params, jt)
    for _ in range(2):
        state, _ = jstep(state, jb, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(state, TO.TrainHyper(**HYPER), device="cpu")
    assert tstate["step"] == 2
    want_state, want = jstep(state, jb, jax.random.PRNGKey(0))
    tstep = TO.make_hand_train_step(tcfg, tccfg, RenderConfig(**RC), TO.TrainHyper(**HYPER))
    tstate, got = tstep(tstate, torch_batch(b))
    assert tstate["step"] == 3
    assert set(got) == set(want)
    assert float(want["grad_norm"]) > HYPER["grad_clip"]  # the clip binds
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    for name, w, g in _leaves(want_state["params"], tstate["params"]):
        np.testing.assert_allclose(g, w, atol=0.05 * LR, rtol=0, err_msg=name)
