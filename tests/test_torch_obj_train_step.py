"""One object train step of the port from a train state carried over from
the JAX package (train_state_from_jax after two JAX make_obj_train_step
steps: params, Adam moments, update count) against the JAX package's
next step: metrics and grad_norm at rtol 1e-4 (measured <= 1.4e-6), the
updated params within 0.05 of the step's learning rate (measured 3.3e-4
of it).  f32 trunks (the object conf's, no clip), refine_pose on with a
se3_refine table off the identity (the object's pose refinement is a
rot6d and a translation, which both frameworks compute alike to f32
rounding), the warmup's learning rate."""

import jax
import numpy as np
import torch

from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import train_state_from_jax
from test_torch_obj import RC, jax_batch, obj_batch, obj_configs, obj_params, torch_batch
from test_torch_train_step import _leaves

torch.set_num_threads(1)

HYPER = dict(learning_rate=1e-3, warm_up_end=5.0, end_iter=100, vgg_weight=0.0,
             refine_pose=True, batch_size=36)
# the third update runs at lr 1e-3 * 2/5 (warmup)
LR = 4e-4


def test_step_from_carried_state_matches_jax():
    jcfg, jccfg, tcfg, tccfg = obj_configs("f32")
    jp, _ = obj_params(jcfg, jccfg)
    jt = JO.TrainHyper(**HYPER)
    assert JO.resolve_grad_clip(jt, jcfg) == 0.0  # f32: no clip, as the conf trains
    jstep = jax.jit(JO.make_obj_train_step(jcfg, jccfg, JRenderConfig(**RC), jt))
    b = obj_batch()
    jb = jax_batch(b)
    state = JO.init_train_state(jp, jt)
    for _ in range(2):
        state, _ = jstep(state, jb, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(state, TO.TrainHyper(**HYPER), device="cpu")
    assert tstate["step"] == 2
    want_state, want = jstep(state, jb, jax.random.PRNGKey(0))
    tstep = TO.make_obj_train_step(tcfg, tccfg, RenderConfig(**RC), TO.TrainHyper(**HYPER))
    tstate, got = tstep(tstate, torch_batch(b))
    assert tstate["step"] == 3
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    moved = False
    for name, w, g in _leaves(want_state["params"], tstate["params"]):
        np.testing.assert_allclose(g, w, atol=0.05 * LR, rtol=0, err_msg=name)
        if name.startswith("['se3_refine']"):
            moved = not np.allclose(w, np.asarray(state["params"]["se3_refine"]))
    assert moved  # the pose refinement takes part in the step
