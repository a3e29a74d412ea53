"""Frame-batched single fitting (honerf_torch.fit.single
make_batched_single_fit_step, init_pose_params_batched, final_poses_numpy)
on the CPU with G = 3 distinct frames (each frame's hand and object 1 cm
further along, its own estimates and pose), small nets, f32, fit type
'12':

  * against the JAX package's vmapped step (make_batched_single_fit_step):
    every metric (one a frame), the six (G, ...) gradients (from JAX's Adam
    state) and the poses after Adam, the autograd field within 2e-4 of
    max(1, max |want|) and 'full' (the plain versions of K2 and the frozen
    K3) within 1e-3;
  * against three runs of the port's own single step, one a frame, within
    1e-6: the frames share nothing;
  * final_poses_numpy: the JAX function's keys, shapes and dtypes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from honerf_tpu.fit import single as JS
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_torch.fit import single as TS
from honerf_torch.render import neus as TN
from torch_fit_common import N_RAYS, RC, close, pose0, seq_frame, setup, t

torch.set_num_threads(1)
G = 3


def frames():
    return [seq_frame(g) for g in range(G)]


def poses():
    return [pose0(seed=1 + g) for g in range(G)]


def stacked(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


@functools.lru_cache(maxsize=None)
def jax_batched():
    s = setup()
    jcfg, jccfg, jocfg, joccfg = s["jcfgs"]
    step, opt = JS.make_batched_single_fit_step(s["jnets"], jcfg, jccfg, jocfg, joccfg,
                                                JRenderConfig(**RC),
                                                JS.FitHyper(batch_size=N_RAYS, fit_type="12"))
    pose = {k: jnp.asarray(v) for k, v in stacked(poses()).items()}
    (pose1, opt_state), m = jax.jit(step)((pose, jax.vmap(opt.init)(pose)),
                                          {k: jnp.asarray(v) for k, v in stacked(frames()).items()},
                                          jax.random.split(jax.random.PRNGKey(0), G))
    grads = {k: np.asarray(opt_state.inner_states[k].inner_state[0].mu[k]) / 0.1 for k in pose}
    return ({k: np.asarray(v) for k, v in m.items()}, grads,
            {k: np.asarray(v) for k, v in pose1.items()})


def port_batched(fine):
    s = setup()
    tcfg, tccfg, tocfg, toccfg = s["tcfgs"]
    step = TS.make_batched_single_fit_step(s["tnets"], tcfg, tccfg, tocfg, toccfg,
                                           TN.RenderConfig(**RC),
                                           TS.FitHyper(batch_size=N_RAYS, fit_type="12"),
                                           fused_fine=fine)
    state = TS.init_batched_fit_state(G, "cpu")
    with torch.no_grad():
        for k, v in stacked(poses()).items():
            state["pose"][k].copy_(t(v))
    state, m = step(state, {k: t(v) for k, v in stacked(frames()).items()})
    pose = state["pose"]
    return ({k: v.numpy() for k, v in m.items()},
            {k: pose[k].grad.numpy() for k in TS.POSE_KEYS},
            {k: pose[k].detach().numpy() for k in TS.POSE_KEYS})


def test_batched_step_matches_jax():
    jm, jg, jpose = jax_batched()
    for fine, tol in ((None, 2e-4), ("full", 1e-3)):
        tm, tg, tpose = port_batched(fine)
        assert set(tm) == set(jm)
        for k in jm:
            assert tm[k].shape == (G,)
            close(tm[k], jm[k], tol)
        for k in TS.POSE_KEYS:
            close(tg[k], jg[k], tol)
            close(tpose[k], jpose[k], tol)
    # distinct frames: the rows' losses differ
    assert len(set(np.round(jm["loss"], 5))) == G


def test_batched_step_is_g_single_steps():
    s = setup()
    tcfg, tccfg, tocfg, toccfg = s["tcfgs"]
    tm, tg, tpose = port_batched(None)
    step = TS.make_single_fit_step(s["tnets"], tcfg, tccfg, tocfg, toccfg, TN.RenderConfig(**RC),
                                   TS.FitHyper(batch_size=N_RAYS, fit_type="12"))
    for g, (b, p) in enumerate(zip(frames(), poses())):
        state = TS.init_fit_state("cpu")
        with torch.no_grad():
            for k, v in p.items():
                state["pose"][k].copy_(t(v))
        state, m = step(state, {k: t(v) for k, v in b.items()})
        for k, v in m.items():
            close(tm[k][g], float(v), 1e-6)
        for k in TS.POSE_KEYS:
            close(tg[k][g], state["pose"][k].grad.numpy(), 1e-6)
            close(tpose[k][g], state["pose"][k].detach().numpy(), 1e-6)


def test_final_poses_numpy_matches_jax_layout():
    consts = stacked(frames())
    pose = stacked(poses())
    want = JS.final_poses_numpy({k: jnp.asarray(v) for k, v in pose.items()},
                                {k: jnp.asarray(v) for k, v in consts.items()}, 2)
    got = TS.final_poses_numpy({k: t(v) for k, v in pose.items()},
                               {k: t(v) for k, v in consts.items()}, 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            assert g[k].shape == v.shape and g[k].dtype == v.dtype, k
            close(g[k], v, 2e-4)
