"""Shared setup of the port's pose-fitting parity tests
(test_torch_fit_*.py; it holds no tests): small hand and object nets made
by the JAX init functions with seeded noise, a fit batch through the hand
with the object beside it, and one fit step on either side."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from honerf_tpu.fit import single as JS
from honerf_tpu.models import ColorConfig as JColorConfig
from honerf_tpu.models import SDFConfig as JSDFConfig
from honerf_tpu.models import init_color_params, init_sdf_params
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_torch.data.datasets import get_bone_length
from honerf_torch.data.synthetic import icosphere, look_at_camera
from honerf_torch.fit import single as TS
from honerf_torch.models.fields import ColorConfig, SDFConfig
from honerf_torch.render import neus as TN
from honerf_torch.train.checkpoints import params_from_jax
from test_torch_parity import SMALL, configs, perturb, t

RC = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)
OBJ = dict(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), v_multires=6)
N_RAYS = 24


def close(got, want, tol):
    """|got - want| within tol of max(1, max |want|) (and tol relative)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def hand_nets(sdf_kw=SMALL, seed=0):
    """(JAX hand params, port hand params): test_torch_parity.net_params's
    net (seeded noise, the sdf row scaled and shifted so the field is
    +0.2 away from the hand and negative around its bones), calibrated
    with the port's field and pose (the JAX package's eager calls would
    take most of a test's time)."""
    from honerf_torch.hand import bone_transforms_from_mano_joints
    from honerf_torch.models.fields import sdf_hand_apply

    rng = np.random.default_rng(seed)
    jcfg, jccfg, tcfg, _ = configs(sdf_kw, "f32")
    tree = {"sdf": perturb(init_sdf_params(jax.random.PRNGKey(seed), jcfg), rng),
            "color": perturb(init_color_params(jax.random.PRNGKey(seed + 1), jccfg), rng),
            "variance": {"variance": np.float32(0.5)}}
    last = tree["sdf"]["layers"][-1]
    last["g"][0] *= -5.0
    _, tpose, joints = hand_pose_np()
    bt = bone_transforms_from_mano_joints(t(joints)[None])[0]
    p = t(joints.mean(0) + np.asarray([0.0, 0.0, 0.5], np.float32))[None]
    sdf = sdf_hand_apply(params_from_jax(tree, device="cpu")["sdf"], tcfg, p, bt, t(tpose))
    last["b"][0] -= float(sdf[0][0, 0]) - 0.2
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu")


def hand_pose_np(curl=0.3):
    """(bt_inv, t_pose, joints) as numpy, bt_inv by the port."""
    from honerf_torch.data.synthetic import canonical_hand_joints
    from honerf_torch.hand import bone_transforms_from_mano_joints

    joints = canonical_hand_joints(curl)
    bt = bone_transforms_from_mano_joints(t(joints)[None])[0].numpy()
    return bt, canonical_hand_joints(0.0), joints


def obj_nets(seed=3):
    """(JAX obj params, port obj params, JAX sdf/color configs, port ones)."""
    rng = np.random.default_rng(seed)
    ckw = dict(kind="obj", d_feature=OBJ["d_out"] - 1, d_hidden=OBJ["d_hidden"], n_layers=2,
               v_multires=OBJ["v_multires"])
    jcfg, jccfg = JSDFConfig(kind="obj", **OBJ), JColorConfig(**ckw)
    tree = {"sdf": perturb(init_sdf_params(jax.random.PRNGKey(seed), jcfg), rng),
            "color": perturb(init_color_params(jax.random.PRNGKey(seed + 1), jccfg), rng),
            "variance": {"variance": np.float32(0.4)}}
    return (jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu"), jcfg, jccfg,
            SDFConfig(kind="obj", **OBJ), ColorConfig(**ckw))


def frame(seed=0):
    """A fit batch as numpy: rays of a look-at camera through the hand,
    the object beside it, noisy initial estimates and the ground truth."""
    bt, tpose, joints = hand_pose_np()
    rng = np.random.default_rng(seed)
    center = joints.mean(0)
    R, T = look_at_camera(np.asarray(center + [0.0, 0.2, -0.9]), center)
    verts, _ = icosphere(0.05, subdiv=1)
    To = (center + [0.0, -0.02, 0.06]).astype(np.float32)
    g = np.linspace(-0.1, 0.1, 6, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g[:4]), -1).reshape(-1, 2)
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        rays_xy=f(xy), true_rgb=f(rng.uniform(0, 1, (N_RAYS, 3))),
        true_mask=f(rng.uniform(0, 1, (N_RAYS, 1)) > 0.4), cam_R=f(R), cam_T=f(T),
        focal=f([3.0, 3.0]), principal=f([0.0, 0.0]),
        joints_pred=f(joints + rng.normal(0, 0.003, joints.shape)),
        bone_length=f(get_bone_length(tpose)), t_pose_21=f(tpose), Ro_pred=f(np.eye(3)),
        To_pred=f(To + rng.normal(0, 0.004, 3)), obj_verts=f(verts), gt_joint3d=f(joints),
        Ro_gt=f(np.eye(3)), To_gt=f(To))


@functools.lru_cache(maxsize=None)
def setup():
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, "f32")
    jhand, thand = hand_nets()
    jobj, tobj, jocfg, joccfg, tocfg, toccfg = obj_nets()
    return dict(jnets={"hand": jhand, "obj": jobj}, tnets={"hand": thand, "obj": tobj},
                jcfgs=(jcfg, jccfg, jocfg, joccfg), tcfgs=(tcfg, tccfg, tocfg, toccfg))


def pose0(seed=1):
    """The six pose tensors a little away from their start: at the start
    the refined root joint equals its prediction up to rounding, so the
    joint term's unit vector (d / |d| at |d| ~ 1e-8) is rounding noise on
    both sides and would swamp the comparison."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.02 * rng.normal(size=np.shape(v))).astype(np.float32)
            for k, v in JS.init_pose_params().items()}


def jax_step(s, fit_type, b):
    """One JAX fit step: (metrics, {key: gradient}, pose after Adam)."""
    jcfg, jccfg, jocfg, joccfg = s["jcfgs"]
    fcfg = JS.FitHyper(batch_size=N_RAYS, fit_type=fit_type)
    step, opt = JS.make_single_fit_step(s["jnets"], jcfg, jccfg, jocfg, joccfg,
                                        JRenderConfig(**RC), fcfg)
    pose = {k: jnp.asarray(v) for k, v in pose0().items()}
    (pose1, opt_state), m = jax.jit(step)((pose, opt.init(pose)),
                                          {k: jnp.asarray(v) for k, v in b.items()},
                                          jax.random.PRNGKey(0))
    grads = {k: np.asarray(opt_state.inner_states[k].inner_state[0].mu[k]) / 0.1 for k in pose}
    return ({k: float(v) for k, v in m.items()}, grads,
            {k: np.asarray(v) for k, v in pose1.items()})


def port_step(s, fit_type, b, fine):
    tcfg, tccfg, tocfg, toccfg = s["tcfgs"]
    fcfg = TS.FitHyper(batch_size=N_RAYS, fit_type=fit_type)
    step = TS.make_single_fit_step(s["tnets"], tcfg, tccfg, tocfg, toccfg,
                                   TN.RenderConfig(**RC), fcfg, fused_fine=fine)
    state = TS.init_fit_state("cpu")
    with torch.no_grad():
        for k, v in pose0().items():
            state["pose"][k].copy_(t(v))
    state, m = step(state, {k: t(v) for k, v in b.items()})
    pose = state["pose"]
    return ({k: float(v) for k, v in m.items()},
            {k: pose[k].grad.numpy() for k in TS.POSE_KEYS},
            {k: pose[k].detach().numpy() for k in TS.POSE_KEYS})


# -- the video step (test_torch_fit_video.py) and the frame-batched step
# (test_torch_fit_batched.py) --

N_FRAMES = 6
SHIFT = 0.01   # each frame's hand and object 1 cm further along x


def seq_frame(i):
    """Frame i of a sequence: frame(seed=i) with its hand and object moved
    by i x SHIFT (a different pose a frame, one camera), and an object
    whose every tenth vertex (the stable term's) is a stable_verts point."""
    b = frame(seed=i)
    move = np.asarray([i * SHIFT, 0.0, 0.0], np.float32)
    for k in ("joints_pred", "gt_joint3d", "To_pred", "To_gt"):
        b[k] = (b[k] + move).astype(np.float32)
    verts = b["obj_verts"].copy()
    verts[0::10][:5] = stable_verts()
    b["obj_verts"] = verts
    return b


def stable_verts():
    """Five object-local points near the hand's wrist and thumb, each
    inside the hand (sdf < -0.005) in some frames of the first windows at
    tables0 and outside (> 0.005) in others: points of a 5 cm grid around
    joints 0, 1, 2, 5 and 9 picked by their sdf in every frame."""
    _, _, joints = hand_pose_np()
    g = np.linspace(-0.04, 0.04, 5)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cands = (joints[[0, 1, 2, 5, 9]][:, None, :] + grid[None]).reshape(-1, 3)
    return (cands[[13, 18, 19, 28, 54]] - frame(seed=0)["To_pred"]).astype(np.float32)


WINDOW_SHARED = ("cam_R", "cam_T", "focal", "principal", "obj_verts")


def window_batch(idx, anchor=1.0):
    """The video step's batch (numpy) of the window `idx` of an
    N_FRAMES-frame sequence: per-frame arrays stacked in frame order, one
    camera and object."""
    frames = [seq_frame(i) for i in idx]
    b = {k: np.stack([f[k] for f in frames]) for k in frames[0] if k not in WINDOW_SHARED}
    b.update({k: frames[0][k] for k in WINDOW_SHARED})
    b["index"] = np.asarray(idx, np.int32)
    b["anchor_enabled"] = np.float32(anchor)
    return b


def tables0(seed=4):
    """The six tables a little away from their start (as pose0)."""
    from honerf_tpu.fit import video as JV

    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + 0.02 * rng.normal(size=np.shape(v))).astype(np.float32)
            for k, v in JV.init_video_tables(N_FRAMES).items()}


def jax_video_steps(s, fit_type, batches):
    """JAX video steps from tables0 on the batches in turn: per step
    (metrics, {table: gradient}, tables after Adam); the gradient read as
    the change of Adam's mu (mu' = 0.9 mu + 0.1 g)."""
    from honerf_tpu.fit import video as JV

    jcfg, jccfg, jocfg, joccfg = s["jcfgs"]
    fcfg = JS.FitHyper(batch_size=N_RAYS, fit_type=fit_type)
    step, opt = JV.make_video_fit_step(s["jnets"], jcfg, jccfg, jocfg, joccfg,
                                       JRenderConfig(**RC), fcfg, N_FRAMES)
    step = jax.jit(step)
    tables = {k: jnp.asarray(v) for k, v in tables0().items()}
    state = (tables, opt.init(tables))
    mu = {k: np.zeros(np.shape(v), np.float32) for k, v in tables.items()}
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        new_mu = {k: np.asarray(state[1].inner_states[k].inner_state[0].mu[k]) for k in mu}
        grads = {k: (new_mu[k] - 0.9 * mu[k]) / 0.1 for k in mu}
        mu = new_mu
        out.append(({k: float(v) for k, v in m.items()}, grads,
                    {k: np.asarray(v) for k, v in state[0].items()}))
    return out


def port_batch(b, device="cpu"):
    return {k: (torch.as_tensor(v, dtype=torch.int64, device=device) if k == "index"
                else torch.as_tensor(np.asarray(v, np.float32), device=device))
            for k, v in b.items()}


def port_video_steps(s, fit_type, batches, fine=None):
    """The port's video steps, as jax_video_steps."""
    from honerf_torch.fit import video as TV

    tcfg, tccfg, tocfg, toccfg = s["tcfgs"]
    fcfg = TS.FitHyper(batch_size=N_RAYS, fit_type=fit_type)
    step = TV.make_video_fit_step(s["tnets"], tcfg, tccfg, tocfg, toccfg, TN.RenderConfig(**RC),
                                  fcfg, N_FRAMES, fused_fine=fine)
    state = TV.init_video_state(N_FRAMES, "cpu")
    with torch.no_grad():
        for k, v in tables0().items():
            state["tables"][k].copy_(t(v))
    out = []
    for b in batches:
        state, m = step(state, port_batch(b))
        tab = state["tables"]
        out.append(({k: float(v) for k, v in m.items()},
                    {k: tab[k].grad.numpy().copy() for k in TS.POSE_KEYS},
                    {k: tab[k].detach().numpy().copy() for k in TS.POSE_KEYS}))
    return out
