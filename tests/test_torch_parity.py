"""Shared setup of the port's parity tests (it holds no tests): the same
seeded inputs and weights for the JAX package and honerf_torch (weights
made by the JAX init functions, perturbed with numpy so every embedding
column is live, then handed to the port through params_from_jax)."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from honerf_tpu.data.synthetic import canonical_hand_joints
from honerf_tpu.hand import bone_transforms_from_mano_joints
from honerf_tpu.models import (
    ColorConfig as JColorConfig,
    SDFConfig as JSDFConfig,
    init_color_params,
    init_sdf_params,
)
from honerf_torch.models.fields import ColorConfig, SDFConfig
from honerf_torch.train.checkpoints import params_from_jax

SMALL = dict(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), v_multires=3, r_multires=2)
# narrow trunk, full 1386-channel embedding
WIDE_EMB = dict(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), v_multires=10, r_multires=7)


def perturb(tree, rng, scale=0.05):
    """Add seeded noise to every leaf (geometric init zeroes most
    embedding columns, which would leave them untested)."""
    def one(x):
        x = np.asarray(x)
        mag = np.abs(x[x != 0]).mean() if np.any(x != 0) else 1.0
        return (x + scale * mag * rng.normal(size=x.shape)).astype(np.float32)
    return jax.tree.map(one, tree)


def configs(sdf_kw, trunk_dtype="f32"):
    """(JAX sdf, JAX color, port sdf, port color) configs of one net."""
    ckw = dict(kind="hand", d_feature=sdf_kw["d_out"] - 1, d_hidden=sdf_kw["d_hidden"],
               n_layers=2, v_multires=sdf_kw["v_multires"], r_multires=sdf_kw["r_multires"],
               trunk_dtype=trunk_dtype)
    return (JSDFConfig(kind="hand", trunk_dtype=trunk_dtype, **sdf_kw), JColorConfig(**ckw),
            SDFConfig(kind="hand", trunk_dtype=trunk_dtype, **sdf_kw), ColorConfig(**ckw))


def net_params(sdf_kw, seed=0, gain=-5.0, background=0.2):
    """(JAX params tree, port params tree) of the same hand net.  The sdf
    row is scaled and shifted so the field is +0.2 away from the hand
    and negative around its bones: rays through the hand then meet a
    well-conditioned surface."""
    from honerf_tpu.models.fields import sdf_hand_apply

    rng = np.random.default_rng(seed)
    jcfg, jccfg, _, _ = configs(sdf_kw)
    tree = {
        "sdf": perturb(init_sdf_params(jax.random.PRNGKey(seed), jcfg), rng),
        "color": perturb(init_color_params(jax.random.PRNGKey(seed + 1), jccfg), rng),
        "variance": {"variance": np.float32(0.5)},  # inv_s = e^5
    }
    bt, tpose, joints = hand_pose()
    last = tree["sdf"]["layers"][-1]
    last["g"][0] *= gain

    def sdf_at(offset):
        p = jnp.asarray(joints.mean(0) + np.asarray(offset, np.float32))[None]
        return float(sdf_hand_apply(tree["sdf"], jcfg, p, jnp.asarray(bt),
                                    jnp.asarray(tpose))[0][0, 0])

    last["b"][0] -= sdf_at([0.0, 0.0, 0.5]) - background
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu")


def hand_pose(curl=0.3):
    """(bt_inv, t_pose, joints) as numpy."""
    joints = canonical_hand_joints(curl)
    bt = np.asarray(bone_transforms_from_mano_joints(jnp.asarray(joints)[None])[0])
    return bt, canonical_hand_joints(0.0), joints


def points_near(joints, n, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * scale + joints.mean(0)).astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x, dtype=np.float32))


def train_batch(n_side=6, seed=0, index=1):
    """A hand train batch as numpy: a grid of rays through the hand from a
    look-at camera, seeded colors and mask, T-pose bone lengths."""
    from honerf_tpu.data.datasets import get_bone_length
    from honerf_tpu.data.synthetic import look_at_camera

    tpose, joints = canonical_hand_joints(0.0), canonical_hand_joints(0.3)  # hand_pose()'s
    R, T = look_at_camera(np.asarray([0.0, 0.2, -0.9]), joints.mean(0))
    g = np.linspace(-0.12, 0.12, n_side, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    n = xy.shape[0]
    return dict(cam_R=R, cam_T=T, focal=np.asarray([3.0, 3.0], np.float32),
                principal=np.zeros(2, np.float32), joints=joints, t_pose_21=tpose, rays_xy=xy,
                true_rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                true_mask=(rng.uniform(0, 1, (n, 1)) > 0.4).astype(np.float32),
                bone_length=get_bone_length(canonical_hand_joints(0.0)).astype(np.float32),
                index=np.int32(index))


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: (int(v) if k == "index" else t(v)) for k, v in b.items()}
