"""The object model's nets and render against the JAX package on the same
seeded weights, points and rays (CPU): sdf_obj_apply, color_obj_apply,
sdf_obj_value_feat_grad, and make_obj_field + render_single through
obj_render_from_batch (perturb 0, a refined pose off the identity).

Tolerances, of max(1, max |want|): f32, 2e-4 (the renderer tolerance;
measured <= 5.4e-7 on the nets, <= 1e-5 on the render).  bf16 trunks:
both frameworks round the same operands, but JAX's bf16 matmul and the
port's f32 product of bf16-rounded operands sum in another order, which
flips a rare activation's bf16 rounding: nets within 2e-2 (measured
5.7e-3); the render's color, weight_sum and eikonal term within 1e-2
(measured 4.8e-3).  In bf16 a flip in the up-sample ladder moves a fine
sample, so the per-sample outputs (cdf_fine, weight_max; measured 0.21)
are compared in f32 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.data.synthetic import look_at_camera
from honerf_tpu.models import ColorConfig as JColorConfig
from honerf_tpu.models import SDFConfig as JSDFConfig
from honerf_tpu.models import fields as JFd
from honerf_tpu.models import init_color_params, init_sdf_params
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.models import fields as TFd
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import params_from_jax
from test_torch_parity import perturb, t

torch.set_num_threads(1)

SDF = dict(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), v_multires=6)
COLOR = dict(d_feature=64, n_layers=2, d_hidden=64, v_multires=6, r_multires=4)
RC = dict(n_samples=12, n_importance=12, up_sample_steps=2, perturb=0.0)
TOL = {"f32": 2e-4, "bf16": 2e-2}
RENDER_TOL = {"f32": 2e-4, "bf16": 1e-2}


def obj_configs(dtype="f32", sdf_kw=SDF, color_kw=COLOR):
    """(JAX sdf, JAX color, port sdf, port color) configs of one object net."""
    return (JSDFConfig(kind="obj", trunk_dtype=dtype, **sdf_kw),
            JColorConfig(kind="obj", trunk_dtype=dtype, **color_kw),
            TFd.SDFConfig(kind="obj", trunk_dtype=dtype, **sdf_kw),
            TFd.ColorConfig(kind="obj", trunk_dtype=dtype, **color_kw))


def obj_params(jcfg, jccfg, seed=0, n_views=2):
    """(JAX params, port params) of one object model, perturbed so every
    embedding column is live, with a se3_refine table off the identity."""
    rng = np.random.default_rng(seed)
    se3 = np.zeros((n_views, 9), np.float32)
    se3[:, 0] = se3[:, 3] = 1.0
    se3 += rng.normal(0, 0.05, se3.shape).astype(np.float32)
    tree = {"sdf": perturb(init_sdf_params(jax.random.PRNGKey(seed), jcfg), rng),
            "color": perturb(init_color_params(jax.random.PRNGKey(seed + 1), jccfg), rng),
            "variance": {"variance": np.float32(0.3)},
            "se3_refine": se3}
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu")


def obj_batch(n_side=6, seed=0, index=1):
    """An object train batch as numpy: a grid of rays from a look-at camera
    at the origin, a small object rotation and offset, seeded colors and
    mask."""
    R, T = look_at_camera(np.asarray([0.0, 0.2, -0.9]), np.zeros(3))
    g = np.linspace(-0.15, 0.15, n_side, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    th = 0.3
    Ro = np.asarray([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                    np.float32)
    rng = np.random.default_rng(seed)
    n = xy.shape[0]
    return dict(cam_R=R, cam_T=T, focal=np.asarray([3.0, 3.0], np.float32),
                principal=np.zeros(2, np.float32), rays_xy=xy, Ro=Ro,
                To=np.asarray([0.02, -0.01, 0.03], np.float32),
                true_rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                true_mask=(rng.uniform(0, 1, (n, 1)) > 0.4).astype(np.float32),
                index=np.int32(index))


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: (int(v) if k == "index" else t(v)) for k, v in b.items()}


def _close(got, want, tol, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max() / max(1.0, np.abs(want).max())
    assert err <= tol, f"{what}: {err:.2e} > {tol}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_nets_match_jax(dtype):
    jcfg, jccfg, tcfg, tccfg = obj_configs(dtype)
    jp, tp = obj_params(jcfg, jccfg)
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(200, 3)) * 0.3).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tol = TOL[dtype]

    @jax.jit
    def jax_nets(p, x, d):
        sdf, feat, grad = JFd.sdf_obj_value_feat_grad(p["sdf"], jcfg, x)
        return (JFd.sdf_obj_apply(p["sdf"], jcfg, x), sdf, feat, grad,
                JFd.color_obj_apply(p["color"], jccfg, x, d, feat, grad))

    want = jax_nets(jp, jnp.asarray(pts), jnp.asarray(dirs))
    _close(TFd.sdf_obj_apply(tp["sdf"], tcfg, t(pts)).detach().numpy(), want[0], tol,
           "sdf_obj_apply")
    got = TFd.sdf_obj_value_feat_grad(tp["sdf"], tcfg, t(pts))
    for what, g, w in zip(("sdf", "feat", "grad"), got, want[1:4]):
        _close(g.detach().numpy(), w, tol, what)
    feat, grad = np.asarray(want[2]), np.asarray(want[3])
    _close(TFd.color_obj_apply(tp["color"], tccfg, t(pts), t(dirs), t(feat), t(grad))
           .detach().numpy(), want[4], tol, "color_obj_apply")


def test_full_width_sdf_matches_jax():
    jcfg, _, tcfg, _ = obj_configs(sdf_kw={}, color_kw={})
    jp, tp = obj_params(jcfg, obj_configs(color_kw={})[1])
    pts = (np.random.default_rng(4).normal(size=(64, 3)) * 0.3).astype(np.float32)
    want = jax.jit(lambda p, x: JFd.sdf_obj_apply(p, jcfg, x))(jp["sdf"], jnp.asarray(pts))
    _close(TFd.sdf_obj_apply(tp["sdf"], tcfg, t(pts)).detach().numpy(), want, TOL["f32"],
           "full width")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_render_matches_jax(dtype):
    jcfg, jccfg, tcfg, tccfg = obj_configs(dtype)
    jp, tp = obj_params(jcfg, jccfg)
    b = obj_batch()
    hyper = dict(vgg_weight=0.0, refine_pose=True)
    want = jax.jit(lambda p, jb: JO.obj_render_from_batch(
        p, jcfg, jccfg, JRenderConfig(**RC), JO.TrainHyper(**hyper), jb, jax.random.PRNGKey(0)))(
            jp, jax_batch(b))
    with torch.no_grad():
        got = TO.obj_render_from_batch(tp, tcfg, tccfg, RenderConfig(**RC),
                                       TO.TrainHyper(**hyper), torch_batch(b))
    assert float(np.asarray(want["weight_sum"]).max()) > 0.1  # the rays meet the surface
    keys = ("color_fine", "weight_sum") + (("cdf_fine", "weight_max") if dtype == "f32" else ())
    for k in keys:
        _close(got[k].numpy(), want[k], RENDER_TOL[dtype], k)
    _close(float(got["gradient_error"]), float(want["gradient_error"]), RENDER_TOL[dtype],
           "gradient_error")


def test_eval_render_matches_jax():
    jcfg, jccfg, tcfg, tccfg = obj_configs()
    jp, tp = obj_params(jcfg, jccfg)
    b = {k: v for k, v in obj_batch().items() if k not in ("true_rgb", "true_mask")}
    rc = dict(RC, perturb=1.0)  # the eval render turns the jitter off
    want = jax.jit(JO.make_obj_eval_render(jcfg, jccfg, JRenderConfig(**rc), JO.TrainHyper()))(
        jp, jax_batch(b), jax.random.PRNGKey(0))
    got = TO.make_obj_eval_render(tcfg, tccfg, RenderConfig(**rc), TO.TrainHyper())(
        tp, torch_batch(b))
    for g, w in zip(got, want):
        assert not g.requires_grad
        _close(g.numpy(), w, RENDER_TOL["f32"], "eval render")


def test_refined_obj_pose_matches_jax():
    jcfg, jccfg, _, _ = obj_configs()
    jp, tp = obj_params(jcfg, jccfg)
    b = obj_batch()
    for refine in (True, False):
        want = JO.refined_obj_pose(jp, JO.TrainHyper(refine_pose=refine), jnp.asarray(b["Ro"]),
                                   jnp.asarray(b["To"]), 1)
        got = TO.refined_obj_pose(tp, TO.TrainHyper(refine_pose=refine), t(b["Ro"]), t(b["To"]), 1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-6)
