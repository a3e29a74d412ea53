"""The pieces of the pose-fitting step (honerf_torch.render.dual, the
fitting losses, the fit's choice of kernels), plain versions on the CPU,
against the JAX package on the same seeded inputs and weights, small
nets, f32:

  * the losses (pose_l2, contact_loss, penetration_loss) within 1e-6;
  * the dual ladder's sample union within 2e-4 of its range, and
    render_dual on the same samples within 2e-4 of max(1, max |want|),
    perturb 0 (every output: colors, weight sums, per-sample sdf and
    gradients; the samples are shared because the inverse-CDF draws move
    a sample by ~1e-4 where the sdf is steep, which moves that sample's
    spatial gradient by ~1e-3 of its range on either side);
  * select_fit_kernels' table (honerf_tpu/fit/runner.py:253-287's choice,
    with the modes still to port raising on the card).
The step itself: test_torch_fit_step.py and test_torch_fit_step12.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.camera import Camera as JCamera
from honerf_tpu.camera import xy_to_ray_bundle as jax_rays
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.render import dual as JD
from honerf_tpu.render import losses as JL
from honerf_tpu.render import neus as JN
from honerf_torch.camera import Camera, xy_to_ray_bundle
from honerf_torch.fit import single as TS
from honerf_torch.render import dual as TD
from honerf_torch.render import losses as TL
from honerf_torch.render import neus as TN
from test_torch_parity import SMALL, configs, t
from torch_fit_common import RC, close, frame, hand_pose_np, setup

torch.set_num_threads(1)


def test_fit_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 50, 3)).astype(np.float32)
    b[:5] = a[:5]                                       # exact matches: the safe sqrt
    sh, so = (rng.normal(size=(2, 400)) * 0.01).astype(np.float32)
    close(TL.pose_l2(t(a), t(b)).numpy(), JL.pose_l2(jnp.asarray(a), jnp.asarray(b)), 1e-6)
    for name in ("contact_loss", "penetration_loss"):
        got = getattr(TL, name)(t(sh), t(so))
        assert float(got) > 0
        close(got.numpy(), getattr(JL, name)(jnp.asarray(sh), jnp.asarray(so)), 1e-6)
    # the safe sqrt's gradient at d = 0 is 0, not NaN
    x = t(a).requires_grad_(True)
    TL.pose_l2(x, t(a)).backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) == 0.0


def _scene():
    """(JAX render inputs as a function of the batch, the port's fields
    and rays): the dual scene of torch_fit_common.frame()."""
    s = setup()
    b = frame()
    jcfg, jccfg, jocfg, joccfg = s["jcfgs"]
    tcfg, tccfg, tocfg, toccfg = s["tcfgs"]
    bt = hand_pose_np()[0]

    def jax_scene(b):
        jrb = jax_rays(JCamera(R=b["cam_R"], T=b["cam_T"], focal=b["focal"],
                               principal=b["principal"]), b["rays_xy"])
        jo, jd = JN.rays_to_object_frame(jrb.origins, jrb.directions, b["Ro_pred"],
                                         b["To_pred"])
        return (JN.make_hand_field(s["jnets"]["hand"], jcfg, jccfg, jnp.asarray(bt),
                                   b["t_pose_21"]),
                JN.make_obj_field(s["jnets"]["obj"], jocfg, joccfg), jrb.origins,
                jrb.directions, jo, jd)

    trb = xy_to_ray_bundle(Camera(R=t(b["cam_R"]), T=t(b["cam_T"]), focal=t(b["focal"]),
                                  principal=t(b["principal"])), t(b["rays_xy"]))
    to, td = TN.rays_to_object_frame(trb.origins, trb.directions, t(b["Ro_pred"]),
                                     t(b["To_pred"]))
    port = (TN.make_hand_field(s["tnets"]["hand"], tcfg, tccfg, t(bt), t(b["t_pose_21"])),
            TN.make_obj_field(s["tnets"]["obj"], tocfg, toccfg), trb.origins, trb.directions,
            to, td)
    return jax_scene, {k: jnp.asarray(v) for k, v in b.items()}, port


def _jax_union(jax_scene, jb):
    def union(b):
        hf, of, o, d, jo, jd = jax_scene(b)
        z0 = JN.coarse_z_vals(jax.random.PRNGKey(0), o.shape[0], JRenderConfig(**RC), 0.4, 1.5)
        return JD.dual_hierarchical_z_vals(hf, of, o, d, jo, jd, z0, JRenderConfig(**RC))

    return np.asarray(jax.jit(union)(jb))


def test_dual_ladder_matches_jax():
    """The interleaved two-model ladder's sorted union: the inverse-CDF
    draws move a sample by up to ~1e-4 where the sdf is steep (the same
    sdf to ~1e-6, summed in another order), within 2e-4 of the range."""
    jax_scene, jb, (hf, of, o, d, to, td) = _scene()
    want = _jax_union(jax_scene, jb)
    z0 = TN.coarse_z_vals(None, o.shape[0], TN.RenderConfig(**RC), 0.4, 1.5)
    got = TD.dual_hierarchical_z_vals(hf, of, o, d, to, td, z0, TN.RenderConfig(**RC))
    assert got.shape == want.shape == (o.shape[0], RC["n_samples"] + 2 * RC["n_importance"])
    assert bool((got[:, 1:] >= got[:, :-1]).all()) and not got.requires_grad
    close(got.numpy(), want, 2e-4)


def test_render_dual_matches_jax(monkeypatch):
    """render_dual on the JAX ladder's samples (the ladder alone: above):
    every output within 2e-4 of max(1, max |want|)."""
    jax_scene, jb, (hf, of, o, d, to, td) = _scene()

    def jax_render(b):
        hf_, of_, o_, d_, jo, jd = jax_scene(b)
        return JD.render_dual(hf_, of_, JRenderConfig(**RC), jax.random.PRNGKey(0), o_, d_, jo,
                              jd, 0.4, 1.5)

    want = jax.jit(jax_render)(jb)
    union = t(_jax_union(jax_scene, jb))
    monkeypatch.setattr(TD, "dual_hierarchical_z_vals", lambda *a: union)
    got = TD.render_dual(hf, of, TN.RenderConfig(**RC), None, o, d, to, td, 0.4, 1.5)
    assert set(got) == set(want)
    for k in want:
        close(got[k].detach().numpy(), want[k], 2e-4)
    # the scene is not empty: the models leave weight on the rays
    assert float(got["weight_sum"].detach().max()) > 0.05


def test_fit_kernel_selection():
    _, _, tcfg, _ = configs(SMALL, "f32")
    bf16 = tcfg._replace(trunk_dtype="bf16")
    sel = TS.select_fit_kernels
    assert sel(None, None, tcfg, "cpu") == (False, None)
    assert sel(None, True, tcfg, "cpu") == (False, "full")
    assert sel(True, "xla", tcfg, "cpu") == (True, "pallas")
    assert sel(None, False, tcfg, "cpu") == (False, None)
    assert sel(None, None, tcfg, "cuda") == (True, "full")
    assert sel(False, "full", bf16, "cuda") == (False, "full")
    assert sel(None, "pallas", bf16, "cuda") == (True, "pallas")
    for fine in ("pallas", "full_nocolor"):
        assert sel(None, fine, tcfg, "cuda") == (True, fine)
    for cfg in (tcfg, bf16):
        with pytest.raises(NotImplementedError):
            sel(None, "xla", cfg, "cuda")
    with pytest.raises(ValueError):
        sel(None, "nope", tcfg, "cpu")
