"""The hand model's 'pallas' fine pass (train.fused_fine = "pallas": K5/K6
on the embedding, their plain versions on the CPU) in the train step and
through the runner:

  * one hand train step with 'pallas' and refine_pose on against JAX's
    loss and gradient with 'xla' (JAX's CPU run cannot select its Pallas
    kernels; 'xla' runs the same statements in XLA);
  * the hand OfflineRunner with train.fused_fine = "pallas", as the CLI
    builds it: 2 steps, a checkpoint, one validation image.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.ops import fused_fine as FT
from honerf_torch.render import neus as TN
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import train_state_from_jax
from test_torch_parity import SMALL, configs, jax_batch, net_params, t, torch_batch, train_batch

torch.set_num_threads(1)

RC = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)


def _keys(path):
    return [k.key if hasattr(k, "key") else k.idx for k in path]


def _node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# One step's metrics against JAX's, relative: measured 1.2e-4 (the
# eikonal term of the random field is ~70 and stiff in f32).  The step's
# gradient leaves against max(1, max |want|): the nets' measured max 1.1e-3
# and median 7.4e-5 (leaves of more than one element); se3_refine's
# 8.6e-3, its gradient summed over every sample through the ~40-step HALO
# chain (that chain's VJP alone is held at 5e-3 in test_torch_train.py).
STEP_METRIC_RTOL = 1e-3
STEP_NET_TOL = (2e-3, 1e-4)
STEP_SE3_TOL = 2e-2


def test_pallas_train_step_matches_jax_xla(monkeypatch):
    """bt_inv's value is pinned to JAX's on the port's side (both
    frameworks' f32 HALO chains land ~1e-5 apart, test_torch_train.py),
    its gradient flowing to se3_refine through the port's own chain."""
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, "f32")
    jp, _ = net_params(SMALL)
    se3 = np.zeros((2, 36), np.float32)
    se3[:, 0] = se3[:, 3] = 1.0
    se3 += np.random.default_rng(3).normal(0, 0.01, se3.shape).astype(np.float32)
    params = dict(jp, se3_refine=jnp.asarray(se3))
    hyper = dict(learning_rate=1e-3, warm_up_end=0.0, end_iter=100, vgg_weight=0.0,
                 refine_pose=True, grad_clip=0.0, batch_size=36)
    jt = JO.TrainHyper(fused_fine="xla", **hyper)
    b = train_batch()
    jb = jax_batch(b)

    def jloss(p):
        out = JO.hand_render_from_batch(p, jcfg, jccfg, JRenderConfig(**RC), jt, jb,
                                        jax.random.PRNGKey(0))
        return JO.offline_losses(out, jb, jt)

    (_, want_m), want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    bt_jax = t(JO.refined_hand_pose(params, jt, jb))
    real = TO.refined_hand_pose
    monkeypatch.setattr(TO, "refined_hand_pose",
                        lambda *a: (lambda x: x + (bt_jax - x.detach()))(real(*a)))
    tt = TO.TrainHyper(fused_fine="pallas", **hyper)
    state = train_state_from_jax(JO.init_train_state(params, jt), tt, device="cpu")
    calls = []
    real_bwd = FT.hand_trunk_sdf_u_plain_bwd
    monkeypatch.setattr(FT, "hand_trunk_sdf_u_plain_bwd",
                        lambda *a, **k: calls.append(1) or real_bwd(*a, **k))
    step = TO.make_hand_train_step(tcfg, tccfg, TN.RenderConfig(**RC), tt)
    state, got_m = step(state, torch_batch(b))
    assert calls == [1]  # the fine pass went through K6's plain version
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=STEP_METRIC_RTOL,
                                   err_msg=k)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys, w = _keys(path), np.asarray(w)
        err = np.abs(_node(state["params"], keys).grad.numpy() - w) / max(1.0, np.abs(w).max())
        if keys == ["se3_refine"]:
            assert err.max() <= STEP_SE3_TOL, err.max()
        else:
            assert err.max() <= STEP_NET_TOL[0], (keys, err.max())
            assert err.size == 1 or np.median(err) <= STEP_NET_TOL[1], (keys, np.median(err))


def test_hand_runner_trains_and_renders_with_pallas(tmp_path):
    """train.fused_fine = "pallas" through the runner as the CLI builds
    it: 2 steps, a checkpoint, one validation image."""
    from honerf_torch.data.synthetic import generate_hand_dataset
    from honerf_torch.train.runner import OfflineRunner
    from test_hand_runner import HAND_CONF

    data_dir = tmp_path / "data"
    generate_hand_dataset(str(data_dir), n_frames=1, n_views=2, H=24, W=28)
    conf = tmp_path / "hand.conf"
    text = HAND_CONF.format(exp_dir=str(tmp_path / "exp"), data_dir=str(data_dir))
    text = text.replace("refine_pose = True", 'refine_pose = True\n    fused_fine = "pallas"')
    conf.write_text(text.replace("image_size = [48, 56]", "image_size = [24, 28]"))
    runner = OfflineRunner(str(conf), mode="train", case="hand1", device="cpu")
    assert runner.tcfg.fused_fine == "pallas"
    assert TO.select_fine_pass(runner.tcfg, runner.sdf_cfg, "cpu") == "pallas"
    runner.train(stop_at=2)
    runner.save_checkpoint_file()
    assert runner.iter_step == 2
    assert os.path.exists(tmp_path / "exp" / "checkpoints" / "ckpt_000002.npz")
    runner.validate_image(0)
    (img,) = os.listdir(tmp_path / "exp" / "validations_fine")
    assert img == "00000002_0.png"
