"""The f32 modes of the fine-pass kernels ported last, their plain
versions on the CPU, against the JAX package's Pallas kernels in
interpret mode (on the CPU the JAX steps would not select them, so their
make_hand_field is given the mode and interpret=True), small nets, f32
trunks:

  * one hand train step under 'full' (K2 / K3 with the color net and
    weight gradients) and 'full_nocolor' (without it), refine_pose off,
    against JAX's make_hand_train_step under 'full', traced once (10-20 s
    on a CPU; JAX's fused modes agree with each other to f32 rounding,
    tests/test_fused_fine_full.py): the loss within 1e-4 and every
    gradient leaf within 1e-3 of max(1, max |want|),
    tests/test_fused_fine.py's bounds for JAX's fused pass against its
    XLA path.  bt_inv is pinned to JAX's value on the port's side (the
    two f32 HALO chains land ~1e-5 apart, test_torch_train.py);
  * the fit runner's reading of train.fused_ladder (JAX's conf.get_bool).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.render import neus as TN
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import params_from_jax
from test_torch_fine_modes_step import RC, _keys, _node
from test_torch_parity import SMALL, configs, jax_batch, t, torch_batch, train_batch
from torch_fit_common import hand_nets

torch.set_num_threads(1)

HYPER = dict(learning_rate=1e-3, warm_up_end=0.0, end_iter=100, vgg_weight=0.0,
             refine_pose=False, grad_clip=0.0, batch_size=36)


@functools.lru_cache(maxsize=None)
def jax_train_step():
    """JAX's hand train step under 'full' in interpret mode: (JAX params,
    loss, gradient tree, bt_inv)."""
    jcfg, jccfg, _, _ = configs(SMALL, "f32")
    jp, _ = hand_nets()
    jt = JO.TrainHyper(fused_fine="full", **HYPER)
    jb = jax_batch(train_batch())
    real = JO.make_hand_field
    JO.make_hand_field = lambda *a, fused_ladder, fused_fine, interpret: real(
        *a, fused_fine="full", interpret=True)
    try:
        def jloss(p):
            out = JO.hand_render_from_batch(p, jcfg, jccfg, JRenderConfig(**RC), jt, jb,
                                            jax.random.PRNGKey(0))
            return JO.offline_losses(out, jb, jt)[0], JO.refined_hand_pose(p, jt, jb)

        (loss, bt), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    finally:
        JO.make_hand_field = real
    return jp, float(loss), grads, t(bt)


@pytest.mark.parametrize("mode", ["full", "full_nocolor"])
def test_f32_train_step_matches_jax(mode, monkeypatch):
    _, _, tcfg, tccfg = configs(SMALL, "f32")
    jp, want_loss, want, bt_jax = jax_train_step()
    monkeypatch.setattr(TO, "refined_hand_pose", lambda *a: bt_jax)
    tt = TO.TrainHyper(fused_fine=mode, **HYPER)
    assert TO.select_fine_pass(tt, tcfg, "cpu") == mode
    calls = []
    real_bwd = FF.hand_fine_color_plain_bwd
    monkeypatch.setattr(FF, "hand_fine_color_plain_bwd",
                        lambda *a, **k: calls.append(a[4].meta) or real_bwd(*a, **k))
    state = TO.init_train_state(params_from_jax(jp, device="cpu"), tt)
    step = TO.make_hand_train_step(tcfg, tccfg, TN.RenderConfig(**RC), tt)
    state, got_m = step(state, torch_batch(train_batch()))
    # the fine pass went through K3's plain version once, f32, in the mode
    assert [(m.dtype, m.with_color) for m in calls] == [("f32", mode == "full")]
    np.testing.assert_allclose(float(got_m["loss"]), want_loss, atol=1e-4, rtol=1e-4)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys, w = _keys(path), np.asarray(w)
        err = np.abs(_node(state["params"], keys).grad.numpy() - w) / max(1.0, np.abs(w).max())
        assert err.max() <= 1e-3, (keys, err.max())


@pytest.mark.parametrize("value", ["off", '"false"', "false", "no", "on"])
def test_fit_runner_reads_fused_ladder_as_jax(value, tmp_path, monkeypatch):
    """train.fused_ladder = off (unquoted, a string to the conf parser) or
    "false" selects no K1, as JAX's conf.get_bool reads them."""
    from honerf_tpu.config import load_config as jax_load_config
    from honerf_torch.fit import runner as TR
    from test_fit_pipeline import FIT_CONF, TINY_NET

    conf = tmp_path / "fit_1.conf"
    text = FIT_CONF.format(ws=str(tmp_path), fit_type="1", net=TINY_NET.format())
    conf.write_text(text.replace("iter_num = 2", f"iter_num = 2\n  fused_ladder = {value}"))
    want = jax_load_config(str(conf)).get_bool("train.fused_ladder")
    seen = []
    monkeypatch.setattr(TR, "select_fit_kernels",
                        lambda ladder, *a: seen.append(ladder) or (ladder, None))
    monkeypatch.setattr(TR, "make_single_fit_step", lambda *a, **k: None)
    TR.SingleFitRunner(str(conf), "c", device="cpu").make_step({})
    assert seen == [want] and want is (value == "on")
