"""The port's train-step pieces against the JAX package: losses, the
learning-rate schedule, the global-norm clip, the small helpers, the
pose-refinement VJP, and the hand loss's gradient in f32 (the autograd
field path), on the same seeded inputs.

The pose enters the render through bt_inv = refined_hand_pose(se3_refine).
Both frameworks compute bt_inv in f32 through the ~40-step HALO chain and
land ~1e-5 apart (each as far from a float64 run), and the random test
field's loss is stiff in the pose (eikonal ~70): 1e-5 on bt_inv moves
the loss by ~1e-4 in f32 and by ~2% in bf16, in either framework alike.
So the render's gradient is compared at one bt_inv given to both sides
(JAX's value), with its gradient on bt_inv, and the HALO path's VJP on
its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train import offline as TO
from honerf_torch.train.checkpoints import params_from_jax
from test_torch_parity import SMALL, configs, jax_batch, net_params, t, torch_batch, train_batch

torch.set_num_threads(1)

RC = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)
# (max, median) of |got - want| against max(1, max |want|), per leaf.
# f32: measured max 5.9e-4 on the parameters and 1.2e-3 on bt_inv, whose
# gradient sums every sample's pose cotangent (2e-3 there).  bf16 (the
# plain versions against Pallas interpret mode): measured max 1.5e-2,
# medians <= 7.2e-4; both sides round the same operands to bf16, and
# sums in another order flip single roundings, which the second-order
# terms (beta = 100) carry into every gradient summed over the samples.
GRAD_TOL = {"f32": (1e-3, 1e-3), "bf16": (3e-2, 1e-3)}
BT_TOL_F32 = 2e-3


def test_losses_match_jax():
    from honerf_tpu.render import losses as JL
    from honerf_torch.render import losses as TL

    rng = np.random.default_rng(0)
    color, rgb = rng.uniform(0, 1, (2, 50, 3)).astype(np.float32)
    wsum = rng.uniform(-0.1, 1.1, (50, 1)).astype(np.float32)
    mask = (rng.uniform(0, 1, (50, 1)) > 0.5).astype(np.float32)
    for name, args in (("masked_l1_color", (color, rgb, mask)), ("mask_bce", (wsum, mask)),
                       ("masked_psnr", (color, rgb, mask)), ("masked_psnr", (rgb, rgb, mask))):
        want = float(getattr(JL, name)(*map(jnp.asarray, args)))
        got = float(getattr(TL, name)(*map(t, args)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("warm_up_end", [0.0, 5.0])
def test_lr_schedule_matches_jax(warm_up_end):
    from honerf_tpu.train.schedule import make_lr_schedule as jax_schedule
    from honerf_torch.train.schedule import make_lr_schedule

    want, got = (f(5e-4, warm_up_end, 100, 0.05) for f in (jax_schedule, make_lr_schedule))
    for step in (0, 1, 4, 5, 6, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3])
def test_grad_clip_matches_jax(clip):
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32)]}
    want, want_norm = JO._clipped_grads(jax.tree.map(jnp.asarray, tree), clip)
    leaves = [t(tree["a"]), t(tree["b"][0])]
    got_norm = TO._clipped_grads(leaves, clip)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for g, w in zip(leaves, (want["a"], want["b"][0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_grad_clip_resolution_matches_jax():
    for dtype in ("f32", "bf16"):
        cfg = configs(SMALL, dtype)
        for clip in (None, 0.0, 7.0):
            assert TO.resolve_grad_clip(TO.TrainHyper(grad_clip=clip), cfg[2]) == \
                JO.resolve_grad_clip(JO.TrainHyper(grad_clip=clip), cfg[0])


def test_small_pieces_match_jax():
    from honerf_tpu.data.datasets import get_bone_length as jax_bone_length
    from honerf_tpu.data.synthetic import canonical_hand_joints
    from honerf_tpu.models.fields import init_se3_refine as jax_se3
    from honerf_torch.data.datasets import get_bone_length
    from honerf_torch.models.fields import init_se3_refine

    j = canonical_hand_joints(0.3)
    np.testing.assert_array_equal(get_bone_length(j), jax_bone_length(j))
    for kind in ("hand", "obj"):
        np.testing.assert_array_equal(init_se3_refine(3, kind, device="cpu").numpy(),
                                      np.asarray(jax_se3(3, kind)))


def test_train_hyper_reads_the_conf_as_jax_does():
    from honerf_tpu.config import load_config as jax_load
    from honerf_torch.config import load_config

    path = "confs/wmask_realhand_hand1.conf"
    got, want = TO.TrainHyper.from_conf(load_config(path)), JO.TrainHyper.from_conf(
        jax_load(path))
    for field in TO.TrainHyper._fields:
        assert getattr(got, field) == getattr(want, field), field


FINE_VALUES = {"unset": None, "true": "true", "false": "false", "full": '"full"',
               "full_nocolor": '"full_nocolor"', "pallas": '"pallas"', "xla": '"xla"'}


@pytest.mark.parametrize("name", list(FINE_VALUES))
def test_train_hyper_fused_fine_matches_jax(name):
    """train.fused_fine parses to JAX's TrainHyper, field by field, for
    every value."""
    from honerf_tpu.config import load_config as jax_load
    from honerf_tpu.config.hocon import parse_string as jax_parse
    from honerf_torch.config import load_config
    from honerf_torch.config.hocon import parse_string

    path = "confs/wmask_realhand_hand1.conf"
    conf, jconf = load_config(path), jax_load(path)
    if FINE_VALUES[name] is not None:
        conf["train"].update(parse_string(f"fused_fine = {FINE_VALUES[name]}"))
        jconf["train"].update(jax_parse(f"fused_fine = {FINE_VALUES[name]}"))
    got, want = TO.TrainHyper.from_conf(conf), JO.TrainHyper.from_conf(jconf)
    for field in JO.TrainHyper._fields:
        assert getattr(got, field) == getattr(want, field), field
    assert type(got.fused_fine) is type(want.fused_fine)


NIE = NotImplementedError
# train.fused_fine -> (JAX's choice on one chip for a bf16 / f32 trunk
# (honerf_tpu/train/offline.py:399-409), the port's on CPU tensors bf16 /
# f32, on CUDA tensors bf16 / f32).  Every kernel mode runs on the card in
# both dtypes.  JAX's 'xla' runs K5/K6's statements in XLA: the port's
# 'pallas' on the CPU (their plain version), refused on the card; JAX's
# False is the autograd field.
FINE_TABLE = {
    None: (("full", False), ("full", None), ("full", None)),
    True: (("full", "full"), ("full", "full"), ("full", "full")),
    "full": (("full", "full"), ("full", "full"), ("full", "full")),
    "full_nocolor": (("full_nocolor", "full_nocolor"), ("full_nocolor", "full_nocolor"),
                     ("full_nocolor", "full_nocolor")),
    "pallas": (("pallas", "pallas"), ("pallas", "pallas"), ("pallas", "pallas")),
    "xla": (("xla", "xla"), ("pallas", "pallas"), (NIE, NIE)),
    False: ((False, False), (None, None), (NIE, None)),
    "full_frozen": ((False, False), (None, None), (NIE, None)),
}


@pytest.mark.parametrize("value", list(FINE_TABLE), ids=str)
def test_fine_pass_selection(value):
    jax_choice, cpu, card = FINE_TABLE[value]
    for i, dtype in enumerate(("bf16", "f32")):
        cfg = configs(SMALL, dtype)[2]
        tcfg = TO.TrainHyper(fused_fine=value)
        same = {"xla": "pallas", False: None}.get(jax_choice[i], jax_choice[i])
        assert TO.select_fine_pass(tcfg, cfg, "cpu") == cpu[i] == same, dtype
        if card[i] is NIE:
            with pytest.raises(NotImplementedError):
                TO.select_fine_pass(tcfg, cfg, "cuda")
        else:
            assert TO.select_fine_pass(tcfg, cfg, "cuda") == card[i], dtype


def test_refined_pose_vjp_matches_jax():
    """se3_refine -> bt_inv (inverse HALO path, palm rot6d and translation,
    bone transforms) and its VJP at a seeded cotangent."""
    b = train_batch()
    rng = np.random.default_rng(2)
    se3 = np.zeros((2, 36), np.float32)
    se3[:, 0] = se3[:, 3] = 1.0
    se3 += rng.normal(0, 0.02, se3.shape).astype(np.float32)
    ct = rng.normal(size=(21, 4, 4)).astype(np.float32)
    hyper = dict(vgg_weight=0.0, refine_pose=True)
    want, vjp = jax.vjp(
        lambda s: JO.refined_hand_pose({"se3_refine": s}, JO.TrainHyper(**hyper), jax_batch(b)),
        jnp.asarray(se3))
    want_grad = np.asarray(vjp(jnp.asarray(ct))[0])
    s = t(se3).requires_grad_(True)
    got = TO.refined_hand_pose({"se3_refine": s}, TO.TrainHyper(**hyper), torch_batch(b))
    (got * t(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    scale = max(1.0, float(np.abs(want_grad).max()))
    np.testing.assert_allclose(s.grad.numpy() / scale, want_grad / scale, atol=5e-3)


def hand_loss_grads(dtype, monkeypatch):
    """(port grads, JAX grads) of the hand train loss: every parameter
    leaf, then bt_inv, with refine_pose on and bt_inv fixed to JAX's
    refined_hand_pose value on both sides."""
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, dtype)
    jp, _ = net_params(SMALL)
    se3 = np.zeros((2, 36), np.float32)
    se3[:, 0] = se3[:, 3] = 1.0
    params = dict(jp, se3_refine=jnp.asarray(se3))
    hyper = dict(vgg_weight=0.0, refine_pose=True)
    jt, tt = JO.TrainHyper(**hyper), TO.TrainHyper(**hyper)
    b = train_batch()
    jb, tb = jax_batch(b), torch_batch(b)
    bt = JO.refined_hand_pose(params, jt, jb)

    def jloss(p, bt_inv):
        monkeypatch.setattr(JO, "refined_hand_pose", lambda *a: bt_inv)
        out = JO.hand_render_from_batch(p, jcfg, jccfg, JRenderConfig(**RC), jt, jb,
                                        jax.random.PRNGKey(0),
                                        fused_interpret=dtype == "bf16")
        return JO.offline_losses(out, jb, jt)[0]

    want_p, want_bt = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, bt)
    tp = params_from_jax(params, device="cpu")
    for x in TO._tensors(tp):
        x.requires_grad_(True)
    bt_t = t(bt).requires_grad_(True)
    monkeypatch.setattr(TO, "refined_hand_pose", lambda *a: bt_t)
    out = TO.hand_render_from_batch(tp, tcfg, tccfg, RenderConfig(**RC), tt, tb)
    TO.offline_losses(out, tb, tt)[0].backward()
    got, want = [], []
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        want.append(np.asarray(leaf))
        got.append(np.zeros_like(want[-1]) if node.grad is None else node.grad.numpy())
    return got + [bt_t.grad.numpy()], want + [np.asarray(want_bt)]


def check_hand_loss_grads(dtype, monkeypatch):
    got, want = hand_loss_grads(dtype, monkeypatch)
    assert np.abs(want[-1]).max() > 0  # the pose gradient is live
    tol_max, tol_median = GRAD_TOL[dtype]
    for i, (g, w) in enumerate(zip(got, want)):
        if i == len(got) - 1 and dtype == "f32":
            tol_max = BT_TOL_F32
        err = np.abs(g - w) / max(1.0, float(np.abs(w).max()))
        assert err.max() <= tol_max and np.median(err) <= tol_median, (
            f"leaf {i}: max {err.max():.2e} median {np.median(err):.2e}")


def test_hand_loss_gradient_matches_jax_f32(monkeypatch):
    check_hand_loss_grads("f32", monkeypatch)
