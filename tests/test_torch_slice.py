"""The port's hand novel-view render as a whole, against the JAX package
on the same weights, pose, camera and rays (CPU, perturb=0, no pose
refinement), and the port's independence from JAX.

  * kernel path (bf16 trunk): the port's hand_render_from_batch (plain
    versions of both kernels) vs JAX hand_render_from_batch with
    fused_interpret=True (both Pallas kernels in interpret mode): 1e-3 on
    color_fine and weight_sum (bf16 kernels on both sides; a rounding flip
    in the ladder moves a sample by a fraction of its interval);
  * exact path (f32, train.fused_ladder=false): make_hand_eval_render on
    both sides, 2e-4 (the renderer tolerance).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.data.synthetic import look_at_camera
from honerf_tpu.render import RenderConfig as JRenderConfig
from honerf_tpu.train import offline as JO
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import fused_hand as FH
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train import offline as TO
from honerf_torch.train.runner import render_full_image
from test_torch_parity import SMALL, configs, hand_pose, net_params, t

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCFG = dict(n_samples=8, n_importance=8, up_sample_steps=2, perturb=0.0)


def _batch(n_side=6):
    bt, tpose, joints = hand_pose()
    R, T = look_at_camera(np.asarray([0.0, 0.2, -0.9]), joints.mean(0))
    g = np.linspace(-0.12, 0.12, n_side, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    return dict(cam_R=R, cam_T=T, focal=np.asarray([3.0, 3.0], np.float32),
                principal=np.zeros(2, np.float32), joints=joints, t_pose_21=tpose,
                rays_xy=xy, index=np.int32(0))


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: t(v) for k, v in b.items() if k != "index"}


def test_kernel_path_matches_jax_interpret():
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, "bf16")
    jp, tp = net_params(SMALL)
    b = _batch()
    jt = JO.TrainHyper(refine_pose=False)
    want = JO.hand_render_from_batch(jp, jcfg, jccfg, JRenderConfig(**RCFG), jt, _jax_batch(b),
                                     jax.random.PRNGKey(0), fused_interpret=True)
    with torch.no_grad():
        got = TO.hand_render_from_batch(tp, tcfg, tccfg, RenderConfig(**RCFG),
                                        TO.TrainHyper(refine_pose=False), _torch_batch(b))
    assert float(np.asarray(want["weight_sum"]).max()) > 0.1  # the rays hit the hand
    for k in ("color_fine", "weight_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-3, err_msg=k)


def test_exact_path_matches_jax_eval_render():
    jcfg, jccfg, tcfg, tccfg = configs(SMALL, "f32")
    jp, tp = net_params(SMALL)
    b = _batch()
    jr = JO.make_hand_eval_render(jcfg, jccfg, JRenderConfig(**RCFG),
                                  JO.TrainHyper(fused_ladder=False))
    want = jr(jp, _jax_batch(b), jax.random.PRNGKey(0))
    tr = TO.make_hand_eval_render(tcfg, tccfg, RenderConfig(**RCFG),
                                  TO.TrainHyper(fused_ladder=False))
    got = tr(tp, _torch_batch(b))
    assert float(np.asarray(want[1]).max()) > 0.1
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=2e-4)


def test_eval_render_dispatch(monkeypatch):
    """bf16 eval: the ladder and the fine pass go through the two kernel
    modules (their plain versions on the CPU, with no launches counted);
    train.fused_ladder=false takes the exact ladder; f32 takes the
    autograd fine pass."""
    calls = {"ladder": 0, "fine": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(FH, "fused_hand_sdf_plain", spy("ladder", FH.fused_hand_sdf_plain))
    monkeypatch.setattr(FF, "hand_fine_color_plain", spy("fine", FF.hand_fine_color_plain))
    _, _, tcfg, tccfg = configs(SMALL, "bf16")
    _, tp = net_params(SMALL)
    b = _torch_batch(_batch(2))
    launches = (FH.KERNEL.launches, FF.KERNEL.launches)
    TO.make_hand_eval_render(tcfg, tccfg, RenderConfig(**RCFG), TO.TrainHyper())(tp, b)
    assert calls == {"ladder": 2, "fine": 1}  # ladder: coarse + 1 up-sample step
    TO.make_hand_eval_render(tcfg, tccfg, RenderConfig(**RCFG),
                             TO.TrainHyper(fused_ladder=False))(tp, b)
    assert calls == {"ladder": 2, "fine": 2}
    _, _, fcfg, fccfg = configs(SMALL, "f32")
    TO.make_hand_eval_render(fcfg, fccfg, RenderConfig(**RCFG), TO.TrainHyper())(tp, b)
    assert calls == {"ladder": 4, "fine": 2}
    assert (FH.KERNEL.launches, FF.KERNEL.launches) == launches


def test_eval_render_packs_once_per_snapshot(monkeypatch):
    """The eval render packs the kernels' weights once per parameter
    snapshot: again after an in-place update or for other tensors, and
    then renders exactly what a fresh render gives."""
    packed = []
    real = TO.pack_hand_field

    def spy(*a, **k):
        packed.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TO, "pack_hand_field", spy)
    _, _, tcfg, tccfg = configs(SMALL, "bf16")
    _, tp = net_params(SMALL)
    b = _torch_batch(_batch(2))
    make = lambda: TO.make_hand_eval_render(tcfg, tccfg, RenderConfig(**RCFG),  # noqa: E731
                                            TO.TrainHyper())
    render = make()
    c0, _ = render(tp, b)
    render(tp, b)
    assert len(packed) == 1
    with torch.no_grad():
        tp["color"]["layers"][-1]["b"].add_(0.5)
    c1, _ = render(tp, b)
    assert len(packed) == 2 and not torch.equal(c0, c1)
    torch.testing.assert_close(c1, make()(tp, b)[0], atol=0, rtol=0)
    tp2 = {k: dict(v) for k, v in tp.items()}
    tp2["sdf"]["layers"] = [{n: x.clone() for n, x in l.items()} for l in tp["sdf"]["layers"]]
    render(tp2, b)
    assert len(packed) == 4


def test_render_full_image_chunks_agree():
    """The full-image loop gives the same image for any request size."""
    _, _, tcfg, tccfg = configs(SMALL, "bf16")
    _, tp = net_params(SMALL)
    b = _torch_batch(_batch())
    view = {k: v for k, v in b.items() if k != "rays_xy"}
    view["focal"] = t([12.0, 12.0])  # zoom so the 9x11 grid covers the hand
    render = TO.make_hand_eval_render(tcfg, tccfg, RenderConfig(**RCFG), TO.TrainHyper())
    c1, w1 = render_full_image(render, tp, view, 9, 11, chunk=40)
    c2, w2 = render_full_image(render, tp, view, 9, 11, chunk=99)
    assert c1.shape == (9, 11, 3) and w1.shape == (9, 11)
    assert torch.isfinite(c1).all() and float(w1.max()) > 0.1
    torch.testing.assert_close(c1, c2, atol=1e-6, rtol=0)
    torch.testing.assert_close(w1, w2, atol=1e-6, rtol=0)


def test_port_imports_without_jax():
    """Every honerf_torch module and chip_smoke import with jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import honerf_torch\n"
        "for m in pkgutil.walk_packages(honerf_torch.__path__, 'honerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'honerf_tpu'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    from honerf_torch.models.fields import init_sdf_params
    from honerf_torch.train.checkpoints import params_from_jax
    from honerf_torch.utils.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    _, _, tcfg, _ = configs(SMALL)
    g = torch.Generator().manual_seed(0)
    assert init_sdf_params(g, tcfg, device="cpu")["layers"][0]["v"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            init_sdf_params(g, tcfg)
        with pytest.raises(RuntimeError):
            params_from_jax({"variance": np.float32(0.3)})
