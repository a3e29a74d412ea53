"""The port's data loading and checkpoints against the JAX package's
(CPU): load_offline_dataset and RayBatchLoader give the same arrays on
one synthetic dataset; a checkpoint written by either OfflineRunner
resumes in the other with equal params and Adam moments; the .pth zoo
converter gives JAX's tree; the runner's PNG writer round-trips through
PIL."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.data import datasets as JD
from honerf_tpu.data import synthetic as JS
from honerf_torch.data import datasets as TD
from honerf_torch.data import synthetic as TS
from test_runner_cli import SMALL_CONF

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def obj_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obj_data"))
    TS.generate_object_dataset(root, n_frames=2, n_views=3, H=40, W=48, pose_noise=0.01)
    return root


def _same_scene(a, b):
    assert len(a) == len(b) and a.model_type == b.model_type
    for name in ("t_pose_21", "bone_length", "obj_verts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for va, vb in zip(a.views, b.views):
        for field in ("image", "mask", "cam_R", "cam_T", "focal", "principal", "Ro", "To",
                      "joints", "name"):
            np.testing.assert_array_equal(getattr(va, field), getattr(vb, field))
        for x, y in zip(va.mask_xy, vb.mask_xy):
            np.testing.assert_array_equal(x, y)


def test_generators_write_what_jax_writes(tmp_path):
    """The copied generators write the same datasets as the JAX package's."""
    for kind, gen_t, gen_j in (("obj", TS.generate_object_dataset, JS.generate_object_dataset),
                               ("hand", TS.generate_hand_dataset, JS.generate_hand_dataset)):
        a, b = str(tmp_path / f"{kind}_t"), str(tmp_path / f"{kind}_j")
        gen_t(a, n_frames=1, n_views=2, H=24, W=28)
        gen_j(b, n_frames=1, n_views=2, H=24, W=28)
        _same_scene(TD.load_offline_dataset(a, kind, "test"),
                    JD.load_offline_dataset(b, kind, "test"))


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_offline_dataset_matches_jax(obj_data, split):
    _same_scene(TD.load_offline_dataset(obj_data, "obj", split),
                JD.load_offline_dataset(obj_data, "obj", split))


def test_ray_batch_loader_matches_jax(obj_data):
    loaders = [M.RayBatchLoader(M.load_offline_dataset(obj_data, "obj", "train"), 49, seed=3)
               for M in (TD, JD)]
    for patch in (False, True):
        for got, want in zip(loaders[0].epoch(patch=patch), loaders[1].epoch(patch=patch)):
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- checkpoints across the two runners --------------------------------------

def _conf(ws, name):
    data = os.path.join(ws, "data")
    if not os.path.isdir(data):
        TS.generate_object_dataset(data, n_frames=1, n_views=4, H=48, W=56)
    path = os.path.join(ws, f"{name}.conf")
    with open(path, "w") as f:
        f.write(SMALL_CONF.format(exp_dir=os.path.join(ws, name), data_dir=data))
    return path


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [jax.tree_util.keystr(p) for p, _ in la] == [jax.tree_util.keystr(p) for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


def _port_moments(state):
    opt = state["opt"]
    pick = lambda key: jax.tree.map(  # noqa: E731
        lambda p: opt.state[p][key].numpy(), state["params"],
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    counts = {float(s["step"]) for s in opt.state.values()}
    return pick("exp_avg"), pick("exp_avg_sq"), counts


def test_port_checkpoint_resumes_in_jax_runner(tmp_path):
    from honerf_tpu.train.runner import OfflineRunner as JaxRunner
    from honerf_torch.train.runner import OfflineRunner

    conf = _conf(str(tmp_path), "exp")
    port = OfflineRunner(conf, mode="train", device="cpu")
    port.train(stop_at=3)
    port.save_checkpoint_file()
    jr = JaxRunner(conf, mode="test", is_continue=True)
    assert jr.iter_step == 3 and int(jr.state["step"]) == 3
    _assert_trees_equal(jr.state["params"], _np_tree(port.state["params"]))
    adam, sched = jr.state["opt_state"]
    mu, nu, counts = _port_moments(port.state)
    assert counts == {3.0} and int(adam.count) == 3 and int(sched.count) == 3
    _assert_trees_equal(adam.mu, mu)
    _assert_trees_equal(adam.nu, nu)


def test_jax_checkpoint_resumes_in_port_runner(tmp_path):
    from honerf_tpu.train.runner import OfflineRunner as JaxRunner
    from honerf_torch.train.runner import OfflineRunner

    conf = _conf(str(tmp_path), "exp")
    jr = JaxRunner(conf, mode="train")
    rng = np.random.default_rng(0)
    noise = lambda tree, s: jax.tree.map(  # noqa: E731
        lambda x: x + jnp.asarray(s * rng.normal(size=x.shape), jnp.float32), tree)
    adam, sched = jr.state["opt_state"]
    jr.state = {"params": noise(jr.state["params"], 0.01),
                "opt_state": (adam._replace(count=jnp.asarray(5, jnp.int32),
                                            mu=noise(adam.mu, 1e-3),
                                            nu=jax.tree.map(jnp.abs, noise(adam.nu, 1e-4))),
                              sched._replace(count=jnp.asarray(5, jnp.int32))),
                "step": jnp.asarray(5, jnp.int32)}
    jr.iter_step = 5
    jr.save_checkpoint_file()
    port = OfflineRunner(conf, mode="train", is_continue=True, device="cpu")
    assert port.iter_step == 5 and port.state["step"] == 5
    _assert_trees_equal(jr.state["params"], _np_tree(port.state["params"]))
    mu, nu, counts = _port_moments(port.state)
    assert counts == {5.0}
    _assert_trees_equal(jr.state["opt_state"][0].mu, mu)
    _assert_trees_equal(jr.state["opt_state"][0].nu, nu)
    port.train(stop_at=6)  # and the run goes on from there
    assert port.iter_step == 6 and port.state["step"] == 6


def test_pth_converter_matches_jax(tmp_path):
    from honerf_tpu.train.checkpoints import load_torch_checkpoint as jax_load
    from honerf_torch.train.checkpoints import load_torch_checkpoint

    torch.manual_seed(0)
    lins = [torch.nn.utils.weight_norm(torch.nn.Linear(i, o))
            for i, o in ((39, 64), (64, 25), (64, 64), (64, 65))]
    sdf_sd = {}
    for i, lin in enumerate(lins):
        sdf_sd[f"lin{i}.weight_v"] = lin.weight_v.detach()
        sdf_sd[f"lin{i}.weight_g"] = lin.weight_g.detach()
        sdf_sd[f"lin{i}.bias"] = lin.bias.detach()
    sdf_sd["se3_refine"] = torch.randn(4, 9)
    ckpt = {"sdf_network_fine": sdf_sd,
            "color_network_fine": {"lin0.weight": torch.randn(3, 8), "lin0.bias": torch.randn(3)},
            "variance_network_fine": {"variance": torch.tensor(0.31)},
            "iter_step": 300000}
    path = str(tmp_path / "ckpt_300000.pth")
    torch.save(ckpt, path)
    got, want = load_torch_checkpoint(path), jax_load(path)
    assert got["iter_step"] == want["iter_step"] == 300000
    _assert_trees_equal({k: v for k, v in got.items() if k != "iter_step"},
                        {k: v for k, v in want.items() if k != "iter_step"})


def test_png_writer_round_trips_through_pil(tmp_path):
    from PIL import Image

    from honerf_torch.train.runner import _write_image

    img = np.random.default_rng(0).integers(0, 256, (23, 31, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    _write_image(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)
