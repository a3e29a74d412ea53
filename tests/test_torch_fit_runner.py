"""The single-frame fitting runner (honerf_torch.fit.runner.SingleFitRunner)
on the CPU, end to end on disk: the port's synthetic catch sequence (1
frame, 4 views, 48x56), tiny random offline checkpoints written by the
port in the JAX runner's npz layout, fit '1' then '12' (which starts
from '1''s pickles) with train.iter_num = 2:

  * each pose pickle holds the JAX runner's keys, shapes and dtypes (the
    JAX runner's own save_pose and final_pose_numpy on the same frame),
    finite values, and '12' starts where '1' ended;
  * a second run finds the pickles and fits nothing (resume by artifact);
  * train.frames_per_batch = 2 fits a two-frame sequence's frames in
    one group (tests/test_torch_fit_pipeline.py holds the batched runner
    further).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from honerf_torch.data import fit_datasets as TFD
from honerf_torch.data.synthetic import generate_catch_sequence
from honerf_torch.fit import runner as TR
from honerf_torch.models.fields import (
    ColorConfig,
    SDFConfig,
    init_color_params,
    init_sdf_params,
    init_variance_params,
)
from honerf_torch.train.checkpoints import save_checkpoint
from test_fit_pipeline import FIT_CONF, TINY_NET

torch.set_num_threads(1)


def write_port_checkpoints(exp_root: str) -> None:
    """Random tiny offline checkpoints (the nets of TINY_NET) where the fit
    sequence looks for them, written by the port."""
    gen = torch.Generator().manual_seed(0)
    nets = {"person1/wmask_realhand": ("hand", dict(v_multires=3, r_multires=2)),
            "bean/wmask_realobj": ("obj", dict(v_multires=6))}
    for path, (kind, kw) in nets.items():
        sdf = SDFConfig(kind=kind, n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), **kw)
        col = ColorConfig(kind=kind, d_feature=64, n_layers=2, d_hidden=64, **kw)
        params = {"sdf": init_sdf_params(gen, sdf, device="cpu"),
                  "color": init_color_params(gen, col, device="cpu"),
                  "variance": init_variance_params(0.3, device="cpu")}
        save_checkpoint(os.path.join(exp_root, path, "checkpoints", "ckpt_000000.npz"),
                        {"params": params})


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    monkeypatch.setitem(TFD.VIEW_LISTS, "4", TFD.VIEW_LISTS["8"][:4])
    ws = str(tmp_path)
    generate_catch_sequence(os.path.join(ws, "data/catch_sequence/test"), n_frames=1,
                            n_views=4, H=48, W=56)
    write_port_checkpoints(os.path.join(ws, "exp"))
    confs = {}
    for ft in ("1", "12"):
        confs[ft] = os.path.join(ws, f"fit_{ft}.conf")
        with open(confs[ft], "w") as f:
            f.write(FIT_CONF.format(ws=ws, fit_type=ft, net=TINY_NET.format()))
    return ws, confs


def _pickle(ws, ft):
    path = os.path.join(ws, "fit_res", "view_4", ft, "person1_bean", "seq0", f"pose_{ft}",
                        "0.pickle")
    with open(path, "rb") as f:
        return path, pickle.load(f)


def _jax_pickle(ws, conf, tmp):
    """The JAX runner's pickle of the same frame at the initial pose."""
    from honerf_tpu.data import fit_datasets as JFD
    from honerf_tpu.fit.runner import SingleFitRunner as JRunner
    from honerf_tpu.fit.single import final_pose_numpy, init_pose_params

    JFD.VIEW_LISTS["4"] = JFD.VIEW_LISTS["8"][:4]
    try:
        runner = JRunner(conf, "c")
        seq = JFD.load_fit_sequence(runner.data_root, "person1_bean", "seq0", "4", "1",
                                    runner.fit_res_root, runner.exp_root, image_hw=(48, 56))
        frame = seq.frames[0]
        runner.save_pose(tmp, final_pose_numpy(init_pose_params(),
                                               runner.frame_consts(seq, frame)), frame)
    finally:
        del JFD.VIEW_LISTS["4"]
    with open(tmp, "rb") as f:
        return pickle.load(f)


def test_single_fit_runner(workspace, tmp_path, monkeypatch):
    ws, confs = workspace
    for ft in ("1", "12"):
        runner = TR.SingleFitRunner(confs[ft], "c", device="cpu")
        assert runner.iter_num() == 2
        runner.fitting()
        assert os.path.exists(os.path.join(ws, "fit_res", "view_4", ft, "person1_bean", "seq0",
                                           "config", "config.conf"))
    want = _jax_pickle(ws, confs["1"], str(tmp_path / "jax.pickle"))
    p1, one = _pickle(ws, "1")
    _, twelve = _pickle(ws, "12")
    for got in (one, twelve):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert isinstance(got[k], np.ndarray) and got[k].dtype == v.dtype, k
            assert got[k].shape == v.shape and np.isfinite(got[k]).all(), k
        np.testing.assert_array_equal(got["gt_joint3d"], want["gt_joint3d"])
    # '1' moved the pose; '12' started from it (and moved it again)
    assert np.abs(one["pred_joint3d"] - want["pred_joint3d"]).max() > 0
    assert 0 < np.abs(twelve["pred_joint3d"] - one["pred_joint3d"]).max() < 0.05

    # resume by artifact: the pickle exists, so nothing is fitted again
    mtime = os.path.getmtime(p1)
    monkeypatch.setattr(TR.SingleFitRunner, "fit_frame",
                        lambda *a, **k: pytest.fail("fitted a frame whose pickle exists"))
    TR.SingleFitRunner(confs["1"], "c", device="cpu").fitting()
    assert os.path.getmtime(p1) == mtime


def test_frames_per_batch_raises(workspace, tmp_path):
    """train.frames_per_batch = 2 (frame-batched fitting) no longer raises:
    on a two-frame sequence it fits both frames in one group and writes
    both pickles with the JAX runner's keys."""
    ws = str(tmp_path / "two")
    generate_catch_sequence(os.path.join(ws, "data/catch_sequence/test"), n_frames=2,
                            n_views=4, H=48, W=56)
    write_port_checkpoints(os.path.join(ws, "exp"))
    conf = os.path.join(ws, "fit_1.conf")
    with open(conf, "w") as f:
        f.write(FIT_CONF.format(ws=ws, fit_type="1", net=TINY_NET.format()).replace(
            "iter_num = 2", "iter_num = 2\n  frames_per_batch = 2"))
    TR.SingleFitRunner(conf, "c", device="cpu").fitting()
    pose_dir = os.path.join(ws, "fit_res", "view_4", "1", "person1_bean", "seq0", "pose_1")
    assert sorted(os.listdir(pose_dir)) == ["0.pickle", "1.pickle"]
    for n in ("0.pickle", "1.pickle"):
        with open(os.path.join(pose_dir, n), "rb") as f:
            pose = pickle.load(f)
        assert sorted(pose) == ["gt_Ro", "gt_To", "gt_joint3d", "pred_Ro", "pred_To",
                                "pred_joint3d"]
        assert np.isfinite(pose["pred_joint3d"]).all()
