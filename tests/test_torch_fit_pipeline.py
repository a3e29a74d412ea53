"""The fitting pipeline of the port on the CPU, end to end on disk
(tests/test_fit_pipeline.py's and tests/test_fit_batched_runner.py's
workflows for honerf_torch.fit.runner): the port's synthetic catch
sequence (2 frames, 4 views, 48x56), tiny random offline checkpoints
written by the port, TINY_NET's confs:

  * SingleFitRunner '1' -> '12' -> VideoFitRunner '123' (2 epochs) ->
    GetResRunner '123' (the highest pose_<n> on disk, not the reference's
    pose_4) and '12' (meshes, inner ids); every pose pickle holds the JAX
    runner's keys, shapes and dtypes (its save_pose on the same frame);
  * the --render path (full-image dual renders) and the video fitter's
    per-epoch renders (general.render_every_epoch);
  * the frame-batched runner (train.frames_per_batch = 2, 3 frames: a
    full group and a short one) fits every frame, the frames differ, and a
    second run fits nothing (resume by artifact);
  * the video and get_res command lines parse the JAX command lines'
    arguments into the same runner calls;
  * get_res's inner ids, sdf grids, meshes and render against the JAX
    runner's on the same fitted pose.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from honerf_torch.data import fit_datasets as TFD
from honerf_torch.data.synthetic import generate_catch_sequence
from honerf_torch.fit import runner as TR
from test_fit_pipeline import FIT_CONF, TINY_NET
from test_torch_fit_runner import _jax_pickle, write_port_checkpoints

torch.set_num_threads(1)
SEQ = ("person1_bean", "seq0")


@pytest.fixture(scope="module", autouse=True)
def four_views():
    TFD.VIEW_LISTS["4"] = TFD.VIEW_LISTS["8"][:4]
    yield
    del TFD.VIEW_LISTS["4"]


def _workspace(root, n_frames):
    generate_catch_sequence(os.path.join(root, "data/catch_sequence/test"), n_frames=n_frames,
                            n_views=4, H=48, W=56)
    write_port_checkpoints(os.path.join(root, "exp"))
    return root


def _conf(ws, fit_type, general="", train=""):
    path = os.path.join(ws, f"fit_{fit_type}_{abs(hash((general, train)))}.conf")
    text = FIT_CONF.format(ws=ws, fit_type=fit_type, net=TINY_NET.format())
    text = text.replace("  fit_id = 0", "  fit_id = 0\n" + general)
    text = text.replace("iter_num = 2", "iter_num = 2\n" + train)
    with open(path, "w") as f:
        f.write(text)
    return path


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    ws = _workspace(str(tmp_path_factory.mktemp("torchfitpipe")), 2)
    for ft in ("1", "12"):
        TR.SingleFitRunner(_conf(ws, ft), "c", device="cpu").fitting()
    TR.VideoFitRunner(_conf(ws, "123"), "c", device="cpu").fitting()
    return ws


def test_fit_pipeline_end_to_end(pipeline, tmp_path):
    ws = pipeline
    want = _jax_pickle(ws, _conf(ws, "1"), str(tmp_path / "jax.pickle"))
    fit = os.path.join(ws, "fit_res", "view_4")
    paths = [os.path.join(fit, ft, *SEQ, f"pose_{ft}", f"{i}.pickle") for ft in ("1", "12")
             for i in (0, 1)]
    vid = os.path.join(fit, "123", *SEQ)
    assert sorted(os.listdir(vid)) == ["pose_0", "pose_1"]
    paths += [os.path.join(vid, f"pose_{e}", f"{i}.pickle") for e in (0, 1) for i in (0, 1)]
    got = [_load(p) for p in paths]
    for g in got:
        assert sorted(g) == sorted(want)
        for k, v in want.items():
            assert isinstance(g[k], np.ndarray) and g[k].dtype == v.dtype, k
            assert g[k].shape == v.shape and np.isfinite(g[k]).all(), k
    twelve, video = got[2], got[6]
    # the video stage starts from '12''s poses and moves them
    assert 0 < np.abs(video["pred_joint3d"] - twelve["pred_joint3d"]).max() < 0.05

    # extraction from the video poses with train.epochs = 2: pose_1
    runner = TR.GetResRunner(_conf(ws, "123"), "c", device="cpu")
    assert runner._pose_dir_name(vid) == "pose_1"
    runner.fitting()
    analys = os.path.join(ws, "fit_res", "analys_res", "view_4")
    assert sorted(os.listdir(os.path.join(analys, "123", *SEQ, "inner_123"))) == [
        "0.pickle", "1.pickle"]
    assert [r["frame"] for r in runner.timings] == [0, 1]

    # meshes and inner ids from '12''s poses
    runner = TR.GetResRunner(_conf(ws, "12"), "c", device="cpu")
    runner.fitting()
    base = os.path.join(analys, "12", *SEQ)
    meshes = sorted(os.listdir(os.path.join(base, "mesh_12")))
    assert meshes == ["0_hand.ply", "0_obj.ply", "1_hand.ply", "1_obj.ply"]
    ids = _load(os.path.join(base, "inner_12", "0.pickle"))["inner_point_id"]
    assert ids.ndim == 1
    assert {"hand_grid_s", "hand_mc_s", "hand_ply_s", "obj_grid_s", "inner_s"} <= set(
        runner.timings[0])


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_get_res_render_path(pipeline, monkeypatch):
    ws = pipeline
    # the synthetic sequence has no held-out cameras: view 0 stands in
    monkeypatch.setattr(TFD, "RENDER_TEST_VIEWS", TFD.VIEW_LISTS["8"][:1])
    TR.GetResRunner(_conf(ws, "12"), "c", render=True, device="cpu").fitting()
    rdir = os.path.join(ws, "fit_res", "analys_res", "view_4", "12", *SEQ, "render_12")
    names = sorted(os.listdir(rdir))
    assert names == [f"{i}_{TFD.VIEW_LISTS['8'][0]}.jpeg" for i in (0, 1)]
    img = _png(os.path.join(rdir, names[0]))
    assert img.shape == (48, 56, 3) and img.dtype == np.uint8 and img.any()


def test_video_per_epoch_renders(pipeline):
    ws = pipeline
    conf = _conf(ws, "123", "  get_render_all = true\n  render_every_epoch = true")
    with open(conf) as f:
        text = f.read()
    with open(conf, "w") as f:
        f.write(text.replace(f'fit_res_root = "{ws}/fit_res"',
                             f'fit_res_root = "{ws}/fit_res_epochs"'))
    import shutil

    shutil.copytree(os.path.join(ws, "fit_res", "view_4", "12"),
                    os.path.join(ws, "fit_res_epochs", "view_4", "12"))
    TR.VideoFitRunner(conf, "c", device="cpu").fitting()
    vid = os.path.join(ws, "fit_res_epochs", "view_4", "123", *SEQ)
    for epoch in (0, 1):
        imgs = sorted(os.listdir(os.path.join(vid, f"render_{epoch}")))
        assert imgs == [f"{i}_{TFD.VIEW_LISTS['8'][0]}.jpeg" for i in (0, 1)]
        assert _png(os.path.join(vid, f"render_{epoch}", imgs[0])).shape == (48, 56, 3)


def test_batched_runner_fits_every_frame_and_resumes(tmp_path, monkeypatch):
    ws = _workspace(str(tmp_path), 3)
    conf = _conf(ws, "1", train="  frames_per_batch = 2")
    groups = []
    fit_group = TR.SingleFitRunner.fit_group
    monkeypatch.setattr(TR.SingleFitRunner, "fit_group",
                        lambda self, seq, group, *a: groups.append(
                            [f.frame_id for f in group]) or fit_group(self, seq, group, *a))
    TR.SingleFitRunner(conf, "c", device="cpu").fitting()
    assert groups == [[0, 1], [2]]
    pose_dir = os.path.join(ws, "fit_res", "view_4", "1", *SEQ, "pose_1")
    names = sorted(os.listdir(pose_dir))
    assert names == ["0.pickle", "1.pickle", "2.pickle"]
    poses = [_load(os.path.join(pose_dir, n)) for n in names]
    for p in poses:
        assert p["pred_joint3d"].dtype == np.float32 and np.isfinite(p["pred_joint3d"]).all()
    assert np.abs(poses[0]["pred_joint3d"] - poses[2]["pred_joint3d"]).max() > 1e-6
    before = {n: os.path.getmtime(os.path.join(pose_dir, n)) for n in names}
    TR.SingleFitRunner(conf, "c", device="cpu").fitting()
    assert groups == [[0, 1], [2]]
    assert before == {n: os.path.getmtime(os.path.join(pose_dir, n)) for n in names}


@pytest.mark.parametrize("cli, runner, argv", (
    ("fitting_video", "VideoFitRunner",
     ["--conf", "fit_confs/fit_123_8views_0.conf", "--case", "123_8view_id0", "--mode", "x",
      "--gpu", "0"]),
    ("get_res", "GetResRunner", ["--conf", "fit_confs/get_render_type12.conf", "--case",
                                 "render_res", "--render", "True"]),
    ("get_res", "GetResRunner", ["--conf", "fit_confs/get_res_12.conf", "--case", "r"]),
))
def test_clis_parse_the_jax_arguments(cli, runner, argv, monkeypatch):
    import importlib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(root)
    calls = {}

    def fake(tag):
        class Fake:
            def __init__(self, *args, **kwargs):
                calls[tag] = args

            def fitting(self):
                pass
        return Fake

    jmod = importlib.import_module(f"honerf_tpu.cli.{cli}")
    import honerf_tpu.fit.runner as JR

    monkeypatch.setattr(JR, runner, fake("jax"))
    monkeypatch.setattr(TR, runner, fake("port"))
    monkeypatch.setattr(sys, "argv", [cli] + argv)
    jmod.main()
    importlib.import_module(f"honerf_torch.cli.{cli}").main(argv)
    assert calls["port"] == calls["jax"]


def test_get_res_matches_jax(pipeline, tmp_path, monkeypatch):
    """get_res on '12''s fitted pose of frame 0, the port's GetResRunner and
    render_dual_views against the JAX runner's on the same nets and pose:
    the inner ids exactly; the sdf grids of the kernels' plain versions
    (bf16 weights) against JAX's XLA forwards, the hand's (K1) within atol
    2e-3 / rtol 1e-3 (tests/test_torch_fused_hand.py's bound), the
    object's (K4) within atol 5e-3 / rtol 1e-2 (tests/test_torch_fused_sdf.py's);
    the meshes' vertex and triangle counts exactly, their vertices within
    1e-4 of the box (the random nets have no zero level in their boxes: an
    empty mesh on both sides, so the grids carry the check); the render's
    8-bit image within one level (255 x the autograd field's 2e-4 < 1),
    with at most 255 x 2e-4 of its values a level apart."""
    from honerf_tpu.data import fit_datasets as JFD
    from honerf_tpu.extract import grid as JGrid
    from honerf_tpu.fit import runner as JR
    from honerf_tpu.train import runner as JTrain
    from honerf_torch.extract import grid as TGrid
    from honerf_torch.train import runner as TTrain
    from honerf_torch.utils.ply import load_ply

    ws = pipeline
    conf = _conf(ws, "12")
    fitted = _load(os.path.join(ws, "fit_res", "view_4", "12", *SEQ, "pose_12", "0.pickle"))
    monkeypatch.setitem(JFD.VIEW_LISTS, "4", JFD.VIEW_LISTS["8"][:4])
    for mod in (JFD, TFD):
        monkeypatch.setattr(mod, "RENDER_TEST_VIEWS", mod.VIEW_LISTS["8"][:1])
    images = {}
    for side, mod in (("jax", JTrain), ("port", TTrain)):
        monkeypatch.setattr(mod, "_write_image",
                            lambda path, img, side=side: images.setdefault(side, img))
    grids = {"jax": [], "port": []}
    for side, mod in (("jax", JGrid), ("port", TGrid)):
        def grid(*a, side=side, evaluate=mod.evaluate_sdf_grid, **k):
            grids[side].append(np.asarray(evaluate(*a, **k)))
            return grids[side][-1]
        monkeypatch.setattr(mod, "evaluate_sdf_grid", grid)
    out = {}
    for side, make, process, load in (
            ("jax", lambda r: JR.GetResRunner(conf, "c", render=r), "_process_frame",
             JFD.load_fit_sequence),
            ("port", lambda r: TR.GetResRunner(conf, "c", render=r, device="cpu"),
             "process_frame", TFD.load_fit_sequence)):
        for render in (False, True):
            r = make(render)
            seq = load(r.data_root, *SEQ, r.view_num, "1", r.fit_res_root, r.exp_root,
                       image_hw=(r.H, r.W), load_test_views=True)
            base = str(tmp_path / side)
            getattr(r, process)(seq, seq.frames[0], fitted, base, r.nets_for(seq))
        out[side] = base
    ids = [_load(os.path.join(out[s], "inner_12", "0.pickle"))["inner_point_id"]
           for s in ("jax", "port")]
    np.testing.assert_array_equal(ids[1], ids[0])
    assert len(grids["jax"]) == len(grids["port"]) == 2
    for part, want, got in zip(("hand", "obj"), grids["jax"], grids["port"]):
        assert got.shape == want.shape == (24, 24, 24), part
        assert np.ptp(want) > 1e-2, part
        atol, rtol = (2e-3, 1e-3) if part == "hand" else (5e-3, 1e-2)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=part)
        (vj, fj), (vp, fp) = [load_ply(os.path.join(out[s], "mesh_12", f"0_{part}.ply"))
                              for s in ("jax", "port")]
        assert vp.shape == vj.shape and fp.shape == fj.shape, part
        if len(vj):
            assert np.abs(vp - vj).max() <= 1e-4 * float(np.ptp(vj, axis=0).max()), part
    want, got = (images[s].astype(np.int64) for s in ("jax", "port"))
    assert got.shape == want.shape == (48, 56, 3)
    assert np.unique(want).size > 8 and np.abs(want - want[::-1]).max() > 8
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 255 * 2e-4
