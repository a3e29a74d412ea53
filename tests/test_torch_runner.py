"""The port's offline runner and its CLI on the CPU (plain versions of the
kernels), mirroring tests/test_runner_cli.py and tests/test_hand_runner.py
with their small confs: train with checkpoints, resume and continue, test
renders, meshes, stop_at with the metrics truncation, the hand branch,
and the command line's argument handling."""

import json
import os

import numpy as np
import pytest
import torch

from honerf_torch.data.synthetic import generate_hand_dataset, generate_object_dataset
from honerf_torch.ops import fused_sdf as FS
from honerf_torch.train.runner import OfflineRunner
from honerf_torch.utils.ply import load_ply
from test_hand_runner import HAND_CONF
from test_runner_cli import SMALL_CONF

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("port_runner_ws")
    generate_object_dataset(str(ws / "data"), n_frames=1, n_views=4, H=48, W=56)
    conf_path = ws / "small.conf"
    conf_path.write_text(SMALL_CONF.format(exp_dir=str(ws / "exp"), data_dir=str(ws / "data")))
    return ws, str(conf_path)


def _runner(conf, **kw):
    return OfflineRunner(conf, case="bean", device="cpu", **kw)


def test_runner_train_checkpoint_resume(workspace):
    ws, conf = workspace
    runner = _runner(conf, mode="train")
    runner.train()
    assert runner.iter_step == 12
    assert sorted(os.listdir(ws / "exp" / "checkpoints")) == ["ckpt_000006.npz",
                                                              "ckpt_000012.npz"]
    lines = [json.loads(line) for line in open(ws / "exp" / "logs" / "metrics.jsonl")]
    assert [rec["step"] for rec in lines] == list(range(1, 13))
    for k in ["loss", "color_loss", "mask_loss", "eikonal_loss", "psnr", "s_val", "cdf",
              "weight_max", "grad_norm"]:
        assert np.isfinite(lines[0][k]), k
    assert os.path.exists(ws / "exp" / "recording" / "config.conf")
    assert os.path.exists(ws / "exp" / "recording" / "honerf_torch" / "ops" / "fused_sdf.py")

    runner2 = _runner(conf, mode="test", is_continue=True)
    assert runner2.iter_step == 12 and runner2.state["step"] == 12
    assert torch.equal(runner.state["params"]["sdf"]["layers"][0]["v"],
                       runner2.state["params"]["sdf"]["layers"][0]["v"])
    # the optimizer state survives the npz round trip: training continues
    runner3 = _runner(conf, mode="train", is_continue=True)
    runner3.tcfg = runner3.tcfg._replace(end_iter=16)
    runner3.train()
    assert runner3.iter_step == 16


def test_runner_test_render_and_mesh(workspace):
    """Test renders, and a mesh per view through K4's plain version.  The
    field after 12 steps is still near its geometric init (sdf ~ |x| -
    0.5), whose zero level lies outside the obj-real +-0.2 mesh box, so
    the meshes are taken at a threshold between the field's values at the
    box's centre and corner, as chip_smoke.py does."""
    ws, conf = workspace
    runner = _runner(conf, mode="test", is_continue=True)
    runner.test()
    renders = sorted(os.listdir(ws / "exp" / "test_render"))
    assert renders == sorted(v.name.replace(".pickle", ".png") for v in runner.test_scene.views)
    fused = FS.FusedObjSDF(runner.state["params"]["sdf"], runner.sdf_cfg)
    centre, corner = fused(torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.2, 0.2]])).tolist()
    assert centre < corner
    recs = runner.validate_mesh(resolution=32, threshold=0.5 * (centre + corner))
    meshes = sorted(os.listdir(ws / "exp" / "meshes"))
    assert len(meshes) == 4 and len(recs) == 4
    v, f = load_ply(str(ws / "exp" / "meshes" / meshes[0]))
    assert len(v) > 0 and len(f) > 0 and (len(v), len(f)) == (recs[0]["n_verts"],
                                                               recs[0]["n_tris"])
    assert np.abs(v).max() <= 200.0 + 1e-3  # millimetres inside the +-0.2 m box


def test_train_stop_at_pauses_without_schedule_shift(tmp_path):
    from honerf_torch.train.schedule import make_lr_schedule

    ws = str(tmp_path)
    data_dir = os.path.join(ws, "data")
    generate_object_dataset(data_dir, n_views=4, H=48, W=56)
    split = os.path.join(ws, "split.conf")
    with open(split, "w") as f:
        f.write(SMALL_CONF.format(exp_dir=os.path.join(ws, "split"), data_dir=data_dir))

    def lr_at(runner, s):
        t = runner.tcfg
        return make_lr_schedule(t.learning_rate, t.warm_up_end, t.end_iter,
                                t.learning_rate_alpha)(s)

    r = _runner(split, mode="train")
    lr_full_9 = lr_at(r, 9)
    r.train(stop_at=6)
    assert r.iter_step == 6
    assert os.path.exists(os.path.join(ws, "split", "checkpoints", "ckpt_000006.npz"))
    metrics_path = os.path.join(ws, "split", "logs", "metrics.jsonl")
    with open(metrics_path, "a") as f:
        f.write(json.dumps({"step": 7, "loss": 123.0}) + "\n")  # past the checkpoint
        f.write(json.dumps({"note": "config-stamp"}) + "\n")   # no step: kept
        f.write('{"step": 8, "lo')                              # torn
    r2 = _runner(split, mode="train", is_continue=True)
    recs = [json.loads(line) for line in open(metrics_path).read().splitlines()]
    assert not any(rec.get("step", 0) > 6 for rec in recs)
    assert any("note" in rec for rec in recs)
    assert r2.iter_step == 6
    assert lr_at(r2, 9) == lr_full_9
    r2.train()
    recs = [json.loads(line) for line in open(metrics_path)]
    assert [rec["step"] for rec in recs if "step" in rec] == list(range(1, 13))


def test_metrics_logger_writes_tensorboard_events(tmp_path):
    from honerf_torch.train.runner import MetricsLogger
    from honerf_torch.utils.tbevents import read_events

    logger = MetricsLogger(str(tmp_path / "logs" / "metrics.jsonl"), flush_every=2,
                           tensorboard_dir=str(tmp_path / "logs"))
    for step in (1, 2, 3):
        logger.log(step, {"loss": torch.tensor(0.5 * step), "psnr": torch.tensor(20.0)})
    logger.flush()
    lines = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [(r["step"], r["loss"]) for r in lines] == [(1, 0.5), (2, 1.0), (3, 1.5)]
    (events,) = [p for p in os.listdir(tmp_path / "logs") if p.startswith("events.out")]
    got = read_events(str(tmp_path / "logs" / events))
    assert [(s, v["Loss/loss"]) for s, v in got] == [(1, 0.5), (2, 1.0), (3, 1.5)]


def test_hand_runner_train_and_mesh(tmp_path):
    """The hand branch: train, a checkpoint, pose-conditioned meshes
    through K1's plain version (the near-init hand field may have no zero
    crossing in the box: the meshes must load, possibly empty)."""
    data_dir = tmp_path / "data"
    generate_hand_dataset(str(data_dir), n_frames=1, n_views=3, H=48, W=56)
    conf = tmp_path / "hand.conf"
    conf.write_text(HAND_CONF.format(exp_dir=str(tmp_path / "exp"), data_dir=str(data_dir)))
    runner = OfflineRunner(str(conf), mode="train", case="hand1", device="cpu")
    runner.train()
    assert runner.iter_step == 8
    assert os.path.exists(tmp_path / "exp" / "checkpoints" / "ckpt_000008.npz")
    runner.validate_mesh(resolution=24)
    meshes = os.listdir(tmp_path / "exp" / "meshes")
    assert len(meshes) == 3
    v, _ = load_ply(str(tmp_path / "exp" / "meshes" / meshes[0]))
    assert np.isfinite(v).all()


def test_runner_needs_a_card_unless_cpu_is_asked(workspace):
    _, conf = workspace
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OfflineRunner(conf, mode="test")


def test_cli_arguments(workspace, monkeypatch):
    from honerf_torch.cli import exp_runner

    _, conf = workspace
    with pytest.raises(SystemExit, match="unknown mode"):
        exp_runner.main(["--mode", "render", "--conf", conf])
    with pytest.raises(SystemExit, match="not found"):
        exp_runner.main(["--mode", "test", "--conf", conf + ".missing"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            exp_runner.main(["--mode", "test", "--conf", conf])

    calls = []

    class Recorder:
        def __init__(self, *args, device=None):
            calls.append(("init", args, device))

        def train(self):
            calls.append(("train",))

        def test(self):
            calls.append(("test",))

        def validate_mesh(self, resolution, threshold):
            calls.append(("mesh", resolution, threshold))

    monkeypatch.setattr("honerf_torch.train.runner.OfflineRunner", Recorder)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp_runner.main(["--mode", "mesh", "--conf", conf, "--mcube_threshold", "-0.1",
                     "--is_continue", "--gpu", "1", "--case", "bean"])
    exp_runner.main(["--conf", conf])
    assert calls == [("init", (conf, "mesh", "bean", True), torch.device("cuda", 1)),
                     ("mesh", 256, -0.1),
                     ("init", (conf, "train", "", False), torch.device("cuda", 0)),
                     ("train",)]
