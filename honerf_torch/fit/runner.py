"""The fitting stage's runners (counterpart of honerf_tpu.fit.runner):
single frames ('1', '12'; SingleFitRunner, frame-batched with
train.frames_per_batch > 1), video ('123', '1234'; VideoFitRunner) and
result extraction (GetResRunner: meshes, penetration ids, renders;
render_dual_views).

They load the frozen offline checkpoints (the JAX runner's npz layout, or
a reference .pth), fit the poses, and write the JAX runner's pose pickles,
meshes, inner-point ids and renders under ./fit_res with the reference's
directory scheme; a frame whose pickle exists is skipped (resume by
artifact), '12' starts from '1''s pickles and the video types from '12''s.

Not carried over, as TPU artifacts: several steps per dispatch
(`train.steps_per_dispatch`: the port steps once per (iteration, view)),
the padding of a short last group of frames (it runs with fewer frames),
and the tunnel's render-chunk rules.  Sharding the frames over several
devices (`train.frame_shard`, `train.data_parallel`) comes with a later
slice: on one device the runners do what the JAX runners do there.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from honerf_torch.camera import Camera, full_image_ndc_grid, xy_to_ray_bundle
from honerf_torch.config import load_config
from honerf_torch.data.datasets import FrameWindowSampler
from honerf_torch.data.fit_datasets import (
    VIEW_LISTS,
    FitFrame,
    FitSequence,
    list_fit_sequences,
    load_fit_sequence,
    load_sequence_manifest,
)
from honerf_torch.data.pixels import sample_rays
from honerf_torch.extract import bounds_from_points, extract_geometry, inner_point_ids
from honerf_torch.fit.single import (
    FitHyper,
    final_pose_numpy,
    final_poses_numpy,
    init_batched_fit_state,
    init_fit_state,
    make_batched_single_fit_step,
    make_single_fit_step,
    poses_numpy,
    select_fit_kernels,
)
from honerf_torch.fit.video import init_video_state, make_video_fit_step, window_pose
from honerf_torch.hand import bone_transforms_from_mano_joints
from honerf_torch.models.fields import color_config_from_conf, sdf_config_from_conf
from honerf_torch.render.dual import render_dual
from honerf_torch.render.neus import (
    RenderConfig,
    make_hand_field,
    make_obj_field,
    pack_hand_field,
    rays_to_object_frame,
)
from honerf_torch.train.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    load_torch_checkpoint,
    params_from_jax,
)
from honerf_torch.utils.device import resolve_device
from honerf_torch.utils.ply import save_ply

logger = logging.getLogger(__name__)


def load_model_params(model_dir: str, device=None) -> Dict[str, Any]:
    """{'sdf', 'color', 'variance'} of the latest offline checkpoint under
    <model_dir>/checkpoints: the npz layout of either runner, or a
    reference .pth (converted on the fly); tensors on `device` (the card
    unless the caller passes "cpu") that need no gradient."""
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    path = latest_checkpoint(ckpt_dir)
    if path is not None:
        tree = load_checkpoint(path)
        tree = tree["params"] if "params" in tree else tree
    else:
        pths = sorted(n for n in os.listdir(ckpt_dir)
                      if n.endswith(".pth")) if os.path.isdir(ckpt_dir) else []
        if not pths:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        tree = load_torch_checkpoint(os.path.join(ckpt_dir, pths[-1]))
    return params_from_jax({k: tree[k] for k in ("sdf", "color", "variance")}, device)


class _FitBase:
    """What the fitting runners share: the conf, the nets, the per-frame
    constants, the host ray sampler (np.random.default_rng(0), as the JAX
    runner's), the step log and the pose pickles."""

    def __init__(self, conf_path: str, case: str = "", device=None):
        self.device = resolve_device(device)
        self.conf_path = conf_path
        self.conf = load_config(conf_path, case)
        self.save_dir = self.conf["general.save_dir"]
        os.makedirs(self.save_dir, exist_ok=True)
        self.fit_type = self.conf.get_string("general.fit_type")
        self.view_num = str(self.conf["dataset.view_num"])
        self.data_root = self.conf.get_string("dataset.fitdata_dir")
        self.H, self.W = self.conf.get_list("dataset.image_size")
        self.fcfg = FitHyper.from_conf(self.conf)
        self.rcfg = RenderConfig.from_conf(self.conf["model.neus_renderer"])
        self.hand_sdf_cfg = sdf_config_from_conf("hand", self.conf["model.sdf_hand_network"])
        self.hand_color_cfg = color_config_from_conf(
            "hand", self.conf["model.rendering_hand_network"])
        self.obj_sdf_cfg = sdf_config_from_conf("obj", self.conf["model.sdf_obj_network"])
        self.obj_color_cfg = color_config_from_conf(
            "obj", self.conf["model.rendering_obj_network"])
        self.fit_res_root = self.conf.get_string("general.fit_res_root", "./fit_res")
        self.exp_root = self.conf.get_string("general.exp_root", "./exp")
        self._net_params: Optional[Dict[str, Any]] = None
        self._net_key: Optional[str] = None
        self.rng = np.random.default_rng(0)

    def nets_for(self, seq: FitSequence) -> Dict[str, Any]:
        key = seq.hand_model_path + "|" + seq.obj_model_path
        if self._net_key != key:
            self._net_params = {"hand": load_model_params(seq.hand_model_path, self.device),
                                "obj": load_model_params(seq.obj_model_path, self.device)}
            self._net_key = key
        return self._net_params

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def frame_consts(self, seq: FitSequence, frame: FitFrame) -> Dict[str, torch.Tensor]:
        """The frame's initial estimates and the sequence's constants; the
        ground truth rides along for the per-step diagnostics only."""
        return {k: self._tensor(v) for k, v in (
            ("joints_pred", frame.joints_pred), ("bone_length", seq.bone_length),
            ("t_pose_21", seq.t_pose_21), ("Ro_pred", frame.obj_pose_pred[:3, :3]),
            ("To_pred", frame.obj_pose_pred[:3, 3]), ("obj_verts", seq.obj_verts),
            ("gt_joint3d", frame.joints_gt), ("Ro_gt", frame.Ro_gt), ("To_gt", frame.To_gt))}

    def view_batch(self, frame: FitFrame, view_id: int, n_rays: int) -> Dict[str, np.ndarray]:
        """One view's ray batch on the host (numpy)."""
        v = frame.views[view_id]
        xy, rgb, m = sample_rays(v.image, v.mask, v.mask_xy, n_rays, threshold=1.0,
                                 rng=self.rng)
        return {"rays_xy": xy, "true_rgb": rgb, "true_mask": m, "cam_R": v.cam_R,
                "cam_T": v.cam_T, "focal": v.focal, "principal": v.principal}

    def device_batch(self, host: Dict[str, np.ndarray],
                     consts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A host batch on the device beside the frame's constants."""
        return dict(consts, **{k: self._tensor(v) for k, v in host.items()})

    def fit_kernels(self):
        """(fused_ladder, fine-pass mode) for this runner's device from the
        conf (select_fit_kernels); train.fused_ladder is read as the JAX
        runner reads it (conf.get_bool: unquoted `off` and "false" are
        strings to the parser), None when unset."""
        ladder = (None if self.conf.get("train.fused_ladder", None) is None
                  else self.conf.get_bool("train.fused_ladder"))
        return select_fit_kernels(ladder, self.conf.get("train.fused_fine", None),
                                  self.hand_sdf_cfg, self.device)

    def _log_fit_steps(self, labels: List[str], metrics: List[Dict[str, torch.Tensor]],
                       frame_ids: Optional[Sequence[int]] = None) -> None:
        """The reference's per-step line, from the steps' buffered tensors
        read in one device -> host copy: 0-d metrics, or with `frame_ids`
        (frame-batched fitting) one value a frame and a line a (step,
        frame)."""
        if not self.conf.get_bool("train.verbose_steps", True) or not metrics:
            return
        keys = list(metrics[0])
        vals = torch.stack([torch.stack([m[k] for k in keys]) for m in metrics]).cpu().numpy()
        for lab, row in zip(labels, vals):
            cols = [(f"frame: {fid}, ", row[:, g]) for g, fid in enumerate(frame_ids)] \
                if frame_ids is not None else [("", row)]
            for prefix, col in cols:
                v = dict(zip(keys, col))
                logger.info("%s%s loss: %.6f, color: %.6f, mask: %.6f, joint: %.6f, "
                            "obj_verts: %.6f, gt_joint: %.6f, gt_obj_verts: %.6f", prefix, lab,
                            v["loss"], v["color_loss"], v["mask_loss"], v["joint_loss"],
                            v["obj_verts_loss"], v.get("gt_joint_loss", np.nan),
                            v.get("gt_obj_verts_loss", np.nan))

    def save_pose(self, path: str, pose_np: Dict[str, np.ndarray], frame: FitFrame) -> None:
        param = dict(pose_np)
        param["gt_joint3d"] = np.asarray(frame.joints_gt)
        param["gt_Ro"] = np.asarray(frame.Ro_gt)
        param["gt_To"] = np.asarray(frame.To_gt)
        with open(path, "wb") as f:
            pickle.dump(param, f)


class SingleFitRunner(_FitBase):
    """fitting_single.py's workflow (fit types '1' and '12') on the card
    (device="cpu" runs the plain versions)."""

    def iter_num(self) -> int:
        """Iterations a frame: the reference's budget (30 for '1', 25 for
        '12', 10 more with 3 views), or `train.iter_num`."""
        n = {"1": 30, "12": 25}[self.fit_type] + (10 if self.view_num == "3" else 0)
        return self.conf.get_int("train.iter_num", n)

    def make_step(self, nets: Dict[str, Any], batched: bool = False):
        """The fit step on `nets` (frame-batched with `batched`), with the
        kernels fit_kernels picks from the conf for this runner's device."""
        fused, fine = self.fit_kernels()
        make = make_batched_single_fit_step if batched else make_single_fit_step
        return make(nets, self.hand_sdf_cfg, self.hand_color_cfg, self.obj_sdf_cfg,
                    self.obj_color_cfg, self.rcfg, self.fcfg, fused_ladder=fused,
                    fused_fine=fine)

    def fitting(self) -> None:
        iter_num = self.iter_num()
        # G > 1: G independent frames a step (the reference fits frames
        # one after another)
        frames_per_batch = max(1, self.conf.get_int("train.frames_per_batch", 1))
        for obj_name, frame_name in list_fit_sequences(self.data_root):
            seq = load_fit_sequence(self.data_root, obj_name, frame_name, self.view_num,
                                    self.fit_type, self.fit_res_root, self.exp_root,
                                    image_hw=(self.H, self.W))
            save_base = os.path.join(self.fit_res_root, f"view_{len(seq.frames[0].views)}",
                                     self.fit_type, obj_name, frame_name)
            pose_path = os.path.join(save_base, "pose_" + self.fit_type)
            os.makedirs(pose_path, exist_ok=True)
            cfg_dir = os.path.join(save_base, "config")
            os.makedirs(cfg_dir, exist_ok=True)
            if not os.path.exists(os.path.join(cfg_dir, "config.conf")):
                shutil.copy(self.conf_path, os.path.join(cfg_dir, "config.conf"))
            todo = [f for f in seq.frames
                    if not os.path.exists(os.path.join(pose_path, f"{f.frame_id}.pickle"))]
            if not todo:
                continue  # resume by artifact
            generator = torch.Generator(device=self.device).manual_seed(0)
            if frames_per_batch > 1:
                step = self.make_step(self.nets_for(seq), batched=True)
                for gs in range(0, len(todo), frames_per_batch):
                    self.fit_group(seq, todo[gs:gs + frames_per_batch], step, iter_num,
                                   generator, pose_path)
                continue
            step = self.make_step(self.nets_for(seq))
            for frame in todo:
                self.fit_frame(seq, frame, step, iter_num, generator, pose_path)

    def fit_frame(self, seq: FitSequence, frame: FitFrame, step, iter_num: int,
                  generator: torch.Generator, pose_path: str) -> None:
        """iter_num x views steps from the frame's initial pose, then its
        pickle under pose_path."""
        self.fit_group(seq, [frame], step, iter_num, generator, pose_path, False)

    def fit_group(self, seq: FitSequence, group: List[FitFrame], step, iter_num: int,
                  generator: torch.Generator, pose_path: str, batched: bool = True) -> None:
        """iter_num x views steps from the initial poses of `group`, then a
        pickle a frame under pose_path: with `batched` one step of the G
        frames (a short last group with fewer; each frame's rays sampled
        in frame order), else the one frame's step."""
        consts = [self.frame_consts(seq, f) for f in group]
        if batched:
            consts = {k: torch.stack([c[k] for c in consts]) for k in consts[0]}
            state = init_batched_fit_state(len(group), self.device)
        else:
            consts = consts[0]
            state = init_fit_state(self.device)
        schedule = [(it, v) for it in range(iter_num) for v in range(len(group[0].views))]
        metrics = []
        for _it, view_id in schedule:
            rows = [self.view_batch(f, view_id, self.fcfg.batch_size) for f in group]
            host = {k: np.stack([r[k] for r in rows]) for k in rows[0]} if batched else rows[0]
            state, m = step(state, self.device_batch(host, consts), generator)
            metrics.append(m)
        ids = [f.frame_id for f in group]
        self._log_fit_steps([f"iter: {it}, view: {v}," for it, v in schedule], metrics,
                            frame_ids=ids if batched else None)
        if batched:
            poses = final_poses_numpy(state["pose"], consts, len(group))
            logger.info("fitted frames %s (batched G=%d)", ids, len(group))
        else:
            poses = [final_pose_numpy(state["pose"], consts)]
            if metrics:
                logger.info("frame %d: loss=%.4f joint=%.4f", ids[0],
                            float(metrics[-1]["loss"]), float(metrics[-1]["joint_loss"]))
        for f, pose_np in zip(group, poses):
            self.save_pose(os.path.join(pose_path, f"{f.frame_id}.pickle"), pose_np, f)


class VideoFitRunner(_FitBase):
    """fitting_video.py's workflow (fit types '123' and '1234') on the card
    (device="cpu" runs the plain versions): one sequence (general.fit_id
    of the general.sequence_list manifest, else of the data tree), its
    per-frame tables fitted over sliding 4-frame windows, sub_iters x
    views steps a window, epochs over the windows, the poses of every
    epoch under pose_<epoch>."""

    WINDOW = 4
    RAYS_PER_FRAME = 40   # train.rays_per_frame's default

    def fitting(self) -> None:
        fit_id = self.conf.get_int("general.fit_id", 0)
        manifest = self.conf.get_string("general.sequence_list",
                                        "./sequence_list_for_fitting.pickle")
        if os.path.exists(manifest):
            entry = load_sequence_manifest(manifest)[fit_id]
            pairs = [(entry["obj_name"], entry["frame_name"])]
        else:
            pairs = [list_fit_sequences(self.data_root)[fit_id]]
        for obj_name, frame_name in pairs:
            self.fit_sequence(obj_name, frame_name)

    def make_step(self, nets: Dict[str, Any], n_frames: int):
        """The video step on `nets` with the kernels fit_kernels picks."""
        if self.conf.get_bool("train.frame_shard", False) and n_frames >= self.WINDOW:
            logger.warning("train.frame_shard requested but 1 device(s) share no divisor with "
                           "the %d-frame window — using the single-device step", self.WINDOW)
        fused, fine = self.fit_kernels()
        return make_video_fit_step(nets, self.hand_sdf_cfg, self.hand_color_cfg,
                                   self.obj_sdf_cfg, self.obj_color_cfg, self.rcfg, self.fcfg,
                                   n_frames, fused_ladder=fused, fused_fine=fine)

    def fit_sequence(self, obj_name: str, frame_name: str) -> None:
        seq = load_fit_sequence(self.data_root, obj_name, frame_name, self.view_num,
                                self.fit_type, self.fit_res_root, self.exp_root,
                                image_hw=(self.H, self.W))
        n_frames = len(seq)
        step = self.make_step(self.nets_for(seq), n_frames)
        state = init_video_state(n_frames, self.device)
        save_base = os.path.join(self.fit_res_root, f"view_{len(seq.frames[0].views)}",
                                 self.fit_type, obj_name, frame_name)
        generator = torch.Generator(device=self.device).manual_seed(0)
        n_epochs = self.conf.get_int("train.epochs", 5)
        sub_iters = self.conf.get_int("train.sub_iters", 4)
        rays_per_frame = self.conf.get_int("train.rays_per_frame", self.RAYS_PER_FRAME)
        n_views = len(seq.frames[0].views)
        metrics = []
        for epoch in range(n_epochs):
            for idx in FrameWindowSampler(n_frames, self.WINDOW):
                frames = [seq.frames[i] for i in idx]
                consts = self.window_consts(seq, frames, idx)
                schedule = [(sub, v) for sub in range(sub_iters) for v in range(n_views)]
                metrics = []
                for i, (_sub, view_id) in enumerate(schedule):
                    batch = dict(consts, **self.window_view_batch(frames, view_id,
                                                                  rays_per_frame))
                    # the reference skips the boundary anchor on each window's
                    # first (sub-iteration, view) step of epoch 0
                    batch["anchor_enabled"] = self._tensor(
                        0.0 if epoch == 0 and i == 0 else 1.0)
                    state, m = step(state, batch, generator)
                    metrics.append(m)
                self._log_fit_steps([f"iter: {epoch}, index: {idx[0]}, view: {v},"
                                     for _sub, v in schedule], metrics)
            if metrics:
                logger.info("epoch %d: loss=%.4f smooth=%.4f", epoch,
                            float(metrics[-1]["loss"]), float(metrics[-1]["smooth_loss"]))
            self.save_epoch_poses(seq, state["tables"], save_base, epoch,
                                  final=epoch == n_epochs - 1)

    def window_consts(self, seq: FitSequence, frames: List[FitFrame],
                      idx: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The window's frame indices, initial estimates and ground truth
        (a leading frame axis) and the object's vertices."""
        F = len(frames)
        out = {k: self._tensor(v) for k, v in (
            ("joints_pred", np.stack([f.joints_pred for f in frames])),
            ("bone_length", np.tile(seq.bone_length[None], (F, 1))),
            ("t_pose_21", np.tile(seq.t_pose_21[None], (F, 1, 1))),
            ("Ro_pred", np.stack([f.obj_pose_pred[:3, :3] for f in frames])),
            ("To_pred", np.stack([f.obj_pose_pred[:3, 3] for f in frames])),
            ("obj_verts", seq.obj_verts),
            ("gt_joint3d", np.stack([f.joints_gt for f in frames])),
            ("Ro_gt", np.stack([f.Ro_gt for f in frames])),
            ("To_gt", np.stack([f.To_gt for f in frames])))}
        out["index"] = torch.as_tensor(list(idx), dtype=torch.int64, device=self.device)
        return out

    def window_view_batch(self, frames: List[FitFrame], view_id: int,
                          n_rays: int) -> Dict[str, torch.Tensor]:
        """One view's rays of every frame of the window (frame order), the
        view's camera from the window's first frame."""
        rows = [sample_rays(f.views[view_id].image, f.views[view_id].mask,
                            f.views[view_id].mask_xy, n_rays, threshold=1.0, rng=self.rng)
                for f in frames]
        v0 = frames[0].views[view_id]
        return {k: self._tensor(v) for k, v in (
            ("rays_xy", np.stack([r[0] for r in rows])), ("true_rgb", np.stack([r[1] for r in rows])),
            ("true_mask", np.stack([r[2] for r in rows])), ("cam_R", v0.cam_R),
            ("cam_T", v0.cam_T), ("focal", v0.focal), ("principal", v0.principal))}

    def save_epoch_poses(self, seq: FitSequence, tables, save_base: str, epoch: int,
                         final: bool = False) -> None:
        """Every frame's pose pickle under pose_<epoch>; with
        general.get_render_all each frame's first view rendered under
        render_<epoch> after the last epoch (general.render_every_epoch:
        after every epoch)."""
        pose_path = os.path.join(save_base, f"pose_{epoch}")
        os.makedirs(pose_path, exist_ok=True)
        do_render = self.conf.get_bool("general.get_render_all", False) and (
            final or self.conf.get_bool("general.render_every_epoch", False))
        render_path = os.path.join(save_base, f"render_{epoch}")
        if do_render:
            os.makedirs(render_path, exist_ok=True)
        consts = self.window_consts(seq, seq.frames, range(len(seq)))
        with torch.no_grad():
            poses = poses_numpy(*window_pose(tables, consts))
        for frame, pose in zip(seq.frames, poses):
            self.save_pose(os.path.join(pose_path, f"{frame.frame_id}.pickle"), pose, frame)
            if do_render:
                render_dual_views(self, self.nets_for(seq), seq, pose["pred_joint3d"],
                                  pose["pred_Ro"], pose["pred_To"], frame.views[:1], render_path)


class GetResRunner(_FitBase):
    """get_res.py's workflow: from the fitted poses, the hand's and the
    object's meshes ('1', '12'), the object vertices inside the hand
    ('12', '123', '1234'), or with `render` full-image dual renders of the
    held-out views; fit type '0' uses the networks' initial estimates.
    The sdf grids and the inner-point query run through the kernels' sdf
    wrappers (FusedHandSDF: K1; FusedObjSDF: K4), their plain versions on
    the CPU.  `timings` collects per frame the seconds of each part."""

    def __init__(self, conf_path: str, case: str = "", render: bool = False, device=None):
        super().__init__(conf_path, case, device)
        self.render = render
        self.timings: List[Dict[str, float]] = []
        self._sdf_packs = None

    def _pose_dir_name(self, base_dir: str) -> str:
        """'1' / '12' read their own pose dir; the video types the highest
        pose_<n> on disk (the last epoch's), else train.epochs - 1."""
        if self.fit_type in ("1", "12"):
            return "pose_" + self.fit_type
        nums = []
        if os.path.isdir(base_dir):
            for name in os.listdir(base_dir):
                if name.startswith("pose_") and name[5:].isdigit():
                    nums.append(int(name[5:]))
        if nums:
            return f"pose_{max(nums)}"
        return f"pose_{self.conf.get_int('train.epochs', 5) - 1}"

    def fitting(self) -> None:
        for obj_name, frame_name in list_fit_sequences(self.data_root):
            seq = load_fit_sequence(self.data_root, obj_name, frame_name, self.view_num, "1",
                                    self.fit_res_root, self.exp_root, image_hw=(self.H, self.W),
                                    load_test_views=self.render)
            nets = self.nets_for(seq)
            view_dir = f"view_{len(VIEW_LISTS[self.view_num])}"
            save_base = os.path.join(self.fit_res_root, "analys_res", view_dir, self.fit_type,
                                     obj_name, frame_name)
            if self.fit_type == "0":
                # the networks' initial estimates
                for frame in seq.frames:
                    fitted = {"pred_joint3d": frame.joints_pred,
                              "pred_Ro": frame.obj_pose_pred[:3, :3],
                              "pred_To": frame.obj_pose_pred[:3, 3]}
                    self.process_frame(seq, frame, fitted, save_base, nets)
                continue
            fit_base = os.path.join(self.fit_res_root, view_dir, self.fit_type, obj_name,
                                    frame_name)
            pose_dir = os.path.join(fit_base, self._pose_dir_name(fit_base))
            if not os.path.isdir(pose_dir):
                logger.warning("no fitted poses at %s", pose_dir)
                continue
            for frame in seq.frames:
                pose_file = os.path.join(pose_dir, f"{frame.frame_id}.pickle")
                if not os.path.exists(pose_file):
                    continue
                with open(pose_file, "rb") as f:
                    fitted = pickle.load(f)
                self.process_frame(seq, frame, fitted, save_base, nets)

    def sdf_fns(self, nets: Dict[str, Any]):
        """(FusedHandSDF, FusedObjSDF) of the nets, packed once."""
        from honerf_torch.ops.fused_hand import FusedHandSDF
        from honerf_torch.ops.fused_sdf import FusedObjSDF

        if self._sdf_packs is None or self._sdf_packs[0] is not nets:
            self._sdf_packs = (nets, FusedHandSDF(nets["hand"]["sdf"], self.hand_sdf_cfg),
                               FusedObjSDF(nets["obj"]["sdf"], self.obj_sdf_cfg))
        return self._sdf_packs[1:]

    def process_frame(self, seq: FitSequence, frame: FitFrame, fitted: Dict[str, Any],
                      save_base: str, nets: Dict[str, Any]) -> None:
        joints = np.asarray(fitted["pred_joint3d"], np.float32)
        obj_r = np.asarray(fitted["pred_Ro"], np.float32)
        obj_t = np.asarray(fitted["pred_To"], np.float32)
        rec: Dict[str, float] = {"frame": frame.frame_id}
        self.timings.append(rec)
        if self.render:
            render_path = os.path.join(save_base, "render_" + self.fit_type)
            os.makedirs(render_path, exist_ok=True)
            t0 = time.perf_counter()
            render_dual_views(self, nets, seq, joints, obj_r, obj_t, frame.test_views,
                              render_path)
            rec["render_s"] = time.perf_counter() - t0
            return
        fused_hand, fused_obj = self.sdf_fns(nets)
        with torch.no_grad():
            bt_inv = bone_transforms_from_mano_joints(self._tensor(joints)[None])[0]
        t_pose = self._tensor(seq.t_pose_21)
        r_t, t_t = self._tensor(obj_r), self._tensor(obj_t)

        def hand_sdf(pts):
            return fused_hand(pts, bt_inv, t_pose)

        def obj_sdf_world(pts):
            return fused_obj((pts - t_t) @ r_t)

        cur_obj_verts = seq.obj_verts @ obj_r.T + obj_t
        resolution = self.conf.get_int("train.mesh_resolution", 64)
        if self.fit_type in ("1", "12"):
            mesh_path = os.path.join(save_base, "mesh_" + self.fit_type)
            os.makedirs(mesh_path, exist_ok=True)
            for part, fn, pts in (("hand", hand_sdf, joints), ("obj", obj_sdf_world,
                                                              cur_obj_verts)):
                lo, hi = bounds_from_points(pts, 0.08)
                t = {}
                verts, tris = extract_geometry(fn, lo, hi, resolution, device=self.device,
                                               timings=t)
                t0 = time.perf_counter()
                save_ply(os.path.join(mesh_path, f"{frame.frame_id}_{part}.ply"), verts, tris)
                rec.update({f"{part}_grid_s": t["grid_s"], f"{part}_mc_s": t["mc_s"],
                            f"{part}_ply_s": time.perf_counter() - t0,
                            f"{part}_verts": len(verts)})
        if self.fit_type in ("12", "123", "1234"):
            inner_path = os.path.join(save_base, "inner_" + self.fit_type)
            os.makedirs(inner_path, exist_ok=True)
            t0 = time.perf_counter()
            ids = inner_point_ids(hand_sdf, cur_obj_verts, device=self.device)
            rec["inner_s"] = time.perf_counter() - t0
            with open(os.path.join(inner_path, f"{frame.frame_id}.pickle"), "wb") as f:
                pickle.dump({"inner_point_id": ids}, f)


def render_dual_views(runner: _FitBase, nets: Dict[str, Any], seq: FitSequence,
                      joints: np.ndarray, obj_r: np.ndarray, obj_t: np.ndarray,
                      views: List[Any], render_path: str, chunk: int = 4096) -> None:
    """Full-image dual-volume renders of `views` at a fitted pose, one PNG
    a view under render_path (the view's name): forward only, perturb 0,
    in requests of `chunk` rays, one device -> host copy an image.  The
    hand's kernels as the runner's fit step picks them (on the card K1's
    ladder and the fine-pass mode's forward on weights packed once)."""
    from honerf_torch.train.runner import _write_image

    dev = runner.device
    fused, fine = runner.fit_kernels()
    rcfg = runner.rcfg._replace(perturb=0.0)
    t = runner._tensor
    with torch.no_grad():
        bt_inv = bone_transforms_from_mano_joints(t(joints)[None])[0]
        packs = pack_hand_field(nets["hand"], runner.hand_sdf_cfg, runner.hand_color_cfg, fused,
                                fine)
        hand_field = make_hand_field(nets["hand"], runner.hand_sdf_cfg, runner.hand_color_cfg,
                                     bt_inv, t(seq.t_pose_21), packs)
        obj_field = make_obj_field(nets["obj"], runner.obj_sdf_cfg, runner.obj_color_cfg)
        r_t, t_t = t(obj_r), t(obj_t)
        H, W = runner.H, runner.W
        grid = full_image_ndc_grid(H, W, device=dev)
        for tv in views:
            cam = Camera(R=t(tv.cam_R), T=t(tv.cam_T), focal=t(tv.focal),
                         principal=t(tv.principal))
            outs = []
            for s in range(0, grid.shape[0], chunk):
                rb = xy_to_ray_bundle(cam, grid[s:s + chunk])
                oo, do = rays_to_object_frame(rb.origins, rb.directions, r_t, t_t)
                outs.append(render_dual(hand_field, obj_field, rcfg, None, rb.origins,
                                        rb.directions, oo, do, runner.fcfg.near,
                                        runner.fcfg.far)["color_fine"])
            img = torch.cat(outs).reshape(H, W, 3).cpu().numpy()
            _write_image(os.path.join(render_path, tv.name),
                         np.clip(img * 255, 0, 255).astype(np.uint8))
