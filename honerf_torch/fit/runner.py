"""The fitting stage's runner for single frames (fit types '1' and '12');
counterpart of honerf_tpu.fit.runner (load_model_params, _FitBase,
SingleFitRunner).

It loads the frozen offline checkpoints (the JAX runner's npz layout, or
a reference .pth), fits the pose per frame, one Adam step per (iteration,
view), and writes the JAX runner's pose pickles under ./fit_res with the
reference's directory scheme; a frame whose pickle exists is skipped
(resume by artifact), and '12' starts from '1''s pickles.

Not carried over: several steps per dispatch (`train.steps_per_dispatch`,
a TPU artifact: the port steps once per (iteration, view)), and
frame-batched fitting (`train.frames_per_batch` > 1, a vmap of the step),
which comes with the video fitter.  The video fitter and result
extraction (VideoFitRunner, GetResRunner) come in a later slice.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from honerf_torch.config import load_config
from honerf_torch.data.fit_datasets import (
    FitFrame,
    FitSequence,
    list_fit_sequences,
    load_fit_sequence,
)
from honerf_torch.data.pixels import sample_rays
from honerf_torch.fit.single import (
    FitHyper,
    final_pose_numpy,
    init_fit_state,
    make_single_fit_step,
    select_fit_kernels,
)
from honerf_torch.models.fields import color_config_from_conf, sdf_config_from_conf
from honerf_torch.render.neus import RenderConfig
from honerf_torch.train.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    load_torch_checkpoint,
    params_from_jax,
)
from honerf_torch.utils.device import resolve_device

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

    def _log_fit_steps(self, labels: List[str], metrics: List[Dict[str, torch.Tensor]]) -> None:
        """The reference's per-step line, from the steps' buffered 0-d
        tensors read in one device -> host copy per frame."""
        if not self.conf.get_bool("train.verbose_steps", True) or not metrics:
            return
        keys = list(metrics[0])
        vals = torch.stack([torch.stack([m[k] for k in keys]) for m in metrics]).cpu().numpy()
        for lab, row in zip(labels, vals):
            v = dict(zip(keys, row))
            logger.info("%s loss: %.6f, color: %.6f, mask: %.6f, joint: %.6f, "
                        "obj_verts: %.6f, gt_joint: %.6f, gt_obj_verts: %.6f", lab, v["loss"],
                        v["color_loss"], v["mask_loss"], v["joint_loss"], v["obj_verts_loss"],
                        v.get("gt_joint_loss", np.nan), v.get("gt_obj_verts_loss", np.nan))

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

    def make_step(self, nets: Dict[str, Any]):
        """The fit step on `nets`, with the kernels select_fit_kernels
        picks from the conf for this runner's device."""
        # read as the JAX runner does (conf.get_bool: unquoted `off` and
        # "false" are strings to the parser), None when unset
        ladder = (None if self.conf.get("train.fused_ladder", None) is None
                  else self.conf.get_bool("train.fused_ladder"))
        fused, fine = select_fit_kernels(ladder,
                                         self.conf.get("train.fused_fine", None),
                                         self.hand_sdf_cfg, self.device)
        return make_single_fit_step(nets, self.hand_sdf_cfg, self.hand_color_cfg,
                                    self.obj_sdf_cfg, self.obj_color_cfg, self.rcfg, self.fcfg,
                                    fused_ladder=fused, fused_fine=fine)

    def fitting(self) -> None:
        iter_num = self.iter_num()
        if self.conf.get_int("train.frames_per_batch", 1) > 1:
            raise NotImplementedError(
                "train.frames_per_batch > 1 (frame-batched fitting) is not ported: it comes "
                "with the video fitter's slice")
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
            step = self.make_step(self.nets_for(seq))
            generator = torch.Generator(device=self.device).manual_seed(0)
            for frame in todo:
                self.fit_frame(seq, frame, step, iter_num, generator,
                               os.path.join(pose_path, f"{frame.frame_id}.pickle"))

    def fit_frame(self, seq: FitSequence, frame: FitFrame, step, iter_num: int,
                  generator: torch.Generator, pose_file: str) -> None:
        """iter_num x views steps from the initial pose, then the pickle."""
        consts = self.frame_consts(seq, frame)
        state = init_fit_state(self.device)
        schedule = [(it, v) for it in range(iter_num) for v in range(len(frame.views))]
        metrics = []
        for _it, view_id in schedule:
            batch = self.device_batch(self.view_batch(frame, view_id, self.fcfg.batch_size),
                                      consts)
            state, m = step(state, batch, generator)
            metrics.append(m)
        self._log_fit_steps([f"iter: {it}, view: {v}," for it, v in schedule], metrics)
        if metrics:
            logger.info("frame %d: loss=%.4f joint=%.4f", frame.frame_id,
                        float(metrics[-1]["loss"]), float(metrics[-1]["joint_loss"]))
        self.save_pose(pose_file, final_pose_numpy(state["pose"], consts), frame)
