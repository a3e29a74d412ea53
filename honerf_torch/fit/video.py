"""Video pose fitting, fit types '123' and '1234' (counterpart of
honerf_tpu.fit.video).

Per-frame refinement tables over the whole sequence, optimized over
sliding 4-frame windows with render + pose-regularizer + interaction +
smoothness (+ cross-frame stability for '1234') losses.

The frames of a window run in a loop: each builds its own hand field from
its own bone transforms and renders through render_dual as the single
fitter does, with the kernels select_fit_kernels picks (on the card K1 for
the ladder, K2 f32 and the frozen K3 f32 for the fine pass), and the
outputs are concatenated in frame order.  (The JAX step vmaps the frames
and so runs the unfused field, Pallas having no batching rule; the math is
the same.)  The stable term's hand sdf at the object's vertices goes
through the autograd field: K1 has no backward.

The tables are whole tensors under one Adam group each, as optax's
multi_transform keeps them: the window's rows are gathered inside the loss,
so their gradient is dense, zero outside the window, and rows of earlier
windows keep moving on their moments.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from honerf_torch.camera import Camera, xy_to_ray_bundle
from honerf_torch.fit.single import POSE_KEYS, FitHyper
from honerf_torch.hand import bone_transforms_from_mano_joints, refined_hand_joints
from honerf_torch.models.fields import ColorConfig, SDFConfig
from honerf_torch.render.dual import render_dual
from honerf_torch.render.losses import (
    contact_loss,
    mask_bce,
    penetration_loss,
    pose_l2,
    smooth_loss,
    stable_loss_cross,
)
from honerf_torch.render.neus import (
    RenderConfig,
    make_hand_field,
    make_obj_field,
    pack_hand_field,
    rays_to_object_frame,
)
from honerf_torch.utils.transforms import rot6d_to_matrix

Params = Dict[str, Any]

#: Adam's learning rate per table (the reference fitting_video.py)
VIDEO_FIT_LRS = {
    "obj_rot6": 1e-4,
    "obj_trans": 1e-4,
    "palm_rot6": 1e-4,
    "palm_trans": 1e-4,
    "joint_angle": 1e-4,
    "palm_angle": 5e-4,
}


def init_video_tables(n_frames: int, device=None) -> Params:
    """The per-frame refinement tables at their start (rot6d at identity,
    the rest zero): leaves that require grad, rows indexed by frame."""
    eye62 = torch.eye(3, device=device)[:, :2]
    tables = {
        "obj_rot6": eye62[None].repeat(n_frames, 1, 1),
        "obj_trans": torch.zeros((n_frames, 3), device=device),
        "palm_rot6": eye62[None].repeat(n_frames, 1, 1),
        "palm_trans": torch.zeros((n_frames, 3), device=device),
        "joint_angle": torch.zeros((n_frames, 20), device=device),
        "palm_angle": torch.zeros((n_frames, 7), device=device),
    }
    return {k: v.requires_grad_(True) for k, v in tables.items()}


def init_video_state(n_frames: int, device=None,
                     lrs: Dict[str, float] = VIDEO_FIT_LRS) -> Dict[str, Any]:
    """{'tables': init_video_tables(), 'opt': Adam with one group, and its
    own rate, per table (beta 0.9 / 0.999, eps 1e-8)}."""
    tables = init_video_tables(n_frames, device)
    opt = torch.optim.Adam([{"params": [tables[k]], "lr": lrs[k]} for k in POSE_KEYS],
                           betas=(0.9, 0.999), eps=1e-8)
    return {"tables": tables, "opt": opt}


def window_pose(tables: Params, batch: Dict[str, torch.Tensor]):
    """The window's rows (batch['index'], (F,)) gathered and applied to the
    frames' initial estimates: (joint_3d (F, 21, 3), obj_r (F, 3, 3),
    obj_t (F, 3))."""
    idx = batch["index"]
    F = idx.shape[0]
    joint_3d = refined_hand_joints(
        batch["joints_pred"], batch["bone_length"],
        joint_refine_angle=tables["joint_angle"][idx],
        palm_refine_angle=tables["palm_angle"][idx] * 0.1,
        palm_rot6d=tables["palm_rot6"][idx].reshape(F, 6),
        palm_trans=tables["palm_trans"][idx])
    d_rot = rot6d_to_matrix(tables["obj_rot6"][idx].reshape(F, 6))
    obj_r = d_rot @ batch["Ro_pred"]
    obj_t = batch["To_pred"] + tables["obj_trans"][idx]
    return joint_3d, obj_r, obj_t


def make_video_fit_loss(net_params: Params, hand_sdf_cfg: SDFConfig,
                        hand_color_cfg: ColorConfig, obj_sdf_cfg: SDFConfig,
                        obj_color_cfg: ColorConfig, rcfg: RenderConfig, fcfg: FitHyper,
                        n_frames: int, fused_ladder: bool = False,
                        fused_fine: Optional[str] = None):
    """loss_fn(tables, batch, generator) -> (terms, metrics): the video
    step's weighted terms ('render', 'contact', 'penet', 'joint', 'verts',
    'smooth', and for '1234' 'stable'; their sum in this order is
    metrics['loss']) and its metrics (0-d tensors, not detached).

    The batch holds one window of F frames: rays_xy (F, R, 2), true_rgb
    (F, R, 3), true_mask (F, R, 1), one camera (cam_R, cam_T, focal,
    principal), index (F,) int64, the frames' initial estimates
    (joints_pred, bone_length, t_pose_21, Ro_pred, To_pred with a leading
    F), obj_verts (V, 3), optionally anchor_enabled (0-d; 0 drops the
    boundary anchors) and the ground truth (gt_joint3d, Ro_gt, To_gt) for
    the diagnostics."""
    hand = net_params["hand"]
    packs = pack_hand_field(hand, hand_sdf_cfg, hand_color_cfg, fused_ladder, fused_fine,
                            grad=True)
    obj_field = make_obj_field(net_params["obj"], obj_sdf_cfg, obj_color_cfg)

    def loss_fn(tables: Params, batch: Dict[str, torch.Tensor], generator=None):
        idx = batch["index"]
        F = idx.shape[0]
        joint_3d, obj_r, obj_t = window_pose(tables, batch)
        bt_inv = bone_transforms_from_mano_joints(joint_3d)          # (F, 21, 4, 4)
        t_pose = batch["t_pose_21"][0]
        cam = Camera(R=batch["cam_R"], T=batch["cam_T"], focal=batch["focal"],
                     principal=batch["principal"])
        outs = []
        for f in range(F):
            hand_field = make_hand_field(hand, hand_sdf_cfg, hand_color_cfg, bt_inv[f], t_pose,
                                         packs)
            rb = xy_to_ray_bundle(cam, batch["rays_xy"][f])
            oo, do = rays_to_object_frame(rb.origins, rb.directions, obj_r[f], obj_t[f])
            outs.append(render_dual(hand_field, obj_field, rcfg, generator, rb.origins,
                                    rb.directions, oo, do, fcfg.near, fcfg.far))
        out = {k: torch.cat([o[k] for o in outs]) for k in
               ("color_fine", "weight_sum", "sdf_hand", "sdf_obj")}

        true_mask = batch["true_mask"].reshape(-1, 1)
        # divided by F x R, as the reference does
        color_loss = (torch.sum(torch.abs((out["color_fine"] - batch["true_rgb"].reshape(-1, 3))
                                          * true_mask)) / true_mask.shape[0])
        m_loss = mask_bce(out["weight_sum"], true_mask)
        render_loss = 0.5 * (color_loss + 0.5 * m_loss)

        joint_loss = pose_l2(joint_3d, batch["joints_pred"])
        verts = batch["obj_verts"]
        pred_v = torch.einsum("fij,vj->fvi", obj_r, verts) + obj_t[:, None]
        compare_v = (torch.einsum("fij,vj->fvi", batch["Ro_pred"], verts)
                     + batch["To_pred"][:, None])
        verts_loss = pose_l2(pred_v, compare_v)

        sdf_h = out["sdf_hand"][..., 0]
        sdf_o = out["sdf_obj"][..., 0]
        c_loss = contact_loss(sdf_h, sdf_o)
        p_loss = penetration_loss(sdf_h, sdf_o)

        # a 1-frame window has no adjacent-frame term
        smooth = smooth_loss(joint_3d, pred_v) if F > 1 else joint_loss.new_zeros(())
        # the boundary anchors: the first frame's if the window starts the
        # sequence, else the last frame's if it ends it (exclusive), both
        # off where anchor_enabled is 0 (the runner's first step of each
        # window in epoch 0)
        first = (idx[0] == 0).to(joint_loss.dtype)
        last = (idx[-1] == n_frames - 1).to(joint_loss.dtype)
        anchor = batch.get("anchor_enabled", 1.0)
        smooth = smooth + anchor * first * (pose_l2(joint_3d[:1], batch["joints_pred"][:1])
                                            + pose_l2(pred_v[:1], compare_v[:1]))
        smooth = smooth + anchor * (1.0 - first) * last * (
            pose_l2(joint_3d[-1:], batch["joints_pred"][-1:])
            + pose_l2(pred_v[-1:], compare_v[-1:]))

        terms = {"render": render_loss, "contact": 30.0 * c_loss, "penet": 20.0 * p_loss,
                 "joint": 30.0 * joint_loss, "verts": 20.0 * verts_loss, "smooth": 50.0 * smooth}
        metrics = {"color_loss": color_loss, "mask_loss": m_loss, "joint_loss": joint_loss,
                   "obj_verts_loss": verts_loss, "contact_loss": c_loss, "penet_loss": p_loss,
                   "smooth_loss": smooth}
        # the ground truth's distance, a per-step diagnostic in no loss
        if "gt_joint3d" in batch:
            metrics["gt_joint_loss"] = pose_l2(batch["gt_joint3d"], joint_3d)
            gt_v = torch.einsum("fij,vj->fvi", batch["Ro_gt"], verts) + batch["To_gt"][:, None]
            metrics["gt_obj_verts_loss"] = pose_l2(pred_v, gt_v)
        if fcfg.fit_type == "1234":
            verts_ds = verts[::10]
            world_v = torch.einsum("fij,vj->fvi", obj_r, verts_ds) + obj_t[:, None]
            # the autograd field's sdf: the pose's gradient flows through it
            sdf_fields = [make_hand_field(hand, hand_sdf_cfg, hand_color_cfg, bt, t_pose).sdf_fn
                          for bt in bt_inv]
            hand_sdf_v = torch.stack([fn(p) for fn, p in zip(sdf_fields, world_v)])  # (F, V')
            s_loss = stable_loss_cross(hand_sdf_v, verts_ds)
            terms["stable"] = 100.0 * s_loss
            metrics["stable_loss"] = s_loss
        metrics["loss"] = sum(terms.values())
        return terms, metrics

    return loss_fn


def make_video_fit_step(net_params: Params, hand_sdf_cfg: SDFConfig,
                        hand_color_cfg: ColorConfig, obj_sdf_cfg: SDFConfig,
                        obj_color_cfg: ColorConfig, rcfg: RenderConfig, fcfg: FitHyper,
                        n_frames: int, fused_ladder: bool = False,
                        fused_fine: Optional[str] = None):
    """step(state, batch, generator) -> (state, metrics): the loss of one
    (window, view) batch (make_video_fit_loss), its gradient in the six
    whole tables (left on their .grad: zero outside the window) and one
    Adam step of every row; state = init_video_state(n_frames), metrics
    detached 0-d tensors (no host sync).  fused_ladder / fused_fine: the
    hand's kernels, as make_single_fit_step's."""
    loss_fn = make_video_fit_loss(net_params, hand_sdf_cfg, hand_color_cfg, obj_sdf_cfg,
                                  obj_color_cfg, rcfg, fcfg, n_frames, fused_ladder, fused_fine)

    def step_fn(state: Dict[str, Any], batch: Dict[str, torch.Tensor], generator=None):
        tables = state["tables"]
        _, metrics = loss_fn(tables, batch, generator)
        leaves = [tables[k] for k in POSE_KEYS]
        for leaf, g in zip(leaves, torch.autograd.grad(metrics["loss"], leaves)):
            leaf.grad = g
        state["opt"].step()
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn
