"""Single-frame pose fitting, fit types '1' and '12' (counterpart of
honerf_tpu.fit.single).

Six trainable pose tensors per frame (object rot6d / translation, palm
rot6d / translation, 20 joint angles, 7 palm angles), Adam with a rate per
tensor, and a loss of render (masked L1 + 0.5 BCE) + pose regularizer
(+ contact / penetration for '12'); the chain inverse HALO refinement ->
bone transforms -> dual NeuS render is differentiated end to end by
autograd, with the offline nets as constants.

Kernels (select_fit_kernels): on the card the hand ladder runs K1
(ops.fused_hand) and the hand fine pass K2 / K3 ('full' by default;
'full_nocolor' runs them without the color net, 'pallas' K5 / K6 on the
embedding).  The nets need no gradient, so K3 and K6 run frozen, without
weight work; f32 for the fit confs' f32 trunks.  The object side is plain
torch with autograd, as in the JAX package.

Frame-batched fitting (make_batched_single_fit_step): G independent
frames a step, the pose tensors with a leading (G, ...) axis; each frame's
loss is the single step's on its own row, with its own kernel launches,
and one backward of their sum feeds one Adam, which is elementwise, so G
independent fits.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from honerf_torch.camera import Camera, xy_to_ray_bundle
from honerf_torch.hand import bone_transforms_from_mano_joints, refined_hand_joints
from honerf_torch.models.fields import ColorConfig, SDFConfig
from honerf_torch.render.dual import render_dual
from honerf_torch.render.losses import contact_loss, mask_bce, penetration_loss, pose_l2
from honerf_torch.render.neus import (
    FINE_MODES,
    RenderConfig,
    make_hand_field,
    make_obj_field,
    pack_hand_field,
    rays_to_object_frame,
)
from honerf_torch.utils.transforms import rot6d_to_matrix

Params = Dict[str, Any]

_logger = logging.getLogger(__name__)
_LOGGED_SELECTIONS = set()


class FitHyper(NamedTuple):
    """Static fitting hyperparameters (`train` / `general` conf sections)."""

    near: float = 0.4
    far: float = 1.5
    batch_size: int = 196
    fit_type: str = "12"  # '1' | '12'

    @classmethod
    def from_conf(cls, conf) -> "FitHyper":
        return cls(near=float(conf["train.near"]), far=float(conf["train.far"]),
                   batch_size=int(conf["train.batch_size"]),
                   fit_type=str(conf["general.fit_type"]))


#: the six per-frame pose tensors, in the order of the optimizer's groups
POSE_KEYS = ("obj_rot6", "obj_trans", "palm_rot6", "palm_trans", "joint_angle", "palm_angle")

#: Adam's learning rate per pose tensor (the reference fitting_single.py)
SINGLE_FIT_LRS = {
    "obj_rot6": 5e-4,
    "obj_trans": 5e-4,
    "palm_rot6": 5e-4,
    "palm_trans": 3e-4,
    "joint_angle": 1e-3,
    "palm_angle": 1e-3,
}


def init_pose_params(device=None) -> Params:
    """The six trainable tensors at their start: rot6d refinements at
    identity (eye(3)[:, :2]), the rest zero; leaves that require grad."""
    eye62 = torch.eye(3, device=device)[:, :2]
    pose = {
        "obj_rot6": eye62.clone(),
        "obj_trans": torch.zeros(3, device=device),
        "palm_rot6": eye62[None].clone(),
        "palm_trans": torch.zeros((1, 3), device=device),
        "joint_angle": torch.zeros((1, 20), device=device),
        "palm_angle": torch.zeros((1, 7), device=device),
    }
    return {k: v.requires_grad_(True) for k, v in pose.items()}


def make_pose_optimizer(pose: Params, lrs: Dict[str, float] = SINGLE_FIT_LRS):
    """The offline stage's Adam (train.offline.make_optimizer: beta 0.9 /
    0.999, eps 1e-8, optax's update) with one parameter group, and its own
    rate, per pose tensor."""
    return torch.optim.Adam([{"params": [pose[k]], "lr": lrs[k]} for k in POSE_KEYS],
                            betas=(0.9, 0.999), eps=1e-8)


def select_fit_kernels(fused_ladder: Optional[bool], fused_fine: Any, sdf_cfg: SDFConfig,
                       device) -> Tuple[bool, Optional[str]]:
    """The fitting stage's kernels (honerf_tpu/fit/runner.py:253-287) from
    the conf's `train.fused_ladder` and `train.fused_fine` (None: unset):
    (the hand ladder through K1, the fine pass's mode or None for the
    autograd field).  On a CUDA `device` the defaults are K1 on and
    'full' (K2 and the frozen K3); on the CPU both are off.  True is
    'full', False the autograd field; every kernel mode is frozen here
    (the nets are constants), with a bf16 or an f32 trunk.  An explicit
    mode runs its plain version on the CPU ('xla' as 'pallas': the same
    statements); on the card 'xla' has no kernel and raises
    NotImplementedError (use 'pallas').  The selection is logged once per
    process."""
    on_card = torch.device(device).type == "cuda"
    ladder = on_card if fused_ladder is None else bool(fused_ladder)
    fine = fused_fine
    if fine is None:
        fine = "full" if on_card else None
    elif fine is True:
        fine = "full"
    elif fine is False:
        fine = None
    if fine == "xla":
        if on_card:
            raise NotImplementedError(
                "train.fused_fine = 'xla' (the JAX package's XLA lowering of K5/K6's "
                "statements) has no kernel on the card: use 'pallas'")
        fine = "pallas"
    if fine is not None and fine not in FINE_MODES:
        raise ValueError(f"unknown train.fused_fine {fused_fine!r}")
    sel = (ladder, fine or "autograd", sdf_cfg.trunk_dtype, torch.device(device).type)
    if sel not in _LOGGED_SELECTIONS:
        _LOGGED_SELECTIONS.add(sel)
        _logger.info("fit kernels: fused_ladder=%s, hand fine pass %s (trunk_dtype=%s, %s; "
                     "conf train.fused_ladder=%r, train.fused_fine=%r)", *sel, fused_ladder,
                     fused_fine)
    return ladder, fine


def current_pose(pose: Params, frame: Dict[str, torch.Tensor]):
    """The refinements applied to the frame's initial estimates: (joint_3d
    (1, 21, 3), obj_r (3, 3), obj_t (3,))."""
    joint_3d = refined_hand_joints(
        frame["joints_pred"][None], frame["bone_length"][None],
        joint_refine_angle=pose["joint_angle"], palm_refine_angle=pose["palm_angle"] * 0.1,
        palm_rot6d=pose["palm_rot6"].reshape(1, 6), palm_trans=pose["palm_trans"])
    d_rot = rot6d_to_matrix(pose["obj_rot6"].reshape(6))
    obj_r = d_rot @ frame["Ro_pred"]
    obj_t = frame["To_pred"] + pose["obj_trans"]
    return joint_3d, obj_r, obj_t


def make_single_fit_loss(net_params: Params, hand_sdf_cfg: SDFConfig,
                         hand_color_cfg: ColorConfig, obj_sdf_cfg: SDFConfig,
                         obj_color_cfg: ColorConfig, rcfg: RenderConfig, fcfg: FitHyper,
                         fused_ladder: bool = False, fused_fine: Optional[str] = None):
    """loss_fn(pose, batch, generator) -> (terms, metrics): the fit step's
    loss as its weighted terms ('color', 'mask', 'joint', 'verts', and for
    '12' 'contact', 'penet'; their sum in this order is metrics['loss'])
    and the step's metrics (0-d tensors, not detached).  Arguments as
    make_single_fit_step's."""
    hand = net_params["hand"]
    # the nets need no gradient: the fine pass's differentiable op runs its
    # backward without weight work (K3 frozen)
    packs = pack_hand_field(hand, hand_sdf_cfg, hand_color_cfg, fused_ladder, fused_fine,
                            grad=True)
    obj_field = make_obj_field(net_params["obj"], obj_sdf_cfg, obj_color_cfg)

    def loss_fn(pose: Params, batch: Dict[str, torch.Tensor], generator=None):
        joint_3d, obj_r, obj_t = current_pose(pose, batch)
        bt_inv = bone_transforms_from_mano_joints(joint_3d)[0]
        hand_field = make_hand_field(hand, hand_sdf_cfg, hand_color_cfg, bt_inv,
                                     batch["t_pose_21"], packs)
        cam = Camera(R=batch["cam_R"], T=batch["cam_T"], focal=batch["focal"],
                     principal=batch["principal"])
        rb = xy_to_ray_bundle(cam, batch["rays_xy"])
        o_obj, d_obj = rays_to_object_frame(rb.origins, rb.directions, obj_r, obj_t)
        out = render_dual(hand_field, obj_field, rcfg, generator, rb.origins, rb.directions,
                          o_obj, d_obj, fcfg.near, fcfg.far)

        true_mask = batch["true_mask"]
        # divided by the ray count, not the mask sum, as the reference does
        color_loss = (torch.sum(torch.abs((out["color_fine"] - batch["true_rgb"]) * true_mask))
                      / true_mask.shape[0])
        m_loss = mask_bce(out["weight_sum"], true_mask)

        joint_loss = pose_l2(batch["joints_pred"], joint_3d[0])
        verts = batch["obj_verts"]
        pred_v = verts @ obj_r.T + obj_t
        compare_v = verts @ batch["Ro_pred"].T + batch["To_pred"]
        verts_loss = pose_l2(compare_v, pred_v)
        metrics = {"color_loss": color_loss, "mask_loss": m_loss, "joint_loss": joint_loss,
                   "obj_verts_loss": verts_loss}
        # the ground truth's distance, a per-step diagnostic in no loss
        if "gt_joint3d" in batch:
            metrics["gt_joint_loss"] = pose_l2(batch["gt_joint3d"], joint_3d[0])
            gt_v = verts @ batch["Ro_gt"].T + batch["To_gt"]
            metrics["gt_obj_verts_loss"] = pose_l2(pred_v, gt_v)
        terms = {"color": color_loss, "mask": 0.5 * m_loss}
        if fcfg.fit_type == "1":
            terms.update(joint=100.0 * joint_loss, verts=5.0 * verts_loss)
        else:  # '12'
            sdf_h, sdf_o = out["sdf_hand"][:, 0], out["sdf_obj"][:, 0]
            c_loss = contact_loss(sdf_h, sdf_o)
            p_loss = penetration_loss(sdf_h, sdf_o)
            terms.update(joint=30.0 * joint_loss, verts=20.0 * verts_loss, contact=30.0 * c_loss,
                         penet=20.0 * p_loss)
            metrics.update(contact_loss=c_loss, penet_loss=p_loss)
        metrics["loss"] = sum(terms.values())
        return terms, metrics

    return loss_fn


def make_single_fit_step(net_params: Params, hand_sdf_cfg: SDFConfig,
                         hand_color_cfg: ColorConfig, obj_sdf_cfg: SDFConfig,
                         obj_color_cfg: ColorConfig, rcfg: RenderConfig, fcfg: FitHyper,
                         fused_ladder: bool = False, fused_fine: Optional[str] = None):
    """step(state, batch, generator) -> (state, metrics): the loss, its
    gradient in the six pose tensors (left on their .grad) and one Adam
    update; state = {'pose', 'opt'} (init_fit_state), metrics detached
    0-d tensors (no host sync).  `net_params` holds the frozen offline
    models {'hand': {sdf, color, variance}, 'obj': {...}}, tensors that
    need no gradient; the ladder's kernel pack is made here, once.
    fused_ladder: the hand ladder through K1; fused_fine: the fine pass's
    mode (render.neus.FINE_MODES), None the autograd field
    (select_fit_kernels chooses both)."""
    loss_fn = make_single_fit_loss(net_params, hand_sdf_cfg, hand_color_cfg, obj_sdf_cfg,
                                   obj_color_cfg, rcfg, fcfg, fused_ladder, fused_fine)

    def step_fn(state: Dict[str, Any], batch: Dict[str, torch.Tensor], generator=None):
        pose = state["pose"]
        _, metrics = loss_fn(pose, batch, generator)
        loss = metrics["loss"]
        leaves = [pose[k] for k in POSE_KEYS]
        for leaf, g in zip(leaves, torch.autograd.grad(loss, leaves)):
            leaf.grad = g
        state["opt"].step()
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def init_fit_state(device=None, lrs: Dict[str, float] = SINGLE_FIT_LRS) -> Dict[str, Any]:
    """{'pose': init_pose_params(), 'opt': its Adam}."""
    pose = init_pose_params(device)
    return {"pose": pose, "opt": make_pose_optimizer(pose, lrs)}


def init_pose_params_batched(n_frames: int, device=None) -> Params:
    """The six pose tensors of `n_frames` independent frames: a leading
    frame axis on init_pose_params's, leaves that require grad."""
    return {k: v.detach()[None].repeat((n_frames,) + (1,) * v.ndim).requires_grad_(True)
            for k, v in init_pose_params(device).items()}


def init_batched_fit_state(n_frames: int, device=None,
                           lrs: Dict[str, float] = SINGLE_FIT_LRS) -> Dict[str, Any]:
    """{'pose': init_pose_params_batched(), 'opt': its Adam}."""
    pose = init_pose_params_batched(n_frames, device)
    return {"pose": pose, "opt": make_pose_optimizer(pose, lrs)}


def make_batched_single_fit_step(net_params: Params, hand_sdf_cfg: SDFConfig,
                                 hand_color_cfg: ColorConfig, obj_sdf_cfg: SDFConfig,
                                 obj_color_cfg: ColorConfig, rcfg: RenderConfig,
                                 fcfg: FitHyper, fused_ladder: bool = False,
                                 fused_fine: Optional[str] = None):
    """step(state, batch, generator) -> (state, metrics): G frames' single
    fit steps in one.  state = init_batched_fit_state(G); the batch's every
    tensor has a leading G axis (frame g's single-step batch in row g).
    Each frame's loss is make_single_fit_loss's on its own row, in frame
    order; the sum of the G losses has one backward, the six (G, ...)
    gradients stay on .grad, and one Adam step moves every row.  Metrics:
    detached (G,) tensors, no host sync."""
    loss_fn = make_single_fit_loss(net_params, hand_sdf_cfg, hand_color_cfg, obj_sdf_cfg,
                                   obj_color_cfg, rcfg, fcfg, fused_ladder, fused_fine)

    def step_fn(state: Dict[str, Any], batch: Dict[str, torch.Tensor], generator=None):
        pose = state["pose"]
        G = pose[POSE_KEYS[0]].shape[0]
        per = [loss_fn({k: v[g] for k, v in pose.items()}, {k: v[g] for k, v in batch.items()},
                       generator)[1] for g in range(G)]
        leaves = [pose[k] for k in POSE_KEYS]
        total = sum(m["loss"] for m in per)
        for leaf, g in zip(leaves, torch.autograd.grad(total, leaves)):
            leaf.grad = g
        state["opt"].step()
        return state, {k: torch.stack([m[k].detach() for m in per]) for k in per[0]}

    return step_fn


def final_poses_numpy(poses: Params, frames: Dict[str, torch.Tensor],
                      n_real: int) -> List[Dict[str, np.ndarray]]:
    """final_pose_numpy of the first `n_real` rows of G frames' poses
    (`frames`: the frames' constants with a leading G axis), in one
    device -> host copy."""
    with torch.no_grad():
        rows = [current_pose({k: v[g] for k, v in poses.items()},
                             {k: v[g] for k, v in frames.items()}) for g in range(n_real)]
    if not rows:
        return []
    return poses_numpy(torch.cat([r[0] for r in rows]), torch.stack([r[1] for r in rows]),
                       torch.stack([r[2] for r in rows]))


def poses_numpy(joint_3d: torch.Tensor, obj_r: torch.Tensor,
                obj_t: torch.Tensor) -> List[Dict[str, np.ndarray]]:
    """G fitted poses as the output pickles hold them (pred_joint3d (21, 3),
    pred_Ro (3, 3), pred_To (3,), f32) from (G, 21, 3), (G, 3, 3) and (G, 3)
    tensors, in one device -> host copy."""
    G = obj_t.shape[0]
    with torch.no_grad():
        flat = torch.cat([joint_3d.reshape(G, 63), obj_r.reshape(G, 9), obj_t.reshape(G, 3)], 1)
    h = flat.float().cpu().numpy()
    return [{"pred_joint3d": r[:63].reshape(21, 3).copy(), "pred_Ro": r[63:72].reshape(3, 3).copy(),
             "pred_To": r[72:75].copy()} for r in h]


def final_pose_numpy(pose: Params, frame: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The fitted pose for the output pickle: pred_joint3d (21, 3), pred_Ro
    (3, 3), pred_To (3,), f32, in one device -> host copy."""
    with torch.no_grad():
        joint_3d, obj_r, obj_t = current_pose(pose, frame)
    return poses_numpy(joint_3d, obj_r[None], obj_t[None])[0]
