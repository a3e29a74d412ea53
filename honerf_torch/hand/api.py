"""Hand articulation API (counterpart of honerf_tpu.hand.api): joint
refinement through the inverse HALO path with the global palm transform,
and the world -> per-bone inverse transform stack that conditions the
hand SDF.  Differentiable in the refinement parameters."""

from __future__ import annotations

from typing import Optional

import torch

from honerf_torch.hand.kinematics import (
    pose_to_bone_transforms,
    refine_joints,
    transform_to_canonical,
)
from honerf_torch.hand.skeleton import convert_joints
from honerf_torch.utils.transforms import rot6d_to_matrix


def _invert_rigid_4x4(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms via R^T / -R^T t."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = ti
    out[..., 3, 3] = 1.0
    return out


def bone_transforms_from_mano_joints(joints_mano: torch.Tensor) -> torch.Tensor:
    """(B, 21, 3) repo-mano joints -> (B, 21, 4, 4) inverse bone
    transforms (world -> per-bone canonical space), mano joint order:
    mano->biomech, canonicalize, PoseConverter forward, biomech->mano,
    compose with the canonical transform."""
    B = joints_mano.shape[0]
    ones = torch.ones((B,), dtype=joints_mano.dtype, device=joints_mano.device)
    kps = convert_joints(joints_mano, "mano", "biomech")
    kp_canon, glo_rot = transform_to_canonical(kps, ones)
    trans = pose_to_bone_transforms(kp_canon, ones)
    trans = convert_joints(trans, "biomech", "mano")
    return trans @ glo_rot[:, None]


def refined_hand_joints(
    joints_pred_mano: torch.Tensor,
    bone_length: torch.Tensor,
    joint_refine_angle: Optional[torch.Tensor] = None,
    palm_refine_angle: Optional[torch.Tensor] = None,
    palm_rot6d: Optional[torch.Tensor] = None,
    palm_trans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, 21, 3) predicted joints -> refined joints (repo-mano order):
    the inverse HALO path to the target bone lengths (B, 20), then the
    global palm rotation (B, 6 rot6d, about the root joint) and
    translation (B, 3).  Training scales the palm angles and translation
    by 0.1 at the call site."""
    B = joints_pred_mano.shape[0]
    ones = torch.ones((B,), dtype=joints_pred_mano.dtype, device=joints_pred_mano.device)
    kps = convert_joints(joints_pred_mano, "mano", "biomech")
    kp_canon, glo_rot = transform_to_canonical(kps, ones)
    j3d = refine_joints(kp_canon, ones, bone_length, joint_refine_angle, palm_refine_angle)
    glo_inv = _invert_rigid_4x4(glo_rot)
    j3d = torch.einsum("bij,bkj->bki", glo_inv[:, :3, :3], j3d) + glo_inv[:, None, :3, 3]
    if palm_rot6d is not None:
        R = rot6d_to_matrix(palm_rot6d)
        root = j3d[:, :1, :]
        j3d = torch.einsum("bij,bkj->bki", R, j3d - root) + root
    if palm_trans is not None:
        j3d = j3d + palm_trans[:, None, :]
    return j3d
