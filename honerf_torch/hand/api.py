"""Hand articulation API (counterpart of honerf_tpu.hand.api): the
world -> per-bone inverse transform stack that conditions the hand SDF."""

from __future__ import annotations

import torch

from honerf_torch.hand.kinematics import pose_to_bone_transforms, transform_to_canonical
from honerf_torch.hand.skeleton import convert_joints


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
