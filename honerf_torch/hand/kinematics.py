"""HALO keypoint-to-bone-transform kinematics (forward path); counterpart
of honerf_tpu.hand.kinematics.

21 canonicalized keypoints (biomech order) become 21 inverse bone
transforms (posed space -> per-bone canonical space).  The detach points
of the reference are kept: the canonical transform is computed from
detached keypoints and the local coordinate systems are detached.  The
inverse path (refine_joints, forward_joints_from_bones) re-synthesizes a
skeleton from refinement angles and target bone lengths; training
differentiates through it into the per-view se3_refine table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from honerf_torch.utils.transforms import (
    angle_between,
    clip,
    maximum,
    rodrigues,
    rotate_axis_angle,
    signed_angle,
)

_EPS = 1e-6
_EPS_MAT = 1e-9

ROOT_PLANE_ANGLES = np.asarray([0.8, 0.2, 0.2])
ROOT_BONE_ANGLES = np.asarray([0.4, 0.2, 0.2, 0.2])

_IDX_CHILD = np.arange(1, 21)
_IDX_PARENT = np.concatenate([np.zeros(5, np.int64), np.arange(1, 16)])

_LEV = [list(range(0, 5)), list(range(5, 10)), list(range(10, 15)), list(range(15, 20))]

# Canonical T-pose bone directions (biomech bone order), the fixed targets
# of the inverse path.
INITIAL_BONE_VEC = np.asarray(
    [
        [4.4889e-01, -8.4880e-01, -2.7935e-01],
        [1.9867e-01, -9.8007e-01, 0.0000e00],
        [2.0004e-07, -1.0000e00, 0.0000e00],
        [-1.9471e-01, -9.8007e-01, -3.9469e-02],
        [-3.7001e-01, -9.2185e-01, -1.1528e-01],
        [4.4889e-01, -8.4880e-01, -2.7935e-01],
        [1.9867e-01, -9.8007e-01, 1.1921e-07],
        [2.8685e-07, -1.0000e00, 0.0000e00],
        [-1.9471e-01, -9.8007e-01, -3.9470e-02],
        [-3.7001e-01, -9.2185e-01, -1.1528e-01],
        [4.4889e-01, -8.4880e-01, -2.7935e-01],
        [1.9867e-01, -9.8007e-01, 1.4901e-07],
        [1.9870e-06, -1.0000e00, 2.3842e-07],
        [-1.9471e-01, -9.8007e-01, -3.9470e-02],
        [-3.7001e-01, -9.2185e-01, -1.1528e-01],
        [4.4889e-01, -8.4880e-01, -2.7935e-01],
        [1.9867e-01, -9.8007e-01, 8.9407e-08],
        [-3.4117e-06, -1.0000e00, -2.1979e-07],
        [-1.9471e-01, -9.8007e-01, -3.9469e-02],
        [-3.7001e-01, -9.2185e-01, -1.1528e-01],
    ],
    dtype=np.float32,
)


def _vec(values, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=ref.dtype, device=ref.device)


def _eye(n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm_clip(v: torch.Tensor, eps: float = _EPS_MAT) -> torch.Tensor:
    return maximum(torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24), eps)


def _normalize(v: torch.Tensor, eps: float = _EPS_MAT) -> torch.Tensor:
    return v / _norm_clip(v, eps)[..., None]


def _alignment(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    axis = _normalize(_cross(v1, v2), 1e-8)
    return rodrigues(angle_between(v1, v2), axis)


def compute_canonical_transform(kp3d: torch.Tensor, is_right: torch.Tensor) -> torch.Tensor:
    """(B, 21, 3) biomech keypoints -> (B, 3, 4): root-center, middle root
    bone onto -y, index/middle plane normal onto +z (from DETACHED
    keypoints)."""
    kp3d = kp3d.detach()
    B = kp3d.shape[0]
    right = is_right.reshape(B, 1).to(kp3d.dtype)
    flip = torch.where(right > 0.5, 1.0, -1.0)
    ones = torch.ones((B, 1), dtype=kp3d.dtype, device=kp3d.device)
    kp3d = kp3d * torch.cat([ones, flip, ones], dim=-1)[:, None, :]
    t = -kp3d[:, 0]
    T_t = torch.cat(
        [_eye(3, kp3d).expand(B, 3, 3), t[:, :, None]], dim=-1
    )  # (B, 3, 4)
    y_axis = _vec([0.0, -1.0, 0.0], kp3d).expand(B, 3)
    v_mrb = _normalize(kp3d[:, 3] - kp3d[:, 0], 1e-8)
    R1 = _alignment(v_mrb, y_axis)
    v_irb = _normalize(kp3d[:, 2] - kp3d[:, 0], 1e-8)
    normal = _cross(v_mrb, v_irb)
    normal_rot = torch.einsum("bi,bji->bj", normal, R1)
    z_axis = _vec([0.0, 0.0, 1.0], kp3d).expand(B, 3)
    R2 = _alignment(normal_rot, z_axis)
    T_t = T_t.clone()
    T_t[:, 1, 1] = torch.where(right[:, 0] > 0.5, 1.0, -1.0)
    return R2 @ (R1 @ T_t)


def transform_to_canonical(
    kp3d: torch.Tensor, is_right: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (canonical keypoints (B, 21, 3), 4x4 transform (B, 4, 4))."""
    T34 = compute_canonical_transform(kp3d, is_right)
    ones = torch.ones(kp3d.shape[:-1] + (1,), dtype=kp3d.dtype, device=kp3d.device)
    kp_canon = torch.einsum("bij,bkj->bki", T34, torch.cat([kp3d, ones], dim=-1))
    last = _vec([[0.0, 0.0, 0.0, 1.0]], kp3d).expand(kp3d.shape[0], 1, 4)
    return kp_canon, torch.cat([T34, last], dim=1)


def preprocess_joints(joints: torch.Tensor, is_right: torch.Tensor) -> torch.Tensor:
    """Flip left hands to right."""
    right = is_right.reshape(-1, 1, 1).to(joints.dtype)
    flipped = joints * _vec([-1.0, 1.0, 1.0], joints)
    return joints * right + (1.0 - right) * flipped


def kp3d_to_bones(kp3d: torch.Tensor):
    """Joints -> (unit bones (B,20,3), lengths (B,20,1), kp->bone 4x4)."""
    B = kp3d.shape[0]
    child = torch.as_tensor(_IDX_CHILD, device=kp3d.device)
    parent = torch.as_tensor(_IDX_PARENT, device=kp3d.device)
    bones = kp3d[:, child] - kp3d[:, parent]
    lengths = maximum(torch.sqrt(torch.sum(bones * bones, dim=2, keepdim=True) + 1e-24),
                      _EPS_MAT)
    bones = bones / lengths
    translate = _eye(4, kp3d).repeat(B, 20, 1, 1)
    translate[:, :, :3, 3] = -kp3d[:, parent]
    scale = _eye(4, kp3d).repeat(B, 20, 1, 1) / lengths[..., None]
    scale[:, :, 3, 3] = 1.0
    return bones, lengths, scale @ translate


def _propagate(mat: torch.Tensor) -> torch.Tensor:
    mat = mat.clone()
    mat[:, 5:10] = mat[:, 0:5]
    mat[:, 10:15] = mat[:, 0:5]
    mat[:, 15:20] = mat[:, 0:5]
    return mat


def normalize_root_planes(bones: torch.Tensor, palm_refine: torch.Tensor):
    """Rotate root bones so inter-finger plane angles match the canonical
    pose, with 3 learnable palm corrections."""
    B = bones.shape[0]
    canon = ROOT_PLANE_ANGLES
    b0, b1, b2, b3, b4 = (bones[:, i] for i in range(5))
    mat = _eye(3, bones).repeat(B, 20, 1, 1)

    n1 = _cross(b2, b1)
    n0 = _cross(b1, b0)
    a01 = signed_angle(n0, n1, b1)
    mat[:, 0] = rodrigues(a01 - canon[0] + palm_refine[:, 0], b1)

    n2 = _cross(b3, b2)
    a21 = signed_angle(n2, n1, b2)
    ring_t = rodrigues(a21 + canon[1] + palm_refine[:, 1], b2)
    b3r = torch.einsum("bij,bj->bi", ring_t, b3)
    b4r = torch.einsum("bij,bj->bi", ring_t, b4)
    mat[:, 3] = ring_t

    n3 = _cross(b4r, b3r)
    n2r = _cross(b3r, b2)
    a32 = signed_angle(n3, n2r, b3r)
    pinky_t = rodrigues(a32 + canon[2] + palm_refine[:, 2], b3r)
    mat[:, 4] = pinky_t @ ring_t

    mat = _propagate(mat)
    return torch.einsum("bnij,bnj->bni", mat, bones), mat


def normalize_root_bone_angles(bones: torch.Tensor, palm_refine: torch.Tensor):
    """Rotate root bones so adjacent-bone angles match the canonical pose,
    with 4 learnable palm corrections."""
    B = bones.shape[0]
    canon = ROOT_BONE_ANGLES
    b0, b1, b2, b3, b4 = (bones[:, i] for i in range(5))
    mat = _eye(3, bones).repeat(B, 20, 1, 1)

    n1 = _normalize(_cross(b2, b1), 1e-8)
    a21 = signed_angle(b2, b1, n1)
    index_t = rodrigues(canon[1] - a21 + palm_refine[:, 3], n1)
    mat[:, 1] = index_t
    b1 = torch.einsum("bij,bj->bi", index_t, b1)
    b0 = torch.einsum("bij,bj->bi", index_t, b0)

    n0 = _normalize(_cross(b1, b0), 1e-8)
    a10 = signed_angle(b1, b0, n0)
    thumb_t = rodrigues(canon[0] - a10 + palm_refine[:, 4], n0)
    mat[:, 0] = thumb_t @ index_t

    n2 = _normalize(_cross(b3, b2), 1e-8)
    a32 = signed_angle(b3, b2, n2)
    ring_t = rodrigues(a32 - canon[2] + palm_refine[:, 5], n2)
    mat[:, 3] = ring_t
    b3 = torch.einsum("bij,bj->bi", ring_t, b3)
    b4 = torch.einsum("bij,bj->bi", ring_t, b4)

    n3 = _normalize(_cross(b4, b3), 1e-8)
    a43 = signed_angle(b4, b3, n3)
    pinky_t = rodrigues(a43 - canon[3] + palm_refine[:, 6], n3)
    mat[:, 4] = pinky_t @ ring_t

    mat = _propagate(mat)
    return torch.einsum("bnij,bnj->bni", mat, bones), mat


def compute_local_coordinate_system(bones: torch.Tensor) -> torch.Tensor:
    """Per-bone local frames (B, 20, 3, 3), rows = x/y/z basis vectors;
    root bones get the identity.  DETACHED."""
    B = bones.shape[0]
    root_bones = bones[:, 0:5]
    plane_normals = _normalize(_cross(root_bones[:, :-1], root_bones[:, 1:]), _EPS_MAT)
    finger_norms = torch.stack(
        [
            plane_normals[:, 0],
            plane_normals[:, 1],
            0.5 * (plane_normals[:, 1] + plane_normals[:, 2]),
            0.5 * (plane_normals[:, 2] + plane_normals[:, 3]),
            plane_normals[:, 3],
        ],
        dim=1,
    )
    cs = _eye(3, bones).repeat(B, 20, 1, 1)
    z = root_bones
    y = _cross(z, finger_norms)
    x = _cross(y, z)
    x = _normalize(x)
    y = _normalize(y)
    cs[:, 5:10, 0] = x
    cs[:, 5:10, 1] = y
    cs[:, 5:10, 2] = z

    y_axis = _vec([0.0, 1.0, 0.0], bones).expand(B, 5, 3)
    x_axis = _vec([1.0, 0.0, 0.0], bones).expand(B, 5, 3)
    xz_mask = _vec([1.0, 0.0, 1.0], bones)

    for lev in (2, 3):
        idx = _LEV[lev]
        parent_idx = _LEV[lev - 1]
        bone_parent = bones[:, parent_idx]
        p_coord = cs[:, parent_idx].clone()
        lbv2 = torch.einsum("bfij,bfj->bfi", p_coord, bone_parent)
        lbv2_xz = lbv2 * xz_mask
        dot_xz = lbv2_xz[..., 2]
        dot_xz = torch.where(torch.abs(dot_xz) < 1e-6, torch.zeros_like(dot_xz), dot_xz)
        norm_xz = _norm_clip(lbv2_xz, _EPS_MAT)
        dot_xz = clip(dot_xz / norm_xz, -1.0 + _EPS, 1.0 - _EPS)
        angle_xz = torch.arccos(dot_xz)
        angle_xz = torch.where(lbv2_xz[..., 0] + 1e-6 < 0, -angle_xz, angle_xz)

        dot_yz = torch.sum(lbv2_xz * lbv2, dim=-1) / norm_xz
        dot_yz = clip(dot_yz, -1.0 + _EPS, 1.0 - _EPS)
        angle_yz = torch.arccos(dot_yz)
        angle_yz = torch.where(lbv2[..., 1] + 1e-6 < 0, -angle_yz, angle_yz)

        angle_xz = angle_xz[..., None]
        angle_yz = angle_yz[..., None]
        p_t = p_coord.transpose(-1, -2)
        rot_axis_xz = torch.einsum("bfij,bfj->bfi", p_t, y_axis)
        rot_axis_y_local = rotate_axis_angle(x_axis, y_axis, angle_xz)
        rot_axis_y = torch.einsum("bfij,bfj->bfi", p_t, rot_axis_y_local)

        small_xz = (torch.abs(angle_xz) < _EPS).to(bones.dtype)
        x = small_xz * x + (1 - small_xz) * rotate_axis_angle(x, rot_axis_xz, angle_xz)
        y = small_xz * y + (1 - small_xz) * rotate_axis_angle(y, rot_axis_xz, angle_xz)
        z = small_xz * z + (1 - small_xz) * rotate_axis_angle(z, rot_axis_xz, angle_xz)
        small_yz = (torch.abs(angle_yz) < _EPS).to(bones.dtype)
        x = small_yz * x + (1 - small_yz) * rotate_axis_angle(x, rot_axis_y, -angle_yz)
        y = small_yz * y + (1 - small_yz) * rotate_axis_angle(y, rot_axis_y, -angle_yz)
        z = small_yz * z + (1 - small_yz) * rotate_axis_angle(z, rot_axis_y, -angle_yz)

        cs[:, idx, 0] = x
        cs[:, idx, 1] = y
        cs[:, idx, 2] = z

    return cs.detach()


def compute_local_coordinates(bones: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnij,bnj->bni", cs, bones)


def compute_rot_angles(local_coords: torch.Tensor) -> torch.Tensor:
    """Flexion (xz) and abduction (yz) angles per bone -> (B, 20, 2)."""
    proj_xz = local_coords * _vec([1.0, 0.0, 1.0], local_coords)
    norm_xz = _norm_clip(proj_xz, _EPS_MAT)
    dot_xz = proj_xz[..., 2]
    dot_xz = torch.where(torch.abs(dot_xz) < 1e-6, torch.zeros_like(dot_xz), dot_xz)
    dot_xz = clip(dot_xz / norm_xz, -1 + _EPS, 1 - _EPS)
    angle_xz = torch.arccos(dot_xz)
    angle_xz = torch.where(proj_xz[..., 0] + 1e-6 < 0, -angle_xz, angle_xz)

    dot_yz = torch.sum(proj_xz * local_coords, dim=-1) / norm_xz
    dot_yz = clip(dot_yz, -1 + _EPS, 1 - _EPS)
    angle_yz = torch.arccos(dot_yz)
    angle_yz = torch.where(local_coords[..., 1] + 1e-6 > 0, -angle_yz, angle_yz)
    return torch.stack([angle_xz, angle_yz], dim=-1)


def compute_rotation_matrix(rot_angles: torch.Tensor, joint_refine: torch.Tensor) -> torch.Tensor:
    """Per-bone unpose rotations from flexion/abduction angles, with 20
    learnable joint-angle refinements."""
    B, n_bones, _ = rot_angles.shape
    flex = rot_angles[..., 0]
    abd = rot_angles[..., 1]
    x = _vec([1.0, 0.0, 0.0], rot_angles).expand(B, n_bones, 3)
    y = _vec([0.0, 1.0, 0.0], rot_angles).expand(B, n_bones, 3)
    rotated_x = rotate_axis_angle(x, y, flex[..., None])
    abduction = -abd
    abduction = torch.cat(
        [abduction[:, :5], abduction[:, 5:10] + joint_refine[:, :5], abduction[:, 10:]],
        dim=1,
    )
    r1 = rodrigues(abduction, rotated_x)
    flexion = -flex
    flexion = torch.cat([flexion[:, :5], flexion[:, 5:] + joint_refine[:, 5:]], dim=1)
    r2 = rodrigues(flexion, y)
    r = r2 @ r1
    r = r.clone()
    r[:, :5] = _eye(3, r)
    return r


def compute_adjusted_transpose(cs: torch.Tensor, rot_mat: torch.Tensor) -> torch.Tensor:
    lev2_rot = rot_mat[:, _LEV[1]]
    lev3_rot = rot_mat[:, _LEV[2]] @ lev2_rot
    cs_t = cs.transpose(-1, -2).clone()
    cs_t[:, _LEV[2]] = cs_t[:, _LEV[2]] @ lev2_rot
    cs_t[:, _LEV[3]] = cs_t[:, _LEV[3]] @ lev3_rot
    return cs_t


def _to_4x4(mat3: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(mat3.shape[:2] + (4, 4), dtype=mat3.dtype, device=mat3.device)
    out[..., :3, :3] = mat3
    out[..., 3, 3] = 1.0
    return out


def compute_bone_to_kp_mat(bone_lengths: torch.Tensor, local_coords_canonical: torch.Tensor):
    """Scale + kinematic-chain translation back to keypoint space."""
    B = bone_lengths.shape[0]
    mat = _eye(4, bone_lengths).repeat(B, 20, 1, 1) * bone_lengths[..., None]
    mat[:, :, 3, 3] = 1.0
    bones_scaled = local_coords_canonical * bone_lengths
    lev1 = torch.zeros((B, 5, 3), dtype=bone_lengths.dtype, device=bone_lengths.device)
    lev2 = bones_scaled[:, _LEV[0]]
    lev3 = bones_scaled[:, _LEV[1]] + lev2
    lev4 = bones_scaled[:, _LEV[2]] + lev3
    mat[:, :, :3, 3] = torch.cat([lev1, lev2, lev3, lev4], dim=1)
    return mat


def pose_to_bone_transforms(
    joints: torch.Tensor,
    is_right: torch.Tensor,
    joint_refine_angle: Optional[torch.Tensor] = None,
    palm_refine_angle: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Canonicalized biomech keypoints -> 21 inverse bone transforms
    (B, 21, 4, 4) (reference PoseConverter.forward)."""
    B = joints.shape[0]
    zeros = lambda n: torch.zeros((B, n), dtype=joints.dtype, device=joints.device)  # noqa: E731
    if joint_refine_angle is None:
        joint_refine_angle = zeros(20)
    if palm_refine_angle is None:
        palm_refine_angle = zeros(7)

    joints = preprocess_joints(joints, is_right)
    bones, bone_lengths, kp_to_bone = kp3d_to_bones(joints)
    plane_bones, plane_mat = normalize_root_planes(bones, palm_refine_angle)
    norm_bones, angle_mat = normalize_root_bone_angles(plane_bones, palm_refine_angle)
    root_norm_mat = angle_mat @ plane_mat

    cs = compute_local_coordinate_system(norm_bones)
    local_coords = compute_local_coordinates(norm_bones, cs)
    rot_angles = compute_rot_angles(local_coords)
    rot_mat = compute_rotation_matrix(rot_angles, joint_refine_angle)
    cs_t = compute_adjusted_transpose(cs, rot_mat)
    unpose3 = cs_t @ (rot_mat @ cs)
    local_coords_unposed = compute_local_coordinates(norm_bones, unpose3)
    inv_scale_trans = compute_bone_to_kp_mat(bone_lengths, local_coords_unposed)

    trans = _to_4x4(root_norm_mat) @ kp_to_bone
    trans = _to_4x4(unpose3) @ trans
    trans = inv_scale_trans @ trans
    root = _eye(4, joints).expand(B, 1, 4, 4)
    return torch.cat([root, trans], dim=1)


def refine_joints(
    joints: torch.Tensor,
    is_right: torch.Tensor,
    mean_bone_length: torch.Tensor,
    joint_refine_angle: Optional[torch.Tensor] = None,
    palm_refine_angle: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse path: re-synthesize a 21-joint skeleton (repo-mano order)
    from canonicalized keypoints, refinement angles and target bone
    lengths (B, 20)."""
    B = joints.shape[0]
    zeros = lambda n: torch.zeros((B, n), dtype=joints.dtype, device=joints.device)  # noqa: E731
    if joint_refine_angle is None:
        joint_refine_angle = zeros(20)
    if palm_refine_angle is None:
        palm_refine_angle = zeros(7)

    joints = preprocess_joints(joints, is_right)
    bones, _lengths, _ = kp3d_to_bones(joints)
    plane_bones, plane_mat = normalize_root_planes(bones, palm_refine_angle)
    norm_bones, angle_mat = normalize_root_bone_angles(plane_bones, palm_refine_angle)
    root_norm_mat = angle_mat @ plane_mat

    cs = compute_local_coordinate_system(norm_bones)
    local_coords = compute_local_coordinates(norm_bones, cs)
    rot_angles = compute_rot_angles(local_coords)
    rot_mat = compute_rotation_matrix(rot_angles, joint_refine_angle)
    cs_t = compute_adjusted_transpose(cs, rot_mat)
    unpose3 = cs_t @ (rot_mat @ cs)

    # products of rotations: the inverse is the transpose
    rot_tpose_inv = (unpose3 @ root_norm_mat).transpose(-1, -2)
    p_bone = torch.einsum("bnij,nj->bni", rot_tpose_inv, _vec(INITIAL_BONE_VEC, joints))
    return forward_joints_from_bones(p_bone, mean_bone_length.reshape(B, 20, 1))


def forward_joints_from_bones(local_coords: torch.Tensor,
                              bone_lengths: torch.Tensor) -> torch.Tensor:
    """Accumulate bone vectors into 21 joints, repo-mano contiguous-finger
    order."""
    B = local_coords.shape[0]
    scaled = local_coords * bone_lengths  # (B, 20, 3)
    joints = [scaled.new_zeros((B, 3))]
    for finger in range(5):
        start = scaled.new_zeros((B, 3))
        for level in range(4):
            start = start + scaled[:, level * 5 + finger]
            joints.append(start)
    return torch.stack(joints, dim=1)
