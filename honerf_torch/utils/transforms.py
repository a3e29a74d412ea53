"""Rotation / SE(3) helpers (counterpart of honerf_tpu.utils.transforms).

Every length uses the safe form sqrt(sum(x*x) + tiny): a plain norm has a
NaN gradient at zero, which the hand chain reaches in degenerate poses.
"""

from __future__ import annotations

import torch


def _safe_len(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + 1e-24)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """v / max(|v|, eps) (torch.nn.functional.normalize semantics)."""
    n = _safe_len(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def rot6d_to_matrix(rot_6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) or (..., 3, 2) -> (..., 3, 3): Gram-Schmidt of the two
    columns, stacked as matrix columns (Zhou et al. 2019)."""
    r = rot_6d.reshape(rot_6d.shape[:-1] + (3, 2)) if rot_6d.shape[-1] == 6 else rot_6d
    a1 = r[..., :, 0]
    a2 = r[..., :, 1]
    b1 = normalize(a1)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = normalize(a2 - dot * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-1)


def _skew(a: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    z = torch.zeros_like(a0)
    return torch.stack(
        [
            torch.stack([z, -a2, a1], dim=-1),
            torch.stack([a2, z, -a0], dim=-1),
            torch.stack([-a1, a0, z], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(angles: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> (..., 3, 3); the axis is normalized first."""
    if angles.dim() == axis.dim():
        angles = angles[..., 0]
    a = normalize(axis)
    sina = torch.sin(angles)[..., None, None]
    cosa_1m = (1.0 - torch.cos(angles))[..., None, None]
    cprod = _skew(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    return eye + cprod * sina + (cprod @ cprod) * cosa_1m


def rotate_axis_angle(v: torch.Tensor, k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v around unit axes k by theta (trailing 1 dim)."""
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    dot = torch.sum(k * v, dim=-1, keepdim=True)
    k, v = torch.broadcast_tensors(k, v)
    return v * cos_t + torch.linalg.cross(k, v, dim=-1) * sin_t + k * dot * (1.0 - cos_t)


def angle_between(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Numerically stable unsigned angle 2 atan2(|n1-n2|, |n1+n2|)."""
    n1 = v1 / torch.clamp(_safe_len(v1, keepdim=True), min=eps)
    n2 = v2 / torch.clamp(_safe_len(v2, keepdim=True), min=eps)
    return 2.0 * torch.atan2(_safe_len(n1 - n2), _safe_len(n1 + n2))


def signed_angle(v1: torch.Tensor, v2: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Angle of v1 w.r.t. v2, negative when v1 x v2 points against ref."""
    ang = angle_between(v1, v2)
    cross_12 = torch.linalg.cross(v1, v2, dim=-1)
    cond = (torch.sum(ref * cross_12, dim=-1) < 0).to(ang.dtype)
    return cond * (-ang) + (1.0 - cond) * ang


def alignment_matrix(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Rotation R with R @ v1 parallel to v2."""
    axis = normalize(torch.linalg.cross(v1, v2, dim=-1), eps=1e-8)
    return rodrigues(angle_between(v1, v2), axis)
