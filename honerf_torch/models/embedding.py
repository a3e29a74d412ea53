"""Positional encodings and the per-bone hand embedding; counterpart of
honerf_tpu.models.embedding.

  * positional_encoding: per input channel [sin(2^k x)_k, cos(2^k x)_k].
  * the A-NeRF bone embedding: per-bone inverse transform, distance v,
    direction r, cutoff gate h = 1 - sigmoid(200 (v - cutoff)).
"""

from __future__ import annotations

import numpy as np
import torch

# Per-bone cutoff distances (meters), MANO joint order.
BONE_CUTOFFS = np.asarray(
    [0.08, 0.03, 0.03, 0.02, 0.02, 0.03, 0.02, 0.02, 0.02, 0.03, 0.02,
     0.02, 0.02, 0.03, 0.02, 0.02, 0.02, 0.03, 0.02, 0.02, 0.02],
    dtype=np.float32,
)

CUTOFF_TAU = 200.0


def bone_cutoffs(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(BONE_CUTOFFS, dtype=like.dtype, device=like.device)


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """(..., N) -> (..., N * 2 * L), per channel [sin.. L, cos.. L]."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    spectrum = x[..., None] * freqs
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_freqs)


def anerf_bone_embedding(pts: torch.Tensor, bt_inv: torch.Tensor, t_pose_21: torch.Tensor):
    """Per-bone (v (..., 21, 1), r (..., 21, 3), h (..., 21, 1))."""
    rot = bt_inv[:, :3, :3]
    trans = bt_inv[:, :3, 3]
    q = torch.einsum("jab,...b->...ja", rot, pts) + trans - t_pose_21
    v = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    r = q / v
    h = 1.0 - torch.sigmoid(CUTOFF_TAU * (v - bone_cutoffs(pts)[:, None]))
    return v, r, h


def hand_embedding_width(v_multires: int, r_multires: int) -> int:
    """21 * ((1 + 2 vL) + (3 + 6 rL))."""
    return 21 * ((1 + 2 * v_multires) + (3 + 2 * 3 * r_multires))


def hand_embedding(pts, bt_inv, t_pose_21, v_multires: int, r_multires: int):
    """Bone-major embedding (the reference's channel order).
    Returns (xyz_feature (..., W), r (..., 21, 3), h (..., 21, 1))."""
    v, r, h = anerf_bone_embedding(pts, bt_inv, t_pose_21)
    v_emb = torch.cat([v, positional_encoding(v, v_multires)], dim=-1)
    r_emb = torch.cat([r, positional_encoding(r, r_multires)], dim=-1)
    feat = torch.cat([v_emb, r_emb], dim=-1) * h
    return feat.reshape(*feat.shape[:-2], -1), r, h


def channel_major_dest(v_multires: int, r_multires: int) -> np.ndarray:
    """dest[i] = bone-major column of channel-major column i."""
    vL, rL = v_multires, r_multires
    per_bone = 1 + 2 * vL + 3 + 6 * rL
    dest = [b * per_bone for b in range(21)]
    for trig in range(2):
        for l in range(vL):
            for b in range(21):
                dest.append(b * per_bone + 1 + trig * vL + l)
    for b in range(21):
        for c in range(3):
            dest.append(b * per_bone + 1 + 2 * vL + c)
    for trig in range(2):
        for l in range(rL):
            for b in range(21):
                for c in range(3):
                    dest.append(b * per_bone + 1 + 2 * vL + 3 + c * 2 * rL + trig * rL + l)
    return np.asarray(dest)


def hand_embedding_flat(pts, bt_inv, t_pose_21, v_multires: int, r_multires: int):
    """Channel-major embedding: the same values as hand_embedding, grouped
    by type (all bones' v, then all bones' sin(v 2^l) per l, ...).
    Returns (feat_cm (..., W), r (..., 21, 3), h (..., 21, 1))."""
    vL, rL = v_multires, r_multires
    rot = bt_inv[:, :3, :3]
    trans = bt_inv[:, :3, 3]
    q = torch.einsum("jab,...b->...ja", rot, pts) + trans - t_pose_21
    v2 = torch.sum(q * q, dim=-1) + 1e-24
    v = torch.sqrt(v2)
    r = q / v[..., None]
    h = 1.0 - torch.sigmoid(CUTOFF_TAU * (v - bone_cutoffs(pts)))
    r63 = r.reshape(*v.shape[:-1], 63)
    h3 = torch.repeat_interleave(h, 3, dim=-1)
    pieces = [v * h]
    pieces += [torch.sin(v * (2.0 ** l)) * h for l in range(vL)]
    pieces += [torch.cos(v * (2.0 ** l)) * h for l in range(vL)]
    pieces.append(r63 * h3)
    pieces += [torch.sin(r63 * (2.0 ** l)) * h3 for l in range(rL)]
    pieces += [torch.cos(r63 * (2.0 ** l)) * h3 for l in range(rL)]
    return torch.cat(pieces, dim=-1), r, h[..., None]
