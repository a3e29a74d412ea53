"""Losses of offline training and of pose fitting (counterpart of
honerf_tpu.render.losses): fixed-shape masked reductions, with no
data-dependent host sync."""

from __future__ import annotations

import torch


def masked_l1_color(color: torch.Tensor, true_rgb: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """sum(|(c - rgb) * mask|) / (sum(mask) + 1e-5)."""
    mask_sum = torch.sum(mask) + 1e-5
    return torch.sum(torch.abs((color - true_rgb) * mask)) / mask_sum


def mask_bce(weight_sum: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy of the clipped ray opacity against the mask."""
    p = torch.clamp(weight_sum, 1e-3, 1.0 - 1e-3)
    return -torch.mean(mask * torch.log(p) + (1.0 - mask) * torch.log(1.0 - p))


def masked_psnr(color: torch.Tensor, true_rgb: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """PSNR over the masked pixels; the MSE floor keeps it finite."""
    mask_sum = torch.sum(mask) + 1e-5
    mse = torch.sum((color - true_rgb) ** 2 * mask) / (mask_sum * 3.0)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


# ---------------------------------------------------------------------------
# Pose fitting (counterpart of the fitting part of honerf_tpu.render.losses)
# ---------------------------------------------------------------------------

def pose_l2(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean per-point L2 norm.  Safe sqrt: at the first iteration the
    prediction can equal the target exactly (identity refinements), and
    the norm's gradient there must be 0, not NaN."""
    d = target - pred
    return torch.mean(torch.sqrt(torch.sum(d * d, dim=-1) + 1e-24))


def contact_loss(sdf_hand: torch.Tensor, sdf_obj: torch.Tensor) -> torch.Tensor:
    """Mean |sdf_h| + |sdf_o| over the samples where that sum is < 1e-2,
    as a masked reduction."""
    s = torch.abs(sdf_hand) + torch.abs(sdf_obj)
    m = (s < 1e-2).to(s.dtype)
    return torch.sum(s * m) / (torch.sum(m) + 1e-9)


def penetration_loss(sdf_hand: torch.Tensor, sdf_obj: torch.Tensor) -> torch.Tensor:
    """Mean |sdf_h| + |sdf_o| over the samples inside both surfaces."""
    m = ((sdf_obj < 0) & (sdf_hand < 0)).to(sdf_hand.dtype)
    s = (torch.abs(sdf_hand) + torch.abs(sdf_obj)) * m
    return torch.sum(s) / (torch.sum(m) + 1e-9)


def smooth_loss(joints: torch.Tensor, obj_verts_world: torch.Tensor) -> torch.Tensor:
    """Adjacent-frame joint + object-vertex differences over a frame window:
    joints (F, 21, 3), obj_verts_world (F, V, 3)."""
    return (pose_l2(joints[1:], joints[:-1])
            + pose_l2(obj_verts_world[1:], obj_verts_world[:-1]))


def stable_loss_cross(hand_sdf_at_verts: torch.Tensor, verts_local: torch.Tensor,
                      out_weight: float = 0.05) -> torch.Tensor:
    """Cross-frame contact stability of the video fitter ('1234'), with the
    reference's quirks kept as the JAX package keeps them:

      * only frames whose penetration set (hand sdf < 0) is non-empty add
        rows to the in and out error sums;
      * the "out" candidates are every vertex id except 0 and 1 (the
        reference's setdiff1d of a boolean mask), id 0 staying when the
        frame is fully inside: an in-point's nearest candidate is mostly
        itself;
      * each nearest candidate counts once (a scatter-max of the in-points);
      * each frame's sum is normalised by (in_time - 1) * n_in, the frames'
        sum divided by in_time, and the loss is 0 when in_time <= 1.

    hand_sdf_at_verts: (F, V) the hand's sdf at the (downsampled) object
    vertices, per frame; verts_local: (V, 3) their object-local positions.
    Returns a 0-d tensor."""
    F, V = hand_sdf_at_verts.shape
    dt = hand_sdf_at_verts.dtype
    in_mask = (hand_sdf_at_verts < 0).to(dt)                   # (F, V)
    frame_has_in = (in_mask.sum(dim=1) > 0).to(dt)             # (F,)
    in_time = frame_has_in.sum()
    sdf_pos = torch.clamp(hand_sdf_at_verts, 0.0, 1e7) * frame_has_in[:, None]
    sdf_neg = torch.abs(torch.clamp(hand_sdf_at_verts, -1e7, 0.0)) * frame_has_in[:, None]

    d2 = torch.sum((verts_local[:, None, :] - verts_local[None, :, :]) ** 2, dim=-1)  # (V, V)
    vid = torch.arange(V, device=d2.device)
    big = torch.tensor(1e10, dtype=d2.dtype, device=d2.device)
    # the candidate set has two forms: ids 0 and 1 out, or id 1 alone out
    # (a fully penetrating frame); the first minimum wins a tie
    near = torch.stack([torch.argmin(torch.where(ok[None, :], d2, big), dim=1)
                        for ok in ((vid != 1) & (vid != 0), vid != 1)])      # (2, V)
    n_in = in_mask.sum(dim=1)                                   # (F,)
    nearest = near[(n_in >= V).long()]                          # (F, V)
    in_err = (sdf_pos.sum(dim=0)[None, :] * in_mask).sum(dim=1)
    is_near_out = torch.zeros_like(in_mask).scatter_reduce(1, nearest, in_mask, "amax")
    out_err = (sdf_neg.sum(dim=0)[None, :] * is_near_out).sum(dim=1)
    denom = torch.clamp(in_time - 1.0, min=1.0) * torch.clamp(n_in, min=1.0)
    per = (in_err + out_weight * out_err) / denom
    total = torch.sum(per * frame_has_in) / torch.clamp(in_time, min=1.0)
    return torch.where(in_time > 1, total, torch.zeros_like(total))
