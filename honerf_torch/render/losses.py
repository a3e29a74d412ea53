"""Losses of offline training and of pose fitting (counterpart of
honerf_tpu.render.losses, less the video fitter's): fixed-shape masked
reductions."""

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
