"""Offline-training losses (counterpart of the offline part of
honerf_tpu.render.losses): fixed-shape masked reductions."""

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
