"""Hierarchical SDF-guided ray sampling (counterpart of
honerf_tpu.render.sampling).  The up-sampling ladder runs under
torch.no_grad(), as the reference's does."""

from __future__ import annotations

from typing import Optional

import torch


def sample_pdf_det(bins: torch.Tensor, weights: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Deterministic inverse-CDF sampling: bins (R, S) sorted, weights
    (R, S-1) -> (R, n_samples) new z values."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                       dtype=cdf.dtype, device=cdf.device)
    u = u.expand(cdf.shape[:-1] + (n_samples,)).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def neus_upsample_weights(z_vals: torch.Tensor, sdf: torch.Tensor, inv_s: float) -> torch.Tensor:
    """Interval weights (R, S-1) for SDF-guided up-sampling at fixed inv_s."""
    prev_sdf, next_sdf = sdf[..., :-1], sdf[..., 1:]
    prev_z, next_z = z_vals[..., :-1], z_vals[..., 1:]
    mid_sdf = 0.5 * (prev_sdf + next_sdf)
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[..., :1]), cos_val[..., :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0)
    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-7], dim=-1), dim=-1
    )[..., :-1]
    return alpha * trans


def merge_sorted(z_a: torch.Tensor, z_b: torch.Tensor,
                 sdf_a: Optional[torch.Tensor] = None, sdf_b: Optional[torch.Tensor] = None):
    """Sorted merge of two per-ray sorted z arrays, carrying sdf along: a
    stable sort of the concatenation.  The z values equal a full sort's;
    a tie keeps each z with its own sdf."""
    z = torch.cat([z_a, z_b], dim=-1)
    z_sorted, order = torch.sort(z, dim=-1, stable=True)
    if sdf_a is None:
        return z_sorted, None
    return z_sorted, torch.gather(torch.cat([sdf_a, sdf_b], dim=-1), -1, order)


def merge_z_vals(z_vals, new_z_vals, sdf, new_sdf):
    """merge_sorted with the `last` step's new_sdf=None (z only)."""
    if new_sdf is None:
        return merge_sorted(z_vals, new_z_vals)
    return merge_sorted(z_vals, new_z_vals, sdf, new_sdf)


@torch.no_grad()
def hierarchical_z_vals(sdf_fn, rays_o, rays_d, z_vals, n_importance: int,
                        up_sample_steps: int, base_inv_s: float = 64.0) -> torch.Tensor:
    """`up_sample_steps` rounds of SDF-guided importance sampling, growing
    z_vals (R, S) to (R, S + n_importance)."""
    n_per_step = n_importance // up_sample_steps
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    sdf = sdf_fn(pts.reshape(-1, 3)).reshape(z_vals.shape)
    for i in range(up_sample_steps):
        weights = neus_upsample_weights(z_vals, sdf, base_inv_s * 2 ** i)
        new_z = sample_pdf_det(z_vals, weights, n_per_step)
        if i + 1 < up_sample_steps:
            new_pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z[..., None]
            new_sdf = sdf_fn(new_pts.reshape(-1, 3)).reshape(new_z.shape)
        else:
            new_sdf = None
        z_vals, sdf = merge_z_vals(z_vals, new_z, sdf, new_sdf)
    return z_vals
