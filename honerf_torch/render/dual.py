"""Dual-volume (hand + object) renderer of the pose-fitting stage
(counterpart of honerf_tpu.render.dual): per-model hierarchical
importance sampling on separate z ladders, a merged sorted union of 64 +
2 x 64 samples, per-model sdf -> alpha, and occlusion-aware compositing
final_alpha = (1 - a_h + 1e-7)(1 - a_o + 1e-7) with the transmittance
seeded at ones (the fitting renderers' convention).

The ladder runs under torch.no_grad(), as the JAX package's ends in
stop_gradient: pose gradients reach the render through the fine pass
only.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from honerf_torch.render.neus import (
    Field,
    RenderConfig,
    coarse_z_vals,
    safe_norm,
    sdf_to_alpha,
)
from honerf_torch.render.sampling import (
    merge_sorted,
    merge_z_vals,
    neus_upsample_weights,
    sample_pdf_det,
)


@torch.no_grad()
def dual_hierarchical_z_vals(hand_field: Field, obj_field: Field, rays_o_hand: torch.Tensor,
                             rays_d_hand: torch.Tensor, rays_o_obj: torch.Tensor,
                             rays_d_obj: torch.Tensor, z_init: torch.Tensor,
                             rcfg: RenderConfig) -> torch.Tensor:
    """Interleaved per-model importance sampling: each model refines its
    own z ladder, and every new batch of samples also joins the shared
    union.  Returns the union sorted: (R, n_samples + 2 * n_importance)."""
    n_per_step = rcfg.n_importance // rcfg.up_sample_steps

    def eval_sdf(field, o, d, z):
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        return field.sdf_fn(pts.reshape(-1, 3)).reshape(z.shape)

    z_hand = z_obj = z_union = z_init
    sdf_hand = eval_sdf(hand_field, rays_o_hand, rays_d_hand, z_init)
    sdf_obj = eval_sdf(obj_field, rays_o_obj, rays_d_obj, z_init)
    for i in range(rcfg.up_sample_steps):
        inv_s = 64.0 * 2 ** i
        last = i + 1 == rcfg.up_sample_steps
        new_h = sample_pdf_det(z_hand, neus_upsample_weights(z_hand, sdf_hand, inv_s),
                               n_per_step)
        new_sdf_h = None if last else eval_sdf(hand_field, rays_o_hand, rays_d_hand, new_h)
        z_hand, sdf_hand = merge_z_vals(z_hand, new_h, sdf_hand, new_sdf_h)

        new_o = sample_pdf_det(z_obj, neus_upsample_weights(z_obj, sdf_obj, inv_s), n_per_step)
        new_sdf_o = None if last else eval_sdf(obj_field, rays_o_obj, rays_d_obj, new_o)
        z_obj, sdf_obj = merge_z_vals(z_obj, new_o, sdf_obj, new_sdf_o)

        new_ho, _ = merge_sorted(new_h, new_o)
        z_union, _ = merge_sorted(z_union, new_ho)
    return z_union


def render_dual(hand_field: Field, obj_field: Field, rcfg: RenderConfig,
                generator: Optional[torch.Generator], rays_o: torch.Tensor,
                rays_d: torch.Tensor, rays_o_obj: torch.Tensor, rays_d_obj: torch.Tensor,
                near: float, far: float) -> Dict[str, torch.Tensor]:
    """Render hand + object volumes along shared rays.

    rays_o / rays_d: (R, 3) world-frame rays (the hand lives in the
    world); rays_o_obj / rays_d_obj: the same rays in the object frame
    (rays_to_object_frame with the current pose estimate; pose gradients
    flow through it).  generator draws the coarse jitter (perturb > 0).

    Returns color_fine (R, 3), weight_sum (R, 1), per-sample sdf_hand /
    sdf_obj (R*S, 1), the gradient errors and the per-sample gradients."""
    n_rays = rays_o.shape[0]
    sample_dist = (far - near) / rcfg.n_samples
    z0 = coarse_z_vals(generator, n_rays, rcfg, near, far, device=rays_o.device)
    if rcfg.n_importance > 0:
        z_vals = dual_hierarchical_z_vals(hand_field, obj_field, rays_o.detach(),
                                          rays_d.detach(), rays_o_obj.detach(),
                                          rays_d_obj.detach(), z0, rcfg)
    else:
        z_vals = z0
    n_samples = z_vals.shape[-1]

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    dists_flat = dists.reshape(-1)

    def model_pass(field: Field, o, d):
        pts = (o[:, None, :] + d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
        dirs = d[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
        sdf, grad, color = field.full_fn(pts, dirs)
        alpha, _ = sdf_to_alpha(sdf, grad, dirs, dists_flat, field.inv_s)
        g_err = torch.mean((safe_norm(grad.reshape(n_rays, n_samples, 3)) - 1.0) ** 2)
        return (alpha.reshape(n_rays, n_samples), color.reshape(n_rays, n_samples, 3), sdf,
                g_err, grad)

    alpha_h, color_h, sdf_h, gerr_h, grad_h = model_pass(hand_field, rays_o, rays_d)
    alpha_o, color_o, sdf_o, gerr_o, grad_o = model_pass(obj_field, rays_o_obj, rays_d_obj)

    final_alpha = (1.0 - alpha_h + 1e-7) * (1.0 - alpha_o + 1e-7)
    trans = torch.cumprod(torch.cat([torch.ones_like(final_alpha[:, :1]), final_alpha], dim=-1),
                          dim=-1)[:, :-1]
    weights_h = alpha_h * trans
    weights_o = alpha_o * trans
    color = (torch.sum(color_h * weights_h[..., None], dim=1)
             + torch.sum(color_o * weights_o[..., None], dim=1))
    weight_sum = (torch.sum(weights_h, -1, keepdim=True)
                  + torch.sum(weights_o, -1, keepdim=True))
    return {
        "color_fine": color,
        "weight_sum": weight_sum,
        "sdf_hand": sdf_h[:, None],
        "sdf_obj": sdf_o[:, None],
        "gradient_error_hand": gerr_h,
        "gradient_error_obj": gerr_o,
        "gradient_hand": grad_h,
        "gradient_obj": grad_o,
    }
