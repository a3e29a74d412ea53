"""Single-volume NeuS renderer (counterpart of honerf_tpu.render.neus).

Quirks of the reference kept:
  * the transmittance cumprod is seeded with prev_cdf[:, :1], not ones
    (the reference's cumprod_seed='prev_cdf'; standard NeuS seeds ones);
  * alpha = clip((p + 1e-5) / (c + 1e-5), 0, 1).

Fields: make_obj_field, the object in its local frame (rays moved there
by rays_to_object_frame), plain PyTorch as in the JAX package;
make_hand_field, the pose-conditioned hand.

Kernel dispatch (make_hand_field): the packs of pack_hand_field choose
the path.  A ladder pack serves the up-sample ladder from ops.fused_hand;
the fine pass runs in one of the modes of `train.fused_fine`:
  'full'          ops.fused_fine_full.hand_fine_color (K2 / K3 with the
                  color net);
  'full_nocolor'  the same op with FineMeta.with_color False (JAX's
                  hand_fine_full: K2 / K3 without the color net), then
                  the color net in torch;
  'pallas'        ops.fused_fine.hand_trunk_sdf_u (K5 / K6) on the
                  embedding, then the color net in torch;
  None            the autograd field.
Each kernel mode runs forward-only on weights packed once per parameter
snapshot (eval), or as a differentiable op that packs on each call
(training); on weights that need no gradient (pose fitting's frozen
nets) that op's backward launches no weight work (K3 frozen, f32 for the
fit confs' f32 trunks).  Each launches its CUDA kernels on a CUDA tensor
and runs its plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from honerf_torch.models.fields import (
    ColorConfig,
    SDFConfig,
    color_hand_apply,
    color_obj_apply,
    hand_fine_color_apply,
    pack_fine_color,
    pack_fine_nocolor,
    pack_trunk_sdf,
    sdf_hand_apply,
    sdf_hand_value_feat_grad,
    sdf_hand_value_feat_grad_full,
    sdf_hand_value_feat_grad_fused,
    sdf_obj_apply,
    sdf_obj_value_feat_grad,
    variance_apply,
)
from honerf_torch.render.sampling import hierarchical_z_vals


class RenderConfig(NamedTuple):
    """`model.neus_renderer` conf section."""

    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0

    @classmethod
    def from_conf(cls, conf: Dict[str, Any]) -> "RenderConfig":
        return cls(
            n_samples=int(conf.get("n_samples", 64)),
            n_importance=int(conf.get("n_importance", 64)),
            n_outside=int(conf.get("n_outside", 0)),
            up_sample_steps=int(conf.get("up_sample_steps", 4)),
            perturb=float(conf.get("perturb", 1.0)),
        )


class Field(NamedTuple):
    """sdf_fn: (N, 3) -> (N,);  full_fn: (pts, dirs) -> (sdf, grad, color);
    inv_s: scalar deviation."""

    sdf_fn: Callable
    full_fn: Callable
    inv_s: torch.Tensor


def make_obj_field(params: Dict[str, Any], sdf_cfg: SDFConfig, color_cfg: ColorConfig) -> Field:
    """Object field in its local frame (rays must be moved there by
    rays_to_object_frame); the spatial gradient by autograd."""

    def sdf_fn(pts):
        return sdf_obj_apply(params["sdf"], sdf_cfg, pts)[..., 0]

    def full_fn(pts, dirs):
        sdf, feat, grad = sdf_obj_value_feat_grad(params["sdf"], sdf_cfg, pts)
        color = color_obj_apply(params["color"], color_cfg, pts, dirs, feat, grad)
        return sdf[..., 0], grad, color

    return Field(sdf_fn, full_fn, variance_apply(params["variance"]))


def rays_to_object_frame(rays_o: torch.Tensor, rays_d: torch.Tensor, Ro: torch.Tensor,
                         To: torch.Tensor):
    """World rays -> object-local frame: o' = Ro^T (o - To), d' = Ro^T d."""
    return (rays_o - To) @ Ro, rays_d @ Ro


#: the fine pass's kernel modes (module docstring)
FINE_MODES = ("full", "full_nocolor", "pallas")


class HandPacks(NamedTuple):
    """The kernels' weights of one parameter snapshot.  ladder:
    ops.fused_hand.FusedHandSDF, None for the exact ladder; fine: the fine
    pass's mode (FINE_MODES), None for the autograd field; fine_pack: its
    weights packed for the forward only, None for the differentiable op,
    which packs them on each call."""

    ladder: Optional[Any] = None
    fine: Optional[str] = None
    fine_pack: Optional[Any] = None


def pack_hand_field(params: Dict[str, Any], sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                    fused_ladder: bool, fine: Optional[str], grad: bool = False) -> HandPacks:
    """Pack the weights once per parameter snapshot.  fused_ladder: the
    ladder's sdf_fn is ops.fused_hand (bf16 weights whatever the trunk's
    dtype, no gradient; the ladder needs none).  fine: the fine pass's mode, forward only on a
    pack, or the differentiable op when `grad`."""
    from honerf_torch.ops.fused_hand import FusedHandSDF

    if fine is not None and fine not in FINE_MODES:
        raise ValueError(f"unknown fine-pass mode {fine!r}")
    packers = {"full": lambda: pack_fine_color(params, sdf_cfg, color_cfg),
               "full_nocolor": lambda: pack_fine_nocolor(params["sdf"], sdf_cfg),
               "pallas": lambda: pack_trunk_sdf(params["sdf"], sdf_cfg)}
    with torch.no_grad():
        return HandPacks(
            ladder=FusedHandSDF(params["sdf"], sdf_cfg) if fused_ladder else None,
            fine=fine,
            fine_pack=packers[fine]() if fine is not None and not grad else None)


def make_hand_field(params: Dict[str, Any], sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                    bt_inv: torch.Tensor, t_pose_21: torch.Tensor,
                    packs: HandPacks = HandPacks()) -> Field:
    """Pose-conditioned hand field; `packs` (from pack_hand_field on the
    same params) choose the kernel path of the ladder and the fine pass."""
    if packs.ladder is not None:
        def sdf_fn(pts):
            return packs.ladder(pts, bt_inv, t_pose_21)
    else:
        fwd_cfg = sdf_cfg._replace(flat_embedding=False)

        def sdf_fn(pts):
            return sdf_hand_apply(params["sdf"], fwd_cfg, pts, bt_inv, t_pose_21)[0][..., 0]

    if packs.fine == "full":
        def full_fn(pts, dirs):
            return hand_fine_color_apply(params, sdf_cfg, color_cfg, pts, bt_inv, t_pose_21,
                                         pack=packs.fine_pack)
    elif packs.fine in ("full_nocolor", "pallas"):
        value_grad = (sdf_hand_value_feat_grad_full if packs.fine == "full_nocolor"
                      else sdf_hand_value_feat_grad_fused)

        def full_fn(pts, dirs):
            sdf, feat, xyz_feature, _r, _h, grad = value_grad(
                params["sdf"], sdf_cfg, pts, bt_inv, t_pose_21, pack=packs.fine_pack)
            color = color_hand_apply(params["color"], color_cfg, xyz_feature, feat, grad)
            return sdf[..., 0], grad, color
    else:
        def full_fn(pts, dirs):
            sdf, feat, xyz_feature, _r, _h, grad = sdf_hand_value_feat_grad(
                params["sdf"], sdf_cfg, pts, bt_inv, t_pose_21)
            color = color_hand_apply(params["color"], color_cfg, xyz_feature, feat, grad)
            return sdf[..., 0], grad, color

    return Field(sdf_fn, full_fn, variance_apply(params["variance"]))


def coarse_z_vals(generator: Optional[torch.Generator], n_rays: int, rcfg: RenderConfig,
                  near: float, far: float, device=None) -> torch.Tensor:
    """Stratified coarse samples with one per-ray jiggle when perturb > 0."""
    sample_dist = (far - near) / rcfg.n_samples
    z = near + (far - near) * torch.linspace(0.0, 1.0, rcfg.n_samples, device=device)
    z = z[None, :].expand(n_rays, rcfg.n_samples)
    if rcfg.perturb > 0:
        t_rand = torch.rand((n_rays, 1), generator=generator, device=device) - 0.5
        z = z + t_rand * sample_dist
    return z


def safe_norm(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(v^2) + eps): finite gradient at v == 0."""
    return torch.sqrt(torch.sum(v * v, dim=dim) + eps)


def sdf_to_alpha(sdf, grad, dirs, dists, inv_s):
    """NeuS sdf -> (alpha, prev_cdf), all flat over (R*S,)."""
    true_cos = torch.sum(dirs * grad, dim=-1)
    iter_cos = -torch.relu(-true_cos)  # cos_anneal_ratio == 1
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    p = prev_cdf - next_cdf
    alpha = torch.clamp((p + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return alpha, prev_cdf


def render_single(field: Field, rcfg: RenderConfig, generator: Optional[torch.Generator],
                  rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
                  far: float) -> Dict[str, torch.Tensor]:
    """Render (R, 3) rays through one SDF field.  Returns color_fine (R,3),
    s_val, cdf_fine (R,S), weight_sum (R,1), weight_max (R,1),
    gradient_error and weights."""
    n_rays = rays_o.shape[0]
    sample_dist = (far - near) / rcfg.n_samples
    z_vals = coarse_z_vals(generator, n_rays, rcfg, near, far, device=rays_o.device)
    if rcfg.n_importance > 0:
        z_vals = hierarchical_z_vals(field.sdf_fn, rays_o.detach(), rays_d.detach(), z_vals,
                                     rcfg.n_importance, rcfg.up_sample_steps)
    n_samples = z_vals.shape[-1]

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = dirs.reshape(-1, 3)

    sdf, grad, color = field.full_fn(pts_flat, dirs_flat)
    alpha, prev_cdf = sdf_to_alpha(sdf, grad, dirs_flat, dists.reshape(-1), field.inv_s)
    alpha = alpha.reshape(n_rays, n_samples)
    c = prev_cdf.reshape(n_rays, n_samples)

    trans = torch.cumprod(torch.cat([c[:, :1], 1.0 - alpha + 1e-7], dim=-1), dim=-1)[:, :-1]
    weights = alpha * trans
    color_fine = torch.sum(color.reshape(n_rays, n_samples, 3) * weights[..., None], dim=1)
    grad = grad.reshape(n_rays, n_samples, 3)
    return {
        "color_fine": color_fine,
        "s_val": torch.full((n_rays, 1), 1.0, device=rays_o.device) / field.inv_s,
        "cdf_fine": c,
        "weight_sum": torch.sum(weights, dim=-1, keepdim=True),
        "weight_max": torch.max(weights, dim=-1, keepdim=True).values,
        "gradient_error": torch.mean((safe_norm(grad) - 1.0) ** 2),
        "weights": weights,
    }
