"""Hand and object SDF / color networks and the deviation; counterpart of
honerf_tpu.models.fields.

  * SDF MLP: 8x256, skip at 4, d_out = 257 (sdf + 256 features), softplus
    beta=100, geometric init, weight norm.  Hand: the 21-bone embedding
    (models.embedding) in, widened skip input concat(x, embedding)/sqrt2.
    Object: xyz PE (L=10, 63 channels) in, shrunk pre-skip output, so the
    skip input concat(x, embedding)/sqrt2 keeps the width; sdf / scale.
  * Color MLP: 4x256 relu + sigmoid; the hand's on (embedding | feature |
    grad-PE), the object's on (point-PE | dir-PE | feature | grad-PE).
  * Deviation: inv_s = exp(10 variance), clipped to [1e-6, 1e6].

Stored weights keep the reference's bone-major embedding columns; the
channel-major (flat) path gathers them with _cm_index / _gather_cols.
The spatial gradient comes from torch.autograd.grad, the reference's own
double-backprop formulation.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from honerf_torch.models.embedding import (
    channel_major_dest,
    hand_embedding,
    hand_embedding_flat,
    hand_embedding_width,
    positional_encoding,
)
from honerf_torch.models.mlp import (
    apply_linear,
    geometric_init_weights,
    init_linear,
    linear_weight,
    softplus_beta,
)
from honerf_torch.utils.device import resolve_device

Params = Dict[str, Any]

SQRT2 = math.sqrt(2.0)


class SDFConfig(NamedTuple):
    """Static architecture of an SDF MLP."""

    kind: str  # 'hand' | 'obj'
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    v_multires: int = 10
    r_multires: int = 4
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False
    flat_embedding: bool = True
    trunk_dtype: str = "f32"  # 'bf16': bf16 matmul operands, f32 accumulation

    @property
    def input_width(self) -> int:
        if self.kind == "hand":
            return hand_embedding_width(self.v_multires, self.r_multires)
        return self.d_in + 2 * self.v_multires * self.d_in

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.input_width,) + (self.d_hidden,) * self.n_layers + (self.d_out,)

    @property
    def skip_style(self) -> str:
        return "widen_input" if self.kind == "hand" else "shrink_output"


class ColorConfig(NamedTuple):
    """Static architecture of a color MLP."""

    kind: str
    d_feature: int = 256
    d_in: int = 3
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    v_multires: int = 10
    r_multires: int = 4
    grad_multires: int = 4
    squeeze_out: bool = True
    use_gradients: bool = True
    flat_embedding: bool = True
    trunk_dtype: str = "f32"

    @property
    def input_width(self) -> int:
        grad_ch = self.d_in + 2 * self.grad_multires * self.d_in
        if self.kind == "hand":
            base = hand_embedding_width(self.v_multires, self.r_multires) + self.d_feature
            return base + (grad_ch if self.use_gradients else 0)
        point_ch = self.d_in + 2 * self.v_multires * self.d_in
        dir_ch = self.d_in + 2 * self.r_multires * self.d_in
        return point_ch + dir_ch + self.d_feature + grad_ch

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.input_width,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


def sdf_config_from_conf(kind: str, conf: Dict[str, Any]) -> SDFConfig:
    """From a `model.sdf_network` conf section."""
    return SDFConfig(
        kind=kind,
        d_in=int(conf.get("d_in", 3)),
        d_out=int(conf.get("d_out", 257)),
        d_hidden=int(conf.get("d_hidden", 256)),
        n_layers=int(conf.get("n_layers", 8)),
        skip_in=tuple(conf.get("skip_in", [4])),
        v_multires=int(conf.get("v_multires", 10)),
        r_multires=int(conf.get("r_multires", 4)),
        bias=float(conf.get("bias", 0.5)),
        scale=float(conf.get("scale", 1.0)),
        geometric_init=bool(conf.get("geometric_init", True)),
        weight_norm=bool(conf.get("weight_norm", True)),
        inside_outside=bool(conf.get("inside_outside", False)),
        trunk_dtype=str(conf.get("trunk_dtype", "f32")),
    )


def color_config_from_conf(kind: str, conf: Dict[str, Any]) -> ColorConfig:
    """From a `model.rendering_network` conf section."""
    return ColorConfig(
        kind=kind,
        d_feature=int(conf.get("d_feature", 256)),
        d_in=int(conf.get("d_in", 3)),
        d_out=int(conf.get("d_out", 3)),
        d_hidden=int(conf.get("d_hidden", 256)),
        n_layers=int(conf.get("n_layers", 4)),
        weight_norm=bool(conf.get("weight_norm", True)),
        v_multires=int(conf.get("v_multires", 10)),
        r_multires=int(conf.get("r_multires", 4)),
        grad_multires=int(conf.get("grad_multires", 4)),
        squeeze_out=bool(conf.get("squeeze_out", True)),
        use_gradients=bool(conf.get("use_gradients", True)),
        trunk_dtype=str(conf.get("trunk_dtype", "f32")),
    )


# ---------------------------------------------------------------------------
# Initialization (torch.Generator streams; values differ from jax.random).
# The parameters land on the card unless the caller passes device="cpu".
# ---------------------------------------------------------------------------

def init_sdf_params(generator: torch.Generator, cfg: SDFConfig, device=None) -> Params:
    device = resolve_device(device)
    dims = cfg.dims
    layers = []
    if cfg.geometric_init:
        wb = geometric_init_weights(
            generator, dims, cfg.skip_in, cfg.bias, cfg.inside_outside, cfg.skip_style
        )
        for w, b in wb:
            layers.append(init_linear(None, 0, 0, cfg.weight_norm, w_init=w,
                                      b_init=b, device=device))
    else:
        for l in range(len(dims) - 1):
            if cfg.skip_style == "widen_input":
                d_in = dims[l] + dims[0] if l in cfg.skip_in else dims[l]
                d_out = dims[l + 1]
            else:
                d_in = dims[l]
                d_out = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
            layers.append(init_linear(generator, d_in, d_out, cfg.weight_norm,
                                      device=device))
    return {"layers": layers}


def init_color_params(generator: torch.Generator, cfg: ColorConfig, device=None) -> Params:
    device = resolve_device(device)
    dims = cfg.dims
    return {"layers": [
        init_linear(generator, dims[l], dims[l + 1], cfg.weight_norm, device=device)
        for l in range(len(dims) - 1)
    ]}


def init_variance_params(init_val: float = 0.3, device=None) -> Params:
    return {"variance": torch.tensor(float(init_val), device=resolve_device(device))}


def init_se3_refine(n_frames: int, kind: str, device=None) -> torch.Tensor:
    """Per-training-image pose-refinement table: identity rot6d in the
    first 6 slots (36 columns for the hand, 9 for the object)."""
    width = 36 if kind == "hand" else 9
    table = torch.zeros((n_frames, width), device=resolve_device(device))
    table[:, 0] = 1.0
    table[:, 3] = 1.0
    return table


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

def _mlp_trunk(layers, x: torch.Tensor, skip_in: Tuple[int, ...], n_layers_total: int,
               activation, dtype: str = "f32") -> torch.Tensor:
    """dtype='bf16': bf16 inputs, weights and activations, f32
    accumulation and f32 output (operands are rounded to bf16 and
    multiplied in f32, which is what an f32-accumulating bf16 matmul
    computes)."""
    bf16 = dtype == "bf16"
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    inputs = rnd(x)
    x = inputs
    for l in range(n_layers_total - 1):
        if l in skip_in:
            # bf16 / python float rounds the divisor to bf16 as well
            x = rnd(torch.cat([x, inputs], dim=-1) / (rnd(torch.tensor(SQRT2)).item()
                                                      if bf16 else SQRT2))
        if not bf16:
            x = apply_linear(layers[l], x)
        else:
            x = x @ rnd(linear_weight(layers[l])).T + layers[l]["b"]
            x = x if l == n_layers_total - 2 else rnd(x)
        if l < n_layers_total - 2:
            x = rnd(activation(x)) if bf16 else activation(x)
    return x


@functools.lru_cache(maxsize=8)
def _cm_index(v_multires: int, r_multires: int, prefix: int, tail: int) -> np.ndarray:
    """Column gather index mapping bone-major stored weights onto the
    channel-major embedding: cols [prefix, prefix+W) permuted by
    channel_major_dest, `prefix` leading and `tail` trailing cols kept."""
    dest = channel_major_dest(v_multires, r_multires)
    w = len(dest)
    return np.concatenate([
        np.arange(prefix), prefix + dest, np.arange(prefix + w, prefix + w + tail)
    ])


def _gather_cols(layer: Params, idx: np.ndarray) -> Params:
    """w'[:, i] = w[:, idx[i]] (commutes with weight norm's row scaling,
    so 'v' is gathered directly)."""
    out = dict(layer)
    key = "v" if "v" in layer else "w"
    out[key] = layer[key][:, torch.as_tensor(idx, device=layer[key].device)]
    return out


def _flat_sdf_layers(params: Params, cfg: SDFConfig):
    layers = list(params["layers"])
    layers[0] = _gather_cols(layers[0], _cm_index(cfg.v_multires, cfg.r_multires, 0, 0))
    for s in cfg.skip_in:
        layers[s] = _gather_cols(
            layers[s], _cm_index(cfg.v_multires, cfg.r_multires, cfg.d_hidden, 0))
    return layers


def sdf_obj_apply(params: Params, cfg: SDFConfig, pts: torch.Tensor) -> torch.Tensor:
    """Object SDF forward: (..., 3) -> (..., 257) [sdf / scale, features]."""
    emb = torch.cat([pts, positional_encoding(pts, cfg.v_multires)], dim=-1)
    out = _mlp_trunk(params["layers"], emb, cfg.skip_in, len(cfg.dims), softplus_beta,
                     cfg.trunk_dtype)
    return torch.cat([out[..., :1] / cfg.scale, out[..., 1:]], dim=-1)


def sdf_hand_apply(params: Params, cfg: SDFConfig, pts: torch.Tensor,
                   bt_inv: torch.Tensor, t_pose_21: torch.Tensor):
    """Hand SDF forward -> (out257, xyz_feature, r, h).  With
    cfg.flat_embedding xyz_feature is channel-major."""
    if cfg.flat_embedding:
        xyz_feature, r, h = hand_embedding_flat(
            pts, bt_inv, t_pose_21, cfg.v_multires, cfg.r_multires)
        layers = _flat_sdf_layers(params, cfg)
    else:
        xyz_feature, r, h = hand_embedding(
            pts, bt_inv, t_pose_21, cfg.v_multires, cfg.r_multires)
        layers = params["layers"]
    out = _mlp_trunk(layers, xyz_feature, cfg.skip_in, len(cfg.dims), softplus_beta,
                     cfg.trunk_dtype)
    return out, xyz_feature, r, h


def _flat_color_layers(params: Params, cfg: ColorConfig):
    w = hand_embedding_width(cfg.v_multires, cfg.r_multires)
    layers = list(params["layers"])
    layers[0] = _gather_cols(
        layers[0], _cm_index(cfg.v_multires, cfg.r_multires, 0, cfg.input_width - w))
    return layers


def color_hand_apply(params: Params, cfg: ColorConfig, xyz_feature: torch.Tensor,
                     feature_vector: torch.Tensor, gradients: torch.Tensor) -> torch.Tensor:
    """Hand color net on (xyz_feature | feature | gradient-PE)."""
    x = torch.cat([xyz_feature, feature_vector], dim=-1)
    if cfg.use_gradients:
        grad_emb = torch.cat(
            [gradients, positional_encoding(gradients, cfg.grad_multires)], dim=-1)
        x = torch.cat([x, grad_emb], dim=-1)
    layers = _flat_color_layers(params, cfg) if cfg.flat_embedding else params["layers"]
    out = _mlp_trunk(layers, x, (), len(cfg.dims), torch.relu, cfg.trunk_dtype)
    return torch.sigmoid(out) if cfg.squeeze_out else out


def color_obj_apply(params: Params, cfg: ColorConfig, pts: torch.Tensor, dirs: torch.Tensor,
                    feature_vector: torch.Tensor, gradients: torch.Tensor) -> torch.Tensor:
    """Object color net on (point-PE | dir-PE | feature | gradient-PE)."""
    point_emb = torch.cat([pts, positional_encoding(pts, cfg.v_multires)], dim=-1)
    dir_emb = torch.cat([dirs, positional_encoding(dirs, cfg.r_multires)], dim=-1)
    grad_emb = torch.cat([gradients, positional_encoding(gradients, cfg.grad_multires)], dim=-1)
    x = torch.cat([point_emb, dir_emb, feature_vector, grad_emb], dim=-1)
    out = _mlp_trunk(params["layers"], x, (), len(cfg.dims), torch.relu, cfg.trunk_dtype)
    return torch.sigmoid(out) if cfg.squeeze_out else out


def variance_apply(params: Params) -> torch.Tensor:
    """inv_s = exp(10 variance), clipped like the renderer."""
    return torch.clamp(torch.exp(params["variance"] * 10.0), 1e-6, 1e6)


def sdf_obj_value_feat_grad(params: Params, cfg: SDFConfig, pts: torch.Tensor,
                            create_graph: Optional[bool] = None):
    """(sdf (...,1), features (...,256), grad (...,3)); grad is d sdf / d
    pts by autograd, create_graph as in sdf_hand_value_feat_grad."""
    if create_graph is None:
        create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        out = sdf_obj_apply(params, cfg, p)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), p, create_graph=create_graph)
    if not create_graph:
        out, grad = out.detach(), grad.detach()
    return out[..., :1], out[..., 1:], grad


def sdf_hand_value_feat_grad(params: Params, cfg: SDFConfig, pts: torch.Tensor,
                             bt_inv: torch.Tensor, t_pose_21: torch.Tensor,
                             create_graph: Optional[bool] = None):
    """(sdf (...,1), features, xyz_feature, r, h, grad (...,3)); grad is
    d sdf / d pts by autograd.  create_graph defaults to whether grad mode
    is on (training differentiates through the gradient, eval does not)."""
    if create_graph is None:
        create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        out, xyz_feature, r, h = sdf_hand_apply(params, cfg, p, bt_inv, t_pose_21)
        (grad,) = torch.autograd.grad(out[..., 0].sum(), p, create_graph=create_graph)
    if not create_graph:
        out, xyz_feature, grad = out.detach(), xyz_feature.detach(), grad.detach()
    return out[..., :1], out[..., 1:], xyz_feature, r, h, grad


# ---------------------------------------------------------------------------
# Color-fused fine pass (ops/fused_fine_full.py)
# ---------------------------------------------------------------------------

def _fine_trunk_weights(params: Params, cfg: SDFConfig):
    """Materialized (in, out) trunk weights with channel-major e columns."""
    layers = _flat_sdf_layers(params, cfg)
    ws = tuple(linear_weight(l).T for l in layers)
    bs = tuple(l["b"] for l in layers)
    return ws, bs


def fine_color_weights(params: Params, sdf_cfg: SDFConfig, color_cfg: ColorConfig):
    """(meta, ws, bs, cws, cbs): the fine pass's static architecture and
    its (in, out) trunk and color weights with channel-major e columns,
    differentiable functions of `params` (weight norm and column gather
    included)."""
    from honerf_torch.ops.fused_fine_full import FineMeta

    assert len(sdf_cfg.skip_in) == 1
    assert color_cfg.use_gradients and color_cfg.squeeze_out
    meta = FineMeta(
        v_multires=sdf_cfg.v_multires, r_multires=sdf_cfg.r_multires,
        d_hidden=sdf_cfg.d_hidden, n_layers=len(sdf_cfg.dims) - 1,
        skip=sdf_cfg.skip_in[0], d_out=sdf_cfg.d_out,
        dtype="bf16" if sdf_cfg.trunk_dtype == "bf16" else "f32",
        c_hidden=color_cfg.d_hidden, c_layers=len(color_cfg.dims) - 1,
        grad_L=color_cfg.grad_multires,
    )
    if color_cfg.input_width != meta.emb_width + (meta.d_out - 1) + 3 + 6 * meta.grad_L:
        raise ValueError("color net input does not match the SDF net's outputs")
    ws, bs = _fine_trunk_weights(params["sdf"], sdf_cfg)
    clayers = _flat_color_layers(params["color"], color_cfg)
    cws = tuple(linear_weight(l).T for l in clayers)
    cbs = tuple(l["b"] for l in clayers)
    return meta, ws, bs, cws, cbs


def pack_fine_color(params: Params, sdf_cfg: SDFConfig, color_cfg: ColorConfig):
    """Pack {'sdf', 'color'} params for ops.fused_fine_full.hand_fine_color_fwd
    (once per parameter snapshot)."""
    from honerf_torch.ops.fused_fine_full import pack_fine_weights

    meta, ws, bs, cws, cbs = fine_color_weights(params, sdf_cfg, color_cfg)
    return pack_fine_weights(ws, bs, cws, cbs, meta)


def hand_fine_color_apply(params: Params, sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                          pts: torch.Tensor, bt_inv: torch.Tensor,
                          t_pose_21: torch.Tensor, pack=None):
    """(sdf (N,), grad (N, 3), color (N, 3)) via the color-fused fine pass:
    embedding, trunk, spatial gradient and the color net in one op.
    Without `pack` the op is differentiable in the params, the points and
    the pose (bt_inv, through pack_hand_pose); with a pack made once per
    parameter snapshot (pack_fine_color) it runs the forward only."""
    from honerf_torch.ops.fused_fine_full import hand_fine_color, hand_fine_color_fwd
    from honerf_torch.ops.fused_hand import pack_hand_pose

    rotT, off, cut = pack_hand_pose(bt_inv, t_pose_21)
    if pack is not None:
        return hand_fine_color_fwd(pts, rotT, off, cut, pack)
    meta, ws, bs, cws, cbs = fine_color_weights(params, sdf_cfg, color_cfg)
    return hand_fine_color(pts, rotT, off, cut, ws, bs, cws, cbs, meta)
