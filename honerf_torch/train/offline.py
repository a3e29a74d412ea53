"""The hand model's eval render (counterpart of the eval subset of
honerf_tpu.train.offline): camera -> rays -> HALO bone transforms ->
NeuS render.  The train steps come with the training slice.

Dispatch, as in the JAX package: the up-sample ladder uses the fused
ladder SDF (ops.fused_hand) unless `train.fused_ladder = false`; the fine
pass uses the color-fused kernel (ops.fused_fine_full) iff the SDF trunk
is bf16, and the autograd field path otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from honerf_torch.camera import Camera, xy_to_ray_bundle
from honerf_torch.hand import bone_transforms_from_mano_joints
from honerf_torch.models.fields import ColorConfig, SDFConfig
from honerf_torch.render.neus import (
    HandPacks,
    RenderConfig,
    make_hand_field,
    pack_hand_field,
    render_single,
)

Params = Dict[str, Any]


class TrainHyper(NamedTuple):
    """The `train` conf fields the render reads."""

    near: float = 0.4
    far: float = 1.5
    refine_pose: bool = True
    # fused ladder: None = on when the trunk is bf16, True/False = force
    fused_ladder: Optional[bool] = None
    # render the rays in chunks of this many (0 = one pass)
    ray_chunk: int = 0

    @classmethod
    def from_conf(cls, conf) -> "TrainHyper":
        fl = conf.get("train.fused_ladder", None)
        return cls(
            near=float(conf["train.near"]),
            far=float(conf["train.far"]),
            # per-view refinement applies to real data only
            refine_pose=(bool(conf.get("train.refine_pose", True))
                         and str(conf.get("general.data_type", "real")) == "real"),
            fused_ladder=None if fl is None else bool(fl),
            ray_chunk=int(conf.get("train.ray_chunk", 0)),
        )


def _render_rays_chunked(field, rcfg, tcfg, generator, o, d) -> Dict[str, torch.Tensor]:
    """render_single over the rays, in chunks of tcfg.ray_chunk."""
    n = o.shape[0]
    chunk = tcfg.ray_chunk
    if not chunk or n <= chunk:
        return render_single(field, rcfg, generator, o, d, tcfg.near, tcfg.far)
    outs = [render_single(field, rcfg, generator, o[s:s + chunk], d[s:s + chunk],
                          tcfg.near, tcfg.far)
            for s in range(0, n, chunk)]
    merged = {}
    for name in outs[0]:
        if outs[0][name].dim() == 0:  # per-ray mean (gradient_error)
            sizes = [min(chunk, n - s) for s in range(0, n, chunk)]
            merged[name] = sum(o_[name] * k for o_, k in zip(outs, sizes)) / n
        else:
            merged[name] = torch.cat([o_[name] for o_ in outs], dim=0)
    return merged


def hand_render_from_batch(params: Params, sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                           rcfg: RenderConfig, tcfg: TrainHyper, batch: Dict[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           fused_ladder: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Camera -> rays -> HALO bone transforms -> NeuS render.

    fused_ladder: None defers to tcfg.fused_ladder (itself None = on for a
    bf16 trunk), True/False forces the fused ladder on/off.  The fine pass
    takes the fused kernel iff the trunk is bf16."""
    want = fused_ladder if fused_ladder is not None else tcfg.fused_ladder
    use_fused = want if want is not None else sdf_cfg.trunk_dtype == "bf16"
    packs = pack_hand_field(params, sdf_cfg, color_cfg, fused_ladder=use_fused,
                            fused_fine=sdf_cfg.trunk_dtype == "bf16")
    return _render_packed(params, packs, sdf_cfg, color_cfg, rcfg, tcfg, batch, generator)


def _render_packed(params, packs: HandPacks, sdf_cfg, color_cfg, rcfg, tcfg, batch, generator):
    """hand_render_from_batch with the kernels' weights of `params` given."""
    if tcfg.refine_pose:
        raise NotImplementedError("per-view pose refinement comes with the training slice")
    cam = Camera(R=batch["cam_R"], T=batch["cam_T"], focal=batch["focal"],
                 principal=batch["principal"])
    rb = xy_to_ray_bundle(cam, batch["rays_xy"])
    bt_inv = bone_transforms_from_mano_joints(batch["joints"][None])[0]
    field = make_hand_field(params, sdf_cfg, color_cfg, bt_inv, batch["t_pose_21"], packs)
    return _render_rays_chunked(field, rcfg, tcfg, generator, rb.origins, rb.directions)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def make_hand_eval_render(sdf_cfg: SDFConfig, color_cfg: ColorConfig, rcfg: RenderConfig,
                          tcfg: TrainHyper):
    """Chunk render for inference: pose from the batch joints with no
    refinement, no perturbation; the fused ladder is on unless
    `train.fused_ladder = false`.  render_chunk(params, batch) ->
    (color_fine (R, 3), weight_sum (R, 1)).

    The kernels' weights are packed once per parameter snapshot: the
    packs are kept while every tensor of `params` is the same object at
    the same version counter (an in-place update bumps it)."""
    rcfg_eval = rcfg._replace(perturb=0.0)
    tcfg_eval = tcfg._replace(refine_pose=False)
    eval_fused = tcfg.fused_ladder is not False
    last = {"tensors": [], "versions": [], "packs": None}

    def packs_for(params):
        tensors = _tensors(params)
        versions = [t._version for t in tensors]
        same = (last["packs"] is not None and len(tensors) == len(last["tensors"])
                and all(a is b for a, b in zip(tensors, last["tensors"]))
                and versions == last["versions"])
        if not same:
            last.update(tensors=tensors, versions=versions, packs=pack_hand_field(
                params, sdf_cfg, color_cfg, fused_ladder=eval_fused,
                fused_fine=sdf_cfg.trunk_dtype == "bf16"))
        return last["packs"]

    def render_chunk(params, batch):
        with torch.no_grad():
            out = _render_packed(params, packs_for(params), sdf_cfg, color_cfg, rcfg_eval,
                                 tcfg_eval, batch, None)
        return out["color_fine"], out["weight_sum"]

    return render_chunk
