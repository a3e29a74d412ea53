"""The offline train steps and eval renders of the hand and object models
(counterpart of honerf_tpu.train.offline): camera -> rays -> the per-view
se3_refine pose refinement (the object's rotation and translation, or the
hand's HALO bone transforms) -> NeuS render -> masked-L1 + mask-BCE +
eikonal loss -> global-norm grad clip -> Adam.  The object model runs no
kernel, as in the JAX package: its field is plain PyTorch.

Hand dispatch, as in the JAX package: the up-sample ladder uses the fused
ladder SDF (ops.fused_hand, no gradient) unless `train.fused_ladder =
false`; the fine pass, in training and in the eval render alike, runs the
mode `select_fine_pass` picks from `train.fused_fine` and the SDF trunk's
dtype (render.neus: 'full' = K2/K3 with the color net, 'full_nocolor' =
K2/K3 without it, 'pallas' = K5/K6, None = the autograd field), JAX's
choice on one chip; on the card a bf16 trunk never leaves its kernels,
and an f32 trunk runs the kernels' f32 modes when `train.fused_fine`
names a mode.  The eval render packs the
kernels' weights once per parameter snapshot; the train step packs them
inside the differentiable op on every call.

The port updates the train state in place (params, Adam moments, step
count); the JAX step returns a new one.  Not ported: the VGG patch term
(its pretrained weights are not in the repository; train with
vgg_weight = 0), `make_multi_step` (a scan of steps per dispatch) and the
ray_chunk miscompile workaround, both TPU artifacts.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from honerf_torch.camera import Camera, xy_to_ray_bundle
from honerf_torch.hand import bone_transforms_from_mano_joints, refined_hand_joints
from honerf_torch.models.fields import ColorConfig, SDFConfig
from honerf_torch.render.losses import mask_bce, masked_l1_color, masked_psnr
from honerf_torch.render.neus import (
    FINE_MODES,
    HandPacks,
    RenderConfig,
    make_hand_field,
    make_obj_field,
    pack_hand_field,
    rays_to_object_frame,
    render_single,
)
from honerf_torch.train.schedule import make_lr_schedule
from honerf_torch.utils.transforms import rot6d_to_matrix

Params = Dict[str, Any]

_logger = logging.getLogger(__name__)
# fine-pass selections already logged by this process
_LOGGED_FINE_SELECTIONS: set = set()

#: Auto grad-clip threshold for bf16 trunks (resolve_grad_clip): the JAX
#: package's calibration on full-size runs (PARITY.md).
DEFAULT_BF16_GRAD_CLIP = 50.0


class TrainHyper(NamedTuple):
    """The `train` conf section."""

    near: float = 0.4
    far: float = 1.5
    learning_rate: float = 1e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300000
    warm_up_end: float = 5000.0
    igr_weight: float = 1.0
    mask_weight: float = 1.0
    vgg_weight: float = 1.0
    refine_pose: bool = True
    batch_size: int = 441
    # fused ladder: None = on when the trunk is bf16, True/False = force
    fused_ladder: Optional[bool] = None
    # the fine pass (`train.fused_fine`, select_fine_pass): None = auto,
    # True/'full', 'full_nocolor', 'pallas', 'xla', False
    fused_fine: Any = None
    # render the rays in chunks of this many (0 = one pass)
    ray_chunk: int = 0
    # global-norm gradient clip: None = auto (resolve_grad_clip), 0 = off
    grad_clip: Optional[float] = None

    @classmethod
    def from_conf(cls, conf) -> "TrainHyper":
        opt = lambda key, f: None if conf.get(key, None) is None else f(conf.get(key))  # noqa: E731
        return cls(
            near=float(conf["train.near"]),
            far=float(conf["train.far"]),
            learning_rate=float(conf["train.learning_rate"]),
            learning_rate_alpha=float(conf["train.learning_rate_alpha"]),
            end_iter=int(conf["train.end_iter"]),
            warm_up_end=float(conf.get("train.warm_up_end", 0.0)),
            igr_weight=float(conf["train.igr_weight"]),
            mask_weight=float(conf["train.mask_weight"]),
            vgg_weight=float(conf.get("train.vgg_weight", 0.0)),
            # per-view refinement applies to real data only
            refine_pose=(bool(conf.get("train.refine_pose", True))
                         and str(conf.get("general.data_type", "real")) == "real"),
            batch_size=int(conf["train.batch_size"]),
            fused_ladder=opt("train.fused_ladder", bool),
            fused_fine=opt("train.fused_fine", lambda v: v if isinstance(v, str) else bool(v)),
            ray_chunk=int(conf.get("train.ray_chunk", 0)),
            grad_clip=opt("train.grad_clip", float),
        )


def select_fine_pass(tcfg: TrainHyper, sdf_cfg: SDFConfig, device) -> Optional[str]:
    """The fine pass's mode (render.neus.FINE_MODES, None = the autograd
    field) for `train.fused_fine` and the SDF trunk's dtype: the JAX
    package's choice on one chip (honerf_tpu/train/offline.py:399-409).
    Every kernel mode runs on the card with a bf16 or an f32 trunk.  On
    the card (a CUDA `device`) it raises NotImplementedError for 'xla'
    (the JAX package's pure-XLA lowering of K5/K6's statements for meshes
    where Pallas cannot run; here those statements are K5/K6's plain
    version: use 'pallas') and for a bf16 trunk told to leave its kernels
    (False or an unknown value).  On the CPU the kernel modes run their
    plain versions and 'xla' is 'pallas' (the same statements)."""
    want, bf16 = tcfg.fused_fine, sdf_cfg.trunk_dtype == "bf16"
    on_card = torch.device(device).type == "cuda"
    if want is None:        # auto: the color-fused kernels for a bf16 trunk
        return "full" if bf16 else None
    if want is True:
        want = "full"
    if want == "xla":
        if on_card:
            raise NotImplementedError(
                "train.fused_fine = 'xla' (the JAX package's XLA lowering of K5/K6's "
                "statements) has no kernel on the card: use 'pallas'")
        return "pallas"
    if want in FINE_MODES:
        return want
    if on_card and bf16:
        raise NotImplementedError(
            f"train.fused_fine = {want!r} would take a bf16 trunk off its kernels on the card")
    return None


def _fine_pass(tcfg: TrainHyper, sdf_cfg: SDFConfig, device, fused_ladder: bool):
    """select_fine_pass, logged once per process per selection."""
    fine = select_fine_pass(tcfg, sdf_cfg, device)
    sel = (fine or "autograd", bool(fused_ladder))
    if sel not in _LOGGED_FINE_SELECTIONS:
        _LOGGED_FINE_SELECTIONS.add(sel)
        _logger.info("hand fine pass: %s (fused_ladder=%s, trunk_dtype=%s, "
                     "conf train.fused_fine=%r)", sel[0], sel[1], sdf_cfg.trunk_dtype,
                     tcfg.fused_fine)
    return fine


def resolve_grad_clip(tcfg: TrainHyper, sdf_cfg: SDFConfig) -> float:
    """Effective global-norm clip (0 = off): `train.grad_clip` if set, else
    DEFAULT_BF16_GRAD_CLIP for a bf16 trunk and off for f32 (the reference
    never clips)."""
    if tcfg.grad_clip is not None:
        return float(tcfg.grad_clip)
    return DEFAULT_BF16_GRAD_CLIP if sdf_cfg.trunk_dtype == "bf16" else 0.0


def _clipped_grads(grads: List[torch.Tensor], clip: float) -> torch.Tensor:
    """Scale `grads` in place by min(1, clip / max(|g|, 1e-12)) when
    clip > 0; returns the global norm before the clip."""
    gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    if clip > 0:
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)
    return gnorm


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def make_optimizer(params: List[torch.Tensor], tcfg: TrainHyper) -> torch.optim.Adam:
    """Adam (beta 0.9 / 0.999, eps 1e-8); the step sets the learning rate
    from make_lr_schedule at the update count before it increments, as
    optax does (so with a warmup the first update runs at lr 0)."""
    return torch.optim.Adam(params, lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(params: Params, tcfg: TrainHyper) -> Dict[str, Any]:
    """{'params', 'opt', 'step'}; every parameter tensor becomes a leaf
    that requires grad."""
    leaves = _tensors(params)
    for p in leaves:
        p.requires_grad_(True)
    return {"params": params, "opt": make_optimizer(leaves, tcfg), "step": 0}


def offline_losses(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   tcfg: TrainHyper) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked L1 + mask BCE + eikonal, and the logged statistics."""
    true_mask = (batch["true_mask"] > 0.5).float()
    color_loss = masked_l1_color(out["color_fine"], batch["true_rgb"], true_mask)
    m_loss = mask_bce(out["weight_sum"], true_mask)
    eik = out["gradient_error"]
    loss = color_loss + m_loss * tcfg.mask_weight + eik * tcfg.igr_weight
    mask_sum = torch.sum(true_mask) + 1e-5
    metrics = {
        "loss": loss,
        "color_loss": color_loss,
        "mask_loss": m_loss,
        "eikonal_loss": eik,
        "psnr": masked_psnr(out["color_fine"], batch["true_rgb"], true_mask),
        "s_val": torch.mean(out["s_val"]),
        # masked means of the first-sample CDF and the max compositing weight
        "cdf": torch.sum(out["cdf_fine"][:, :1] * true_mask) / mask_sum,
        "weight_max": torch.sum(out["weight_max"] * true_mask) / mask_sum,
    }
    return loss, metrics


def refined_obj_pose(params: Params, tcfg: TrainHyper, Ro: torch.Tensor, To: torch.Tensor,
                     index: int):
    """The per-view object pose correction: Ro' = rot6d(refine[:6]) @ Ro,
    To' = To + 0.1 refine[6:9].  An index past the table reads its last
    row, as JAX's clamped gather does."""
    if not tcfg.refine_pose:
        return Ro, To
    table = params["se3_refine"]
    ref = table[min(int(index), table.shape[0] - 1)]
    return rot6d_to_matrix(ref[:6]) @ Ro, To + ref[6:9] * 0.1


def refined_hand_pose(params: Params, tcfg: TrainHyper, batch) -> torch.Tensor:
    """(21, 4, 4) inverse bone transforms of the batch's view: with
    refine_pose its se3_refine row gives the palm rot6d, a 0.1-scaled
    palm translation, 20 joint angles and 0.1-scaled 7 palm angles,
    pushed through the inverse HALO path."""
    joints = batch["joints"][None]
    if tcfg.refine_pose:
        ref = params["se3_refine"][batch["index"]][None]  # (1, 36)
        joints = refined_hand_joints(
            joints, batch["bone_length"][None],
            joint_refine_angle=ref[:, 9:29], palm_refine_angle=ref[:, 29:36] * 0.1,
            palm_rot6d=ref[:, :6], palm_trans=ref[:, 6:9] * 0.1)
    return bone_transforms_from_mano_joints(joints)[0]


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


def obj_render_from_batch(params: Params, sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                          rcfg: RenderConfig, tcfg: TrainHyper, batch: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Camera -> rays -> object frame (refined pose) -> NeuS render,
    differentiable in the params (se3_refine included when
    tcfg.refine_pose)."""
    cam = Camera(R=batch["cam_R"], T=batch["cam_T"], focal=batch["focal"],
                 principal=batch["principal"])
    rb = xy_to_ray_bundle(cam, batch["rays_xy"])
    Ro, To = refined_obj_pose(params, tcfg, batch["Ro"], batch["To"], batch["index"])
    o, d = rays_to_object_frame(rb.origins, rb.directions, Ro, To)
    field = make_obj_field(params, sdf_cfg, color_cfg)
    return _render_rays_chunked(field, rcfg, tcfg, generator, o, d)


def hand_render_from_batch(params: Params, sdf_cfg: SDFConfig, color_cfg: ColorConfig,
                           rcfg: RenderConfig, tcfg: TrainHyper, batch: Dict[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None,
                           fused_ladder: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Camera -> rays -> HALO bone transforms -> NeuS render, differentiable
    in the params (se3_refine included when tcfg.refine_pose).

    fused_ladder: None defers to tcfg.fused_ladder (itself None = on for a
    bf16 trunk), True/False forces the fused ladder on/off."""
    want = fused_ladder if fused_ladder is not None else tcfg.fused_ladder
    use_fused = want if want is not None else sdf_cfg.trunk_dtype == "bf16"
    fine = _fine_pass(tcfg, sdf_cfg, batch["rays_xy"].device, use_fused)
    packs = pack_hand_field(params, sdf_cfg, color_cfg, fused_ladder=use_fused, fine=fine,
                            grad=True)
    return _render_packed(params, packs, sdf_cfg, color_cfg, rcfg, tcfg, batch, generator)


def _render_packed(params, packs: HandPacks, sdf_cfg, color_cfg, rcfg, tcfg, batch, generator):
    """hand_render_from_batch with the kernels' weights of `params` given."""
    cam = Camera(R=batch["cam_R"], T=batch["cam_T"], focal=batch["focal"],
                 principal=batch["principal"])
    rb = xy_to_ray_bundle(cam, batch["rays_xy"])
    bt_inv = refined_hand_pose(params, tcfg, batch)
    field = make_hand_field(params, sdf_cfg, color_cfg, bt_inv, batch["t_pose_21"], packs)
    return _render_rays_chunked(field, rcfg, tcfg, generator, rb.origins, rb.directions)


def _make_train_step(render, sdf_cfg: SDFConfig, tcfg: TrainHyper):
    """The update shared by both models around render(params, batch,
    generator) -> the render's outputs."""
    clip = resolve_grad_clip(tcfg, sdf_cfg)
    schedule = make_lr_schedule(tcfg.learning_rate, tcfg.warm_up_end, tcfg.end_iter,
                                tcfg.learning_rate_alpha)

    def step(state, batch, generator=None):
        params, opt = state["params"], state["opt"]
        opt.zero_grad(set_to_none=True)
        out = render(params, batch, generator)
        loss, metrics = offline_losses(out, batch, tcfg)
        loss.backward()
        leaves = _tensors(params)
        for p in leaves:
            if p.grad is None:  # optax updates every leaf, with a zero gradient if need be
                p.grad = torch.zeros_like(p)
        gnorm = _clipped_grads([p.grad for p in leaves], clip)
        for group in opt.param_groups:
            group["lr"] = schedule(state["step"])
        opt.step()
        state["step"] += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, grad_norm=gnorm.detach())

    return step


def make_hand_train_step(sdf_cfg: SDFConfig, color_cfg: ColorConfig, rcfg: RenderConfig,
                         tcfg: TrainHyper):
    """step(state, batch, generator) -> (state, metrics): one Adam update
    of the hand model, in place.  The batch carries rays_xy, true_rgb,
    true_mask, the camera (cam_R, cam_T, focal, principal), joints,
    t_pose_21, bone_length and the view index; `generator` (on the
    tensors' device) draws the coarse-sample jitter when rcfg.perturb > 0.
    metrics holds the eight of offline_losses and grad_norm, the global
    norm before the clip, as 0-d tensors (reading them syncs the card)."""
    return _make_train_step(
        lambda p, b, g: hand_render_from_batch(p, sdf_cfg, color_cfg, rcfg, tcfg, b, g),
        sdf_cfg, tcfg)


def make_obj_train_step(sdf_cfg: SDFConfig, color_cfg: ColorConfig, rcfg: RenderConfig,
                        tcfg: TrainHyper):
    """make_hand_train_step for the object model: the batch carries the
    object pose (Ro, To) in place of the hand's joints."""
    return _make_train_step(
        lambda p, b, g: obj_render_from_batch(p, sdf_cfg, color_cfg, rcfg, tcfg, b, g),
        sdf_cfg, tcfg)


def make_obj_eval_render(sdf_cfg: SDFConfig, color_cfg: ColorConfig, rcfg: RenderConfig,
                         tcfg: TrainHyper):
    """Chunk render for inference, no gradient, perturb off; the pose
    refinement stays as configured (the JAX package's eval render applies
    the view index's se3_refine row too).  render_chunk(params, batch) ->
    (color_fine (R, 3), weight_sum (R, 1))."""
    rcfg_eval = rcfg._replace(perturb=0.0)

    def render_chunk(params, batch):
        with torch.no_grad():
            out = obj_render_from_batch(params, sdf_cfg, color_cfg, rcfg_eval, tcfg, batch)
        return out["color_fine"], out["weight_sum"]

    return render_chunk


def make_hand_eval_render(sdf_cfg: SDFConfig, color_cfg: ColorConfig, rcfg: RenderConfig,
                          tcfg: TrainHyper):
    """Chunk render for inference: pose from the batch joints with no
    refinement, no perturbation; the fused ladder is on unless
    `train.fused_ladder = false`, and the fine pass is the train step's
    (select_fine_pass).  render_chunk(params, batch) -> (color_fine (R,
    3), weight_sum (R, 1)).

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
            fine = _fine_pass(tcfg, sdf_cfg, tensors[0].device, eval_fused)
            last.update(tensors=tensors, versions=versions, packs=pack_hand_field(
                params, sdf_cfg, color_cfg, fused_ladder=eval_fused, fine=fine))
        return last["packs"]

    def render_chunk(params, batch):
        with torch.no_grad():
            out = _render_packed(params, packs_for(params), sdf_cfg, color_cfg, rcfg_eval,
                                 tcfg_eval, batch, None)
        return out["color_fine"], out["weight_sum"]

    return render_chunk
