"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (tests/conftest.py imports JAX, hence
--noconftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerance: both sides round the same operands to bf16 and sum in f32 in
another order, so now and then one activation rounds to the neighbouring
bf16 value and moves that point's outputs by up to a few 1e-3 of their
range.  So the median point agrees within 1e-4 of the output's range
(max |plain|) and every point within 1e-2 of it.
"""

import numpy as np
import pytest
import torch

from honerf_torch.data.synthetic import canonical_hand_joints
from honerf_torch.hand import bone_transforms_from_mano_joints
from honerf_torch.models.fields import (
    ColorConfig,
    SDFConfig,
    init_color_params,
    init_sdf_params,
    pack_fine_color,
)
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import fused_hand as FH

SMALL = dict(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), v_multires=3, r_multires=2)
FULL = dict(r_multires=7)  # the flagship: 8x256, 1386-channel embedding

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _perturb(tree, gen, scale=0.05):
    if isinstance(tree, dict):
        return {k: _perturb(v, gen, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, gen, scale) for v in tree]
    nz = tree[tree != 0]
    mag = float(nz.abs().mean()) if nz.numel() else 1.0
    return tree + scale * mag * torch.randn(tree.shape, generator=gen).to(tree.device)


def _nets(sdf_kw, dev):
    cfg = SDFConfig(kind="hand", trunk_dtype="bf16", **sdf_kw)
    ccfg = ColorConfig(kind="hand", d_feature=cfg.d_out - 1, d_hidden=cfg.d_hidden,
                       n_layers=4 if cfg.d_hidden == 256 else 2, v_multires=cfg.v_multires,
                       r_multires=cfg.r_multires, trunk_dtype="bf16")
    gen = torch.Generator().manual_seed(0)
    params = {"sdf": _perturb(init_sdf_params(gen, cfg, device=dev), gen),
              "color": _perturb(init_color_params(gen, ccfg, device=dev), gen)}
    return cfg, ccfg, params


def _pose(dev):
    joints = torch.as_tensor(canonical_hand_joints(0.3), device=dev)
    bt_inv = bone_transforms_from_mano_joints(joints[None])[0]
    t_pose = torch.as_tensor(canonical_hand_joints(0.0), device=dev)
    return joints, bt_inv, t_pose


def _points(joints, n, seed=0):
    rng = np.random.default_rng(seed)
    j = joints.cpu().numpy()
    p = j[rng.integers(0, 21, n)] + rng.normal(size=(n, 3)) * 0.05
    return torch.as_tensor(p.astype(np.float32), device=joints.device)


def _assert_close(got, want):
    err = (got - want).abs().flatten()
    scale = max(float(want.abs().max()), 1e-6)
    assert torch.isfinite(got).all()
    assert float(err.median()) <= 1e-4 * scale
    assert float(err.max()) <= 1e-2 * scale


@pytest.mark.parametrize("sdf_kw", [SMALL, FULL], ids=["small", "full"])
@pytest.mark.parametrize("n", [1, 1001, 20000, FH.CHUNK + 77])  # the last: two passes
def test_fused_hand_matches_plain(dev, sdf_kw, n):
    cfg, _, params = _nets(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    fused = FH.FusedHandSDF(params["sdf"], cfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n)
    before = FH.KERNEL.launches
    got = fused(pts, bt_inv, t_pose)
    torch.cuda.synchronize()
    assert FH.KERNEL.launches == before + 1
    want = FH.fused_hand_sdf_plain(pts, rotT, off, cut, fused.ws, fused.bs, fused.meta)
    assert got.shape == (n,)
    _assert_close(got, want)


@pytest.mark.parametrize("sdf_kw,n", [(SMALL, 1), (SMALL, FF.CHUNK + 77), (FULL, 3001)],
                         ids=["small-1", "small-chunked", "full"])
def test_fine_color_matches_plain(dev, sdf_kw, n):
    cfg, ccfg, params = _nets(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    pack = pack_fine_color(params, cfg, ccfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n, seed=1)
    before = FF.KERNEL.launches
    got = FF.hand_fine_color(pts, rotT, off, cut, pack)
    torch.cuda.synchronize()
    assert FF.KERNEL.launches == before + 1
    want = FF.hand_fine_color_plain(pts, rotT, off, cut, pack)
    for g, w, shape in zip(got, want, [(n,), (n, 3), (n, 3)]):
        assert g.shape == shape
        _assert_close(g, w)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    cfg, ccfg, params = _nets(SMALL, dev)
    joints, bt_inv, t_pose = _pose(dev)
    fused = FH.FusedHandSDF(params["sdf"], cfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, 64)
    with pytest.raises(ValueError):  # not contiguous
        FH.fused_hand_sdf(pts.t().contiguous().t(), rotT, off, cut, fused.ws, fused.bs,
                          fused.meta)
    with pytest.raises(ValueError):  # operands on two devices
        FH.fused_hand_sdf(pts, rotT.cpu(), off, cut, fused.ws, fused.bs, fused.meta)
    with pytest.raises(ValueError):  # the card's fine pass is bf16 only
        f32 = pack_fine_color(params, cfg._replace(trunk_dtype="f32"),
                              ccfg._replace(trunk_dtype="f32"))
        FF.hand_fine_color(pts, rotT, off, cut, f32)
