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
from honerf_torch.ops import fused_sdf as FS

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
    got = FF.hand_fine_color_fwd(pts, rotT, off, cut, pack)
    torch.cuda.synchronize()
    assert FF.KERNEL.launches == before + 1
    want = FF.hand_fine_color_plain(pts, rotT, off, cut, pack)
    for g, w, shape in zip(got, want, [(n,), (n, 3), (n, 3)]):
        assert g.shape == shape
        _assert_close(g, w)


def _cotangents(n, dev, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev) for shape in ((n,), (n, 3), (n, 3))]


# K3 on unit cotangents: every output is a sum that cancels, so flips move
# it further than K2's per-point rule allows, the plain version's own on
# the CPU included.  Each output is held, in L2, within BWD_FACTOR times
# the distance between the plain version on the card and on the CPU (the
# same bf16 operands, f32 sums in another order) plus BWD_REL of its norm.
# check_k3_faults.py reads this rule on the sound kernel and on planted
# faults (PERF.md, the findings on K3).
BWD_FACTOR = 4.0
BWD_REL = 1e-3
BWD_CASES = {"small-1": (SMALL, 1), "small-chunked": (SMALL, FF.BWD_CHUNK + 77),
             "full": (FULL, 3001)}


def _grad_items(grads):
    """[(name, tensor)] of every output of K3."""
    items = [("dp", grads.dp), ("drotT", grads.drotT), ("doff", grads.doff)]
    for field in ("dws", "dbs", "dcws", "dcbs"):
        items += [(f"{field}[{l}]", x) for l, x in enumerate(getattr(grads, field))]
    return items


def bwd_rule_readings(sdf_kw, n, dev):
    """K3 at n points on unit cotangents, against its plain version on
    the card: (kernel outputs, [(name, |kernel - plain| / (BWD_FACTOR x
    |plain - plain on the CPU| + BWD_REL x |plain|), in L2)]); the rule
    holds where every ratio is at most 1."""
    cfg, ccfg, params = _nets(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    pack = pack_fine_color(params, cfg, ccfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n, seed=2)
    cts = _cotangents(n, dev)
    got = FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts)
    want = FF.hand_fine_color_plain_bwd(pts, rotT, off, cut, pack, *cts)
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    cpu_pack = FF.FinePack(cpu(pack.ws), cpu(pack.bs), cpu(pack.cws), cpu(pack.cbs), None,
                           None, pack.meta)
    other = FF.hand_fine_color_plain_bwd(*cpu((pts, rotT, off, cut)), cpu_pack, *cpu(cts))
    ratios = []
    for (name, g), (_, w), (_, o) in zip(_grad_items(got), _grad_items(want),
                                         _grad_items(other)):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        limit = BWD_FACTOR * float((o.to(dev) - w).norm()) + BWD_REL * float(w.norm())
        ratios.append((name, float((g - w).norm()) / (limit + 1e-30)))
    return got, ratios


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_fine_color_bwd_matches_plain(dev, case):
    sdf_kw, n = BWD_CASES[case]
    before = FF.KERNEL_BWD.launches
    got, ratios = bwd_rule_readings(sdf_kw, n, dev)
    torch.cuda.synchronize()
    assert FF.KERNEL_BWD.launches == before + 1
    assert got.dp.shape == (n, 3)
    bad = [(name, r) for name, r in ratios if not r <= 1.0]
    assert not bad, bad
    # the same bits again: fixed-order sums, no atomics
    cfg, ccfg, params = _nets(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    again = FF.hand_fine_color_bwd(_points(joints, n, seed=2), rotT, off, cut,
                                   pack_fine_color(params, cfg, ccfg), *_cotangents(n, dev))
    assert torch.equal(again.dp, got.dp) and torch.equal(again.dws[0], got.dws[0])


@pytest.mark.parametrize("x_scale", [0.0, 0.70703125])
def test_dw_gemm_and_colsum_match_f64(dev, x_scale):
    """K3's split-over-points products, alone: dW = X^T Y (and += on a
    second call) and the column sums against f64 sums of the same bf16
    values, to f32 summation noise; two runs give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(7)
    M, K, N = 70001, 1408, 256
    X = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    Y = torch.randn((M, N), generator=gen, device=dev).bfloat16()
    Z = torch.randn((M, N), generator=gen, device=dev)
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    ws = torch.empty((FF._WS_FLOATS,), device=dev)
    Xr = (X.float() * x_scale).bfloat16() if x_scale else X
    want = Xr.double().T @ Y.double()
    outs = []
    for _ in range(2):
        out = torch.zeros((K, N), device=dev)
        FF._tn(blib, X, K, K, Y, N, M, out, 0, ws, stream, x_scale=x_scale)
        outs.append(out.clone())
        FF._tn(blib, X, K, K, Y, N, M, out, 1, ws, stream, x_scale=x_scale)
        assert float((out.double() - 2 * want).abs().max()) <= 2e-4 * float(want.abs().max())
    assert torch.equal(outs[0], outs[1])
    assert float((outs[0].double() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    col = torch.zeros((N,), device=dev)
    FF._colsum(blib, Z, N, M, col, 0, ws, stream)
    assert float((col.double() - Z.double().sum(0)).abs().max()) <= 1e-3


def test_fine_color_bwd_frozen_skips_weight_work(dev):
    """want_dw=False returns no weight gradients and the same pose and
    point gradients, bit for bit."""
    cfg, ccfg, params = _nets(SMALL, dev)
    joints, bt_inv, t_pose = _pose(dev)
    pack = pack_fine_color(params, cfg, ccfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, 5000, seed=4)
    cts = _cotangents(5000, dev)
    full = FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts)
    frozen = FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts, want_dw=False)
    assert frozen.dws is None and frozen.dcbs is None
    for name in ("dp", "drotT", "doff"):
        assert torch.equal(getattr(frozen, name), getattr(full, name))


def test_autograd_op_launches_both_kernels(dev):
    """hand_fine_color_apply with differentiable params: the forward
    launches K2 and the backward K3, once each, and the parameter and
    pose gradients are finite."""
    from honerf_torch.models.fields import hand_fine_color_apply

    cfg, ccfg, params = _nets(SMALL, dev)
    for net in params.values():
        for layer in net["layers"]:
            for leaf in layer.values():
                leaf.requires_grad_(True)
    joints, bt_inv, t_pose = _pose(dev)
    bt_inv = bt_inv.clone().requires_grad_(True)
    pts = _points(joints, 2000, seed=5)
    before = (FF.KERNEL.launches, FF.KERNEL_BWD.launches)
    sdf, g, color = hand_fine_color_apply(params, cfg, ccfg, pts, bt_inv, t_pose)
    (sdf.square().sum() + (g.norm(dim=-1) - 1).square().sum() + color.sum()).backward()
    torch.cuda.synchronize()
    assert (FF.KERNEL.launches, FF.KERNEL_BWD.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(bt_inv.grad).all() and bt_inv.grad.abs().max() > 0
    for net in params.values():
        for layer in net["layers"]:
            assert all(torch.isfinite(leaf.grad).all() for leaf in layer.values())


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
        FF.hand_fine_color_fwd(pts, rotT, off, cut, f32)


# K4: the object nets of confs/wmask_realobj_bean.conf and of the JAX
# suite's small kernel tests (tests/test_pallas_ops.py, test_runner_cli.py)
OBJ_NETS = {"full": {},
            "small": dict(n_layers=3, d_hidden=64, d_out=65, skip_in=(2,), v_multires=6),
            "small-128": dict(n_layers=4, d_hidden=128, d_out=129, skip_in=(2,), v_multires=6,
                              scale=0.5)}


def _obj_sdf(kw, dev):
    cfg = SDFConfig(kind="obj", **kw)
    gen = torch.Generator().manual_seed(0)
    return FS.FusedObjSDF(_perturb(init_sdf_params(gen, cfg, device=dev), gen), cfg)


def _grid_points(n, dev, seed=0):
    """Points of a mesh box around the origin (|x| <= 0.4)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32), device=dev)


@pytest.mark.parametrize("net", list(OBJ_NETS))
@pytest.mark.parametrize("n", [1, 1001, FS.CHUNK + 77])  # the last: two passes
def test_fused_obj_sdf_matches_plain(dev, net, n):
    fused = _obj_sdf(OBJ_NETS[net], dev)
    pts = _grid_points(n, dev)
    before = FS.KERNEL.launches
    got = fused(pts)
    torch.cuda.synchronize()
    assert FS.KERNEL.launches == before + 1
    want = FS.fused_obj_sdf_plain(pts, fused.ws, fused.bs, fused.meta)
    assert got.shape == (n,)
    _assert_close(got, want)


def test_fused_obj_sdf_rejects_what_the_kernel_does_not_take(dev):
    fused = _obj_sdf(OBJ_NETS["small"], dev)
    ws, bs, meta = fused.ws, fused.bs, fused.meta
    pts = _grid_points(64, dev)
    with pytest.raises(ValueError):  # not contiguous
        FS.fused_obj_sdf(pts.t().contiguous().t(), ws, bs, meta)
    with pytest.raises(ValueError):  # float64 points
        FS.fused_obj_sdf(pts.double(), ws, bs, meta)
    with pytest.raises(ValueError):  # operands on two devices
        FS.fused_obj_sdf(pts, (ws[0].cpu(),) + ws[1:], bs, meta)
    with pytest.raises(ValueError):  # f32 weights
        FS.fused_obj_sdf(pts, tuple(w.float() for w in ws), bs, meta)
    with pytest.raises(ValueError):  # a layer's rows do not match its input
        FS.fused_obj_sdf(pts, (ws[2],) + ws[1:], (bs[2],) + bs[1:], meta)
