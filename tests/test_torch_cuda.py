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

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from honerf_torch.data.synthetic import canonical_hand_joints
from honerf_torch.hand import bone_transforms_from_mano_joints
from honerf_torch.models.embedding import hand_embedding_flat
from honerf_torch.models.fields import (
    ColorConfig,
    SDFConfig,
    init_color_params,
    init_sdf_params,
    pack_fine_color,
    pack_fine_nocolor,
    pack_trunk_sdf,
)
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import fused_sdf as FS
from honerf_torch.ops import perpoint_layout as PL

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


def _assert_close(got, want, median=True):
    err = (got - want).abs().flatten()
    scale = max(float(want.abs().max()), 1e-6)
    assert torch.isfinite(got).all()
    assert not median or float(err.median()) <= 1e-4 * scale
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
        items += [(f"{field}[{l}]", x) for l, x in enumerate(getattr(grads, field) or ())]
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
    f32_cfg = cfg._replace(trunk_dtype="f32")
    cpu_made = _cpu_pack(pack_fine_nocolor(params["sdf"], f32_cfg))
    cpu_made = cpu_made._replace(ws=tuple(w.to(dev) for w in cpu_made.ws),
                                 bs=tuple(b.to(dev) for b in cpu_made.bs))
    with pytest.raises(ValueError):  # a pack made off the card (no transposed weights)
        FF.hand_fine_color_fwd(pts, rotT, off, cut, cpu_made)
    # the bf16 GEMMs read their operands by TMA: a 16-byte-aligned base and
    # a row stride of a multiple of 16 bytes, or the wrapper raises (and the
    # C entry point refuses it: no other path)
    lib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    M, K, N = 256, 256, 256
    A = torch.randn((M, K + 8), device=dev).bfloat16()
    B = torch.randn((2 * K, N), device=dev).bfloat16()
    C = torch.empty((M, N), device=dev)
    ws = torch.empty((FF._WS_FLOATS,), device=dev)
    misaligned = A[:, 1:K + 1]                   # base 2 bytes past a 16-byte boundary
    narrow = torch.empty((M, K + 4), device=dev, dtype=torch.bfloat16)[:, :K]  # rows 520 bytes
    for A1, A2 in ((A, misaligned), (misaligned, None), (narrow, None), (A, narrow)):
        with pytest.raises(ValueError):
            FH.gemm(lib, A1, K, A2, K if A2 is not None else 0, B, N, None, M, FH.EPI_F32, C, N,
                    n_store=N, stream=stream)
    with pytest.raises(ValueError):
        FH.gemm(lib, A, K, None, 0, B[:, 1:], N - 8, None, M, FH.EPI_F32, C, N, n_store=N - 8,
                stream=stream)
    for X, Y in ((misaligned, B[:M]), (A, narrow)):
        with pytest.raises(ValueError):
            FF._tn(lib, X, X.stride(0), K, Y, N, M, C, 0, ws, stream)
    rc = lib.honerf_gemm(misaligned.data_ptr(), misaligned.stride(0), K, None, 0, 0, 0.0,
                         B.data_ptr(), N, N, None, M, FH.EPI_F32, C.data_ptr(), N, N,
                         None, 0, None, 0, 0, 1.0, 1.0, 0, None, 0, None, 0, None, 0, None, 0,
                         stream)
    assert rc == 1  # cudaErrorInvalidValue


# K5 / K6 (the trunk + u-chain on the embedding, train.fused_fine =
# 'pallas') and K2 / K3 without the color net ('full_nocolor'): the
# forwards under the elementwise rule above, the backwards under K3's
# unit-cotangent rule (BWD_FACTOR, BWD_REL).  The CPU plain version is the
# floor, so the full-width backward cases stay at 1,001 points.
TRUNK_FWD_CASES = {f"{net}-{n}": (kw, n) for net, kw in (("small", SMALL), ("full", FULL))
                   for n in (1, 1001, FT.CHUNK + 1)}
TRUNK_BWD_CASES = {"small-1": (SMALL, 1), "small-1001": (SMALL, 1001),
                   "small-chunked": (SMALL, FT.BWD_CHUNK + 1), "full": (FULL, 1001)}


def _embedding(cfg, n, dev, seed=6):
    joints, bt_inv, t_pose = _pose(dev)
    pts = _points(joints, n, seed=seed)
    return hand_embedding_flat(pts, bt_inv, t_pose, cfg.v_multires, cfg.r_multires)[0]


def _ratios(got, want, other, dev):
    """[(name, |kernel - plain| / (BWD_FACTOR |plain - plain on the CPU| +
    BWD_REL |plain|))], L2, over matching (name, tensor) lists."""
    out = []
    for (name, g), (_, w), (_, o) in zip(got, want, other):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        limit = BWD_FACTOR * float((o.to(dev) - w).norm()) + BWD_REL * float(w.norm())
        out.append((name, float((g - w).norm()) / (limit + 1e-30)))
    return out


def _cpu_pack(pack):
    cpu = lambda ts: tuple(x.cpu() for x in ts)  # noqa: E731
    return pack._replace(**{k: cpu(getattr(pack, k)) for k in ("ws", "bs")}, wts=None)


@pytest.mark.parametrize("case", list(TRUNK_FWD_CASES))
def test_trunk_sdf_u_matches_plain(dev, case):
    sdf_kw, n = TRUNK_FWD_CASES[case]
    cfg, _, params = _nets(sdf_kw, dev)
    pack = pack_trunk_sdf(params["sdf"], cfg)
    e = _embedding(cfg, n, dev)
    before = FT.KERNEL_FWD.launches
    got = FT.hand_trunk_sdf_u_fwd(e, pack)
    torch.cuda.synchronize()
    assert FT.KERNEL_FWD.launches == before + 1
    want = FT.hand_trunk_sdf_u_plain(e, pack)
    for g, w, shape in zip(got, want, [(n, cfg.d_out), (n, cfg.input_width)]):
        assert g.shape == shape
        _assert_close(g, w)


def _trunk_items(res):
    """[(name, tensor)] of every output of K6: (de, dws, dbs)."""
    de, dws, dbs = res
    return ([("de", de)] + [(f"dws[{l}]", x) for l, x in enumerate(dws)]
            + [(f"dbs[{l}]", x) for l, x in enumerate(dbs)])


def trunk_bwd_rule_readings(sdf_kw, n, dev):
    """K6 at n points on unit cotangents against its plain version on the
    card: (kernel outputs, [(name, ratio)]) as bwd_rule_readings."""
    cfg, _, params = _nets(sdf_kw, dev)
    pack = pack_trunk_sdf(params["sdf"], cfg)
    e = _embedding(cfg, n, dev, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    dout = torch.randn((n, cfg.d_out), generator=gen, device=dev)
    du = torch.randn((n, cfg.input_width), generator=gen, device=dev)
    got = FT.hand_trunk_sdf_u_bwd(e, pack, dout, du)
    want = FT.hand_trunk_sdf_u_plain_bwd(e, pack, dout, du)
    other = FT.hand_trunk_sdf_u_plain_bwd(e.cpu(), _cpu_pack(pack), dout.cpu(), du.cpu())
    return got, _ratios(*[_trunk_items(r) for r in (got, want, other)], dev)


@pytest.mark.parametrize("case", list(TRUNK_BWD_CASES))
def test_trunk_sdf_u_bwd_matches_plain(dev, case):
    sdf_kw, n = TRUNK_BWD_CASES[case]
    before = FT.KERNEL_BWD.launches
    got, ratios = trunk_bwd_rule_readings(sdf_kw, n, dev)
    torch.cuda.synchronize()
    assert FT.KERNEL_BWD.launches == before + 1
    assert got[0].shape == (n, SDFConfig(kind="hand", **sdf_kw).input_width)
    bad = [(name, r) for name, r in ratios if not r <= 1.0]
    assert not bad, bad


def test_trunk_sdf_u_bwd_frozen_and_autograd(dev):
    """Frozen weights: the same de bit for bit and no dW; the autograd op
    launches K5 then K6, once each, with finite gradients."""
    cfg, _, params = _nets(SMALL, dev)
    pack = pack_trunk_sdf(params["sdf"], cfg)
    e = _embedding(cfg, 5000, dev, seed=4)
    gen = torch.Generator(device=dev).manual_seed(5)
    dout = torch.randn((5000, cfg.d_out), generator=gen, device=dev)
    du = torch.randn((5000, cfg.input_width), generator=gen, device=dev)
    full = FT.hand_trunk_sdf_u_bwd(e, pack, dout, du)
    frozen = FT.hand_trunk_sdf_u_bwd(e, pack, dout, du, want_dw=False)
    assert frozen[1] is None and frozen[2] is None and torch.equal(frozen[0], full[0])
    again = FT.hand_trunk_sdf_u_bwd(e, pack, dout, du)
    assert torch.equal(again[0], full[0]) and torch.equal(again[1][0], full[1][0])
    from honerf_torch.models.fields import _fine_trunk_weights, _trunk_meta

    ws, bs = _fine_trunk_weights(params["sdf"], cfg)
    ws = [w.detach().requires_grad_(True) for w in ws]
    x = e.detach().requires_grad_(True)
    before = (FT.KERNEL_FWD.launches, FT.KERNEL_BWD.launches)
    out, u = FT.hand_trunk_sdf_u(x, ws, bs, _trunk_meta(cfg))
    (out[:, 0].square().sum() + u.square().sum()).backward()
    torch.cuda.synchronize()
    assert (FT.KERNEL_FWD.launches, FT.KERNEL_BWD.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(x.grad).all() and all(torch.isfinite(w.grad).all() for w in ws)


NOCOLOR_CASES = {"small-1": (SMALL, 1), "small-chunked": (SMALL, FF.CHUNK + 1),
                 "full": (FULL, 1001)}


@pytest.mark.parametrize("case", list(NOCOLOR_CASES))
def test_fine_nocolor_matches_plain(dev, case):
    sdf_kw, n = NOCOLOR_CASES[case]
    cfg, _, params = _nets(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    pack = pack_fine_nocolor(params["sdf"], cfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n, seed=1)
    before = FF.KERNEL.launches
    got = FF.hand_fine_color_fwd(pts, rotT, off, cut, pack)
    torch.cuda.synchronize()
    assert FF.KERNEL.launches == before + 1
    want = FF.hand_fine_color_plain(pts, rotT, off, cut, pack)
    for g, w, shape in zip(got, want, [(n, cfg.d_out), (n, 3), (n, cfg.input_width)]):
        assert g.shape == shape
        _assert_close(g, w)


def nocolor_bwd_rule_readings(sdf_kw, n, dev):
    """K3 without the color net at n points on unit cotangents on (out, g,
    e): (kernel outputs, the frozen call's, [(name, ratio)]) as
    bwd_rule_readings."""
    cfg, _, params = _nets(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    pack = pack_fine_nocolor(params["sdf"], cfg)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    cts = [torch.randn(s, generator=gen, device=dev)
           for s in ((n, cfg.d_out), (n, 3), (n, cfg.input_width))]
    got = FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts)
    frozen = FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts, want_dw=False)
    want = FF.hand_fine_color_plain_bwd(pts, rotT, off, cut, pack, *cts)
    cpu = lambda ts: tuple(x.cpu() for x in ts)  # noqa: E731
    other = FF.hand_fine_color_plain_bwd(*cpu((pts, rotT, off, cut)), _cpu_pack(pack),
                                        *cpu(cts))
    items = [_grad_items(g) for g in (got, want, other)]
    return got, frozen, _ratios(*items, dev)


@pytest.mark.parametrize("case", list(NOCOLOR_CASES))
def test_fine_nocolor_bwd_matches_plain(dev, case):
    sdf_kw, n = NOCOLOR_CASES[case]
    before = FF.KERNEL_BWD.launches
    got, frozen, ratios = nocolor_bwd_rule_readings(sdf_kw, n, dev)
    torch.cuda.synchronize()
    assert FF.KERNEL_BWD.launches == before + 2
    assert got.dp.shape == (n, 3) and got.dcws is None and frozen.dws is None
    bad = [(name, r) for name, r in ratios if not r <= 1.0]
    assert not bad, bad
    for name in ("dp", "drotT", "doff"):
        assert torch.equal(getattr(frozen, name), getattr(got, name))


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
# a tile is 128 points, each consumer warpgroup's half 64: one point, the
# halves' edges, a ragged size, and more tiles than the card has SMs
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1001, 65536 + 77])
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
    with pytest.raises(ValueError):  # a PE wider than the kernel's 64 columns
        FS.fused_obj_sdf(pts, ws, bs, meta._replace(multires=11))
    lib = FS._lib()
    n = len(ws)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])  # noqa: E731
    ints = lambda xs: (ctypes.c_int * n)(*xs)  # noqa: E731
    out = torch.empty((64,), device=dev)
    rows = [w.shape[0] for w in ws]
    for bad_rows in (rows[:1] + [rows[1] + 64] + rows[2:], ):  # rows that do not chain
        rc = lib.honerf_obj_sdf(pts.data_ptr(), 64, meta.multires, 0.7071, 1.0, n, ptrs(ws),
                                ints(bad_rows), ints([w.shape[1] for w in ws]),
                                ints(meta.out_widths), ints([int(l in meta.skips) for l in range(n)]),
                                ptrs(bs), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 1  # cudaErrorInvalidValue


def test_fused_obj_sdf_is_one_launch_of_one_kernel(dev):
    """A K4 call is one launch of obj_sdf_fused_kernel: no gemm_kernel, no
    embedding kernel (torch.profiler's kernel names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fused = _obj_sdf(OBJ_NETS["full"], dev)
    pts = _grid_points(70001, dev)
    fused(pts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda._sleep(10_000_000)
        torch.cuda.synchronize()
        fused(pts)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]
    assert [n.split("(")[0] for n in names if "honerf" in n] == ["honerf::obj_sdf_fused_kernel"], names
    assert not any("gemm" in n or "embed" in n for n in names), names


# copy_cols at the calls the main path makes: (src dtype, src columns,
# src's first column, dst columns, dst's first column, width)
COPY_CALLS = {
    "K2 e": (torch.bfloat16, 1408, 0, 1386, 0, 1386),       # fused_fine_full.py: no-color K2
    "K3 de": (torch.float32, 1386, 0, 1792, 0, 1386),       # no-color K3: de_ext -> dx
    "K3 dfeat": (torch.float32, 257, 1, 1792, 1408, 256),   # dout[:, 1:] -> dx[:, Ep:]
    "K3 dsdf": (torch.float32, 257, 0, 1, 0, 1),            # dout -> dsdf_c
    "K5 u": (torch.float32, 1408, 0, 1386, 0, 1386),        # fused_fine.py: K5's u, K6's de
}


@pytest.mark.parametrize("call", list(COPY_CALLS))
@pytest.mark.parametrize("m", [1, 7, 56448])
def test_copy_cols_matches_the_copy_bit_for_bit(dev, call, m):
    """copy_cols_kernel at each call shape of the main path into a
    NaN-filled destination: dst[:m, :w] equals copy_cols_plain (and
    torch's copy_) bit for bit, every other element untouched; one launch."""
    sdt, lds, c0, ldd, d0, width = COPY_CALLS[call]
    gen = torch.Generator(device=dev).manual_seed(m)
    base = torch.randn((m + 3, lds), generator=gen, device=dev).to(sdt)
    src = base[:, c0:]
    dbuf = torch.full((m + 3, ldd), float("nan"), device=dev)
    dst = dbuf[:, d0:]
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    before = FT.COPY.launches
    FT.copy_cols(lib, src, m, width, dst, stream)
    torch.cuda.synchronize()
    assert FT.COPY.launches == before + 1
    assert torch.equal(dst[:m, :width], FT.copy_cols_plain(src, m, width))
    lib_dst = torch.empty((m, width), device=dev)
    lib_dst.copy_(src[:m, :width])
    assert torch.equal(dst[:m, :width], lib_dst)
    untouched = torch.ones_like(dbuf, dtype=torch.bool)
    untouched[:m, d0:d0 + width] = False
    assert bool(torch.isnan(dbuf[untouched]).all())


@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_copy_cols_every_alignment(dev, sdt):
    """Every source and destination offset mod 16 bytes (rows of odd
    strides, so each row has its own alignment), widths 1, 9 and 300."""
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(4)
    es = torch.tensor([], dtype=sdt).element_size()
    for width in (1, 9, 300):
        for so in range(16 // es):
            for do in range(4):
                sbuf = torch.randn((40, 331), generator=gen, device=dev).to(sdt)
                dbuf = torch.full((40, 333), float("nan"), device=dev)
                src, dst = sbuf[:, so:], dbuf[:, do:]
                FT.copy_cols(lib, src, 37, width, dst, stream)
                assert torch.equal(dst[:37, :width], src[:37, :width].float()), (width, so, do)
                assert bool(torch.isnan(dbuf[37:]).all())
                assert bool(torch.isnan(dst[:37, width:]).all())


def test_copy_cols_rejects_what_the_kernel_does_not_take(dev):
    """An f64 source, an f32-less destination, operands on two devices,
    strided columns, more rows or columns than the operands hold: the
    wrapper raises; the C entry point refuses a stride below the width."""
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    src = torch.randn((8, 64), device=dev)
    dst = torch.empty((8, 64), device=dev)
    for args in ((src.double(), 8, 64, dst), (src, 8, 64, dst.to(torch.bfloat16)),
                 (src.cpu(), 8, 64, dst), (src[:, ::2], 8, 32, dst), (src, 9, 64, dst),
                 (src, 8, 65, dst)):
        with pytest.raises(ValueError):
            FT.copy_cols(lib, *args, stream)
    rc = lib.honerf_copy_cols(src.data_ptr(), 32, 8, 64, dst.data_ptr(), 64, stream)
    assert rc == 1  # cudaErrorInvalidValue


# trunk_pack_e_kernel (K5 / K6's operand: f32 e -> the type, zero-padded,
# csrc/fused_trunk.cu) and pose_sum_kernel (K3's pose sums in one launch,
# csrc/fused_fine_bwd.cu)
PACK_TYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("kind", list(PACK_TYPES))
@pytest.mark.parametrize("m", [1, 7, FT.CHUNK + 77])
def test_trunk_pack_e_matches_plain_bit_for_bit(dev, kind, m):
    """The pack at the flagship's widths (E 1386 -> Ep 1408) from e rows
    1386 or 1408 floats apart starting 0, 4, 8 or 12 bytes past a 16-byte
    boundary, into a NaN-filled eb of more rows: eb[:m] equals
    trunk_pack_e_plain bit for bit, the rows past m untouched; one launch
    a call."""
    dtype = PACK_TYPES[kind]
    gen = torch.Generator(device=dev).manual_seed(m)
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    for lde in (1386, 1408):
        for off in range(4):
            buf = torch.randn(((m + 2) * lde + off,), generator=gen, device=dev)
            e = buf[off:].view(m + 2, lde)[:, :1386]
            eb = torch.full((m + 3, 1408), float("nan"), device=dev, dtype=dtype)
            before = FT.PACK.launches
            FT.trunk_pack_e(lib, e, m, eb, stream)
            torch.cuda.synchronize()
            assert FT.PACK.launches == before + 1
            assert torch.equal(eb[:m], FT.trunk_pack_e_plain(e, m, 1408, dtype)), (lde, off)
            assert bool(torch.isnan(eb[m:].float()).all())
            del buf, eb


def test_trunk_pack_e_rejects_what_the_kernel_does_not_take(dev):
    """An eb off a 16-byte boundary, rows of eb not a multiple of 16 bytes
    apart, a width off 8 columns: the wrapper raises; the C entry point
    refuses those and an lde below E (cudaErrorInvalidValue)."""
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    e = torch.randn((8, 1386), device=dev)
    ebuf = torch.zeros((8, 1424), device=dev, dtype=torch.bfloat16)
    for eb in (ebuf[:, 1:1409], torch.zeros((8, 1412), device=dev,
                                            dtype=torch.bfloat16)[:, :1408], ebuf[:, :1404]):
        with pytest.raises(ValueError):
            FT.trunk_pack_e(lib, e, 8, eb, stream)
    for eb_ptr, ldo, width, lde in ((ebuf[:, 1:].data_ptr(), 1424, 1408, 1386),
                                    (ebuf.data_ptr(), 1420, 1408, 1386),
                                    (ebuf.data_ptr(), 1424, 1404, 1386),
                                    (ebuf.data_ptr(), 1424, 1408, 1380)):
        assert lib.honerf_trunk_pack_e(e.data_ptr(), lde, 8, 1386, eb_ptr, ldo, width,
                                       stream) == 1   # cudaErrorInvalidValue


@pytest.mark.parametrize("m", [1, 7, 56448, FF.BWD_CHUNK + 77])
def test_pose_sum_matches_its_order_bit_for_bit(dev, m):
    """The pose sum on m seeded pose rows of a buffer of more: the same
    bits as pose_sum_ordered_plain (the card's SM count), with acc 0 and
    1, the same bits on a rerun, within 1e-3 of the f64 sum; one launch a
    call."""
    gen = torch.Generator(device=dev).manual_seed(m)
    P = torch.randn((m + 5, 256), generator=gen, device=dev)
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    ws = torch.empty((FT._WS_FLOATS,), device=dev)
    outs = []
    before = FF.POSE.launches
    for _ in range(2):
        out = torch.full((256,), float("nan"), device=dev)
        FF.pose_sum(blib, P, m, out, 0, ws, stream)
        torch.cuda.synchronize()
        outs.append(out)
    assert FF.POSE.launches == before + 2
    want = FF.pose_sum_ordered_plain(P, m)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert float((outs[0].double() - P[:m].double().sum(0)).abs().max()) <= 1e-3
    acc = torch.ones((256,), device=dev)
    FF.pose_sum(blib, P, m, acc, 1, ws, stream)
    assert torch.equal(acc, FF.pose_sum_ordered_plain(P, m, torch.ones((256,), device=dev), 1))


def test_pose_sum_rejects_what_the_kernel_does_not_take(dev):
    """P off a 16-byte boundary, not 256 dense columns, more rows than it
    has, scratch too small: the wrapper raises; the C entry point refuses a
    misaligned P and a split of 0."""
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    buf = torch.randn((64 * 256 + 4,), device=dev)
    ws, out = torch.empty((FT._WS_FLOATS,), device=dev), torch.empty((256,), device=dev)
    P = buf[:64 * 256].view(64, 256)
    for args in ((buf[1:64 * 256 + 1].view(64, 256), 64, ws), (P[:, :128], 64, ws),
                 (P, 65, ws), (P, 64, ws[:256 * 1 + 1][1:])):
        with pytest.raises(ValueError):
            FF.pose_sum(blib, args[0], args[1], out, 0, args[2], stream)
    assert blib.honerf_pose_sum(buf[1:].data_ptr(), 64, 32, ws.data_ptr(), out.data_ptr(), 0,
                                stream) == 1   # cudaErrorInvalidValue
    assert blib.honerf_pose_sum(P.data_ptr(), 64, 0, ws.data_ptr(), out.data_ptr(), 0,
                                stream) == 1


def test_pack_and_pose_sum_are_one_launch_each(dev):
    """A pack call and a pose-sum call captured into CUDA graphs: one node
    each, trunk_pack_e_kernel and pose_sum_kernel (chip_smoke's
    graph_kernel_nodes: CUDA's own count, not the wrappers')."""
    import chip_smoke as CS

    lib, blib = FT._lib(), FF._bwd_lib()
    e = torch.randn((56448, 1386), device=dev)
    eb = torch.empty((56448, 1408), device=dev, dtype=torch.bfloat16)
    P = torch.randn((56448, 256), device=dev)
    ws, out = torch.empty((FT._WS_FLOATS,), device=dev), torch.zeros((256,), device=dev)
    for fn, name in ((lambda s: FT.trunk_pack_e(lib, e, 56448, eb, s), "trunk_pack_e_kernel"),
                     (lambda s: FF.pose_sum(blib, P, 56448, out, 1, ws, s), "pose_sum_kernel")):
        fn(torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        nodes = CS.graph_kernel_nodes(
            torch, lambda: fn(torch.cuda.current_stream().cuda_stream))
        assert len(nodes) == 1 and name in nodes[0], nodes


# K2 in f32 and K3 in f32 with frozen nets (the fitting stage's fine
# pass): f32 operands and f32 sums on both sides, so only the order of
# the sums differs.  K2 within F32_TOL of each output's range, median and
# max; K3's dp, drotT and doff within F32_TOL of the plain version's norm
# in L2, on unit cotangents.
F32_TOL = 1e-4
F32_CASES = {"small-1": (SMALL, 1), "small-chunked": (SMALL, FF.CHUNK // 2 + 77),
             "full": (FULL, 3001)}


def _f32_pack(sdf_kw, dev):
    cfg, ccfg, params = _nets(sdf_kw, dev)
    return pack_fine_color(params, cfg._replace(trunk_dtype="f32"),
                           ccfg._replace(trunk_dtype="f32"))


@pytest.mark.parametrize("case", list(F32_CASES))
def test_fine_color_f32_matches_plain(dev, case):
    sdf_kw, n = F32_CASES[case]
    pack = _f32_pack(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n, seed=1)
    before = FF.KERNEL.launches
    got = FF.hand_fine_color_fwd(pts, rotT, off, cut, pack)
    torch.cuda.synchronize()
    assert FF.KERNEL.launches == before + 1
    want = FF.hand_fine_color_plain(pts, rotT, off, cut, pack)
    for g, w, shape in zip(got, want, [(n,), (n, 3), (n, 3)]):
        assert g.shape == shape and torch.isfinite(g).all()
        err = (g - w).abs().flatten()
        scale = max(float(w.abs().max()), 1e-6)
        assert float(err.median()) <= F32_TOL * scale and float(err.max()) <= F32_TOL * scale


@pytest.mark.parametrize("case", list(F32_CASES))
def test_fine_color_bwd_f32_frozen_matches_plain(dev, case):
    sdf_kw, n = F32_CASES[case]
    pack = _f32_pack(sdf_kw, dev)
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, n, seed=2)
    cts = _cotangents(n, dev)
    before = FF.KERNEL_BWD.launches
    got = FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts, want_dw=False)
    torch.cuda.synchronize()
    assert FF.KERNEL_BWD.launches == before + 1
    assert got.dws is None and got.dcws is None and got.dp.shape == (n, 3)
    want = FF.hand_fine_color_plain_bwd(pts, rotT, off, cut, pack, *cts, want_dw=False)
    for name in ("dp", "drotT", "doff"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.isfinite(g).all(), name
        assert float((g - w).norm()) <= F32_TOL * float(w.norm()), name


# The remaining f32 modes: K3 f32 with weight gradients, K2/K3 f32 without
# the color net, K5/K6 f32 (offline hand training and fitting with the
# confs' f32 trunks).  Every output within F32_TOL of the plain version:
# the forwards of the range, median and max; the backwards of the norm in
# L2, each dW/db included.  The chunked cases pass the 32,768-point f32
# chunk, so dW accumulates across passes.
F32_BWD_CASES = {"small-1": (SMALL, 1), "small-1001": (SMALL, 1001),
                 "small-chunked": (SMALL, FF.CHUNK // 2 + 77), "full": (FULL, 3001)}


def _f32_close(got, want, name=""):
    assert got.shape == want.shape and torch.isfinite(got).all(), name
    err = (got - want).abs().flatten()
    scale = max(float(want.abs().max()), 1e-6)
    assert float(err.median()) <= F32_TOL * scale, name
    assert float(err.max()) <= F32_TOL * scale, name


def _f32_ratios(got_items, want_items):
    """[(name, |kernel - plain| / (F32_TOL |plain|))], L2."""
    out = []
    for (name, g), (_, w) in zip(got_items, want_items):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        out.append((name, float((g - w).norm()) / (F32_TOL * float(w.norm()) + 1e-30)))
    return out


def _f32_setup(sdf_kw, n, dev, with_color):
    cfg, ccfg, params = _nets(sdf_kw, dev)
    cfg = cfg._replace(trunk_dtype="f32")
    pack = (pack_fine_color(params, cfg, ccfg._replace(trunk_dtype="f32")) if with_color
            else pack_fine_nocolor(params["sdf"], cfg))
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    return cfg, pack, (_points(joints, n, seed=2), rotT, off, cut)


# The color net's input holds sin / cos(2^l g), and |g| reaches hundreds
# on these random fields: the kernel's g and the plain version's (each
# within ~3e-5 of g's range) move that input, hence the color net's
# weight gradients, by up to ~1e-2.  So K3 with the color net is held
# against its plain version at the kernel's own g (g_color), with dcolor
# zero at the points whose color relu pre-activations lie within
# FF.RELU_MARGIN of the kink, where the mask may flip
# (FF.shared_g_cotangents).


def f32_bwd_rule_readings(kind, sdf_kw, n, dev):
    """The f32 backward on unit cotangents against its plain version, kind
    'color' (K3, at the kernel's g: FF.shared_g_cotangents), 'nocolor' (K3
    without the color net) or 'trunk' (K6): (the outputs with dW, the
    frozen call's, [(name, |kernel - plain| / (F32_TOL |plain|))] in L2
    over the outputs with dW); the rule holds where every ratio is at
    most 1."""
    if kind == "trunk":
        cfg, _, params = _nets(sdf_kw, dev)
        cfg = cfg._replace(trunk_dtype="f32")
        pack = pack_trunk_sdf(params["sdf"], cfg)
        e = _embedding(cfg, n, dev, seed=2)
        gen = torch.Generator(device=dev).manual_seed(3)
        dout = torch.randn((n, cfg.d_out), generator=gen, device=dev)
        du = torch.randn((n, cfg.input_width), generator=gen, device=dev)
        got = FT.hand_trunk_sdf_u_bwd(e, pack, dout, du)
        frozen = FT.hand_trunk_sdf_u_bwd(e, pack, dout, du, want_dw=False)
        want = FT.hand_trunk_sdf_u_plain_bwd(e, pack, dout, du)
        return got, frozen, _f32_ratios(_trunk_items(got), _trunk_items(want))
    cfg, pack, args = _f32_setup(sdf_kw, n, dev, kind == "color")
    if kind == "color":
        g, cts, dropped = FF.shared_g_cotangents(*args, pack, *_cotangents(n, dev))
        assert dropped <= max(1, n // 100)
        want = FF.hand_fine_color_plain_bwd(*args, pack, *cts, g_color=g)
    else:
        gen = torch.Generator(device=dev).manual_seed(3)
        cts = [torch.randn(s, generator=gen, device=dev)
               for s in ((n, cfg.d_out), (n, 3), (n, cfg.input_width))]
        want = FF.hand_fine_color_plain_bwd(*args, pack, *cts)
    got = FF.hand_fine_color_bwd(*args, pack, *cts)
    frozen = FF.hand_fine_color_bwd(*args, pack, *cts, want_dw=False)
    return got, frozen, _f32_ratios(_grad_items(got), _grad_items(want))


def _f32_bwd_rule(kind, sdf_kw, n, dev):
    """f32_bwd_rule_readings held: every ratio at most 1, the frozen call
    without weight gradients and with the same other outputs, bit for
    bit; two launches of the kernel."""
    counter = FT.KERNEL_BWD if kind == "trunk" else FF.KERNEL_BWD
    before = counter.launches
    got, frozen, ratios = f32_bwd_rule_readings(kind, sdf_kw, n, dev)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    bad = [(name, r) for name, r in ratios if not r <= 1.0]
    assert not bad, bad
    if kind == "trunk":
        assert frozen[1] is None and torch.equal(frozen[0], got[0])
        return
    assert frozen.dws is None and (got.dcws is not None) == (kind == "color")
    for name in ("dp", "drotT", "doff"):
        assert torch.equal(getattr(frozen, name), getattr(got, name)), name


@pytest.mark.parametrize("case", list(F32_BWD_CASES))
def test_fine_color_bwd_f32_dw_matches_plain(dev, case):
    """K3 f32 with dW against its plain version at the kernel's g."""
    _f32_bwd_rule("color", *F32_BWD_CASES[case], dev)


@pytest.mark.parametrize("case", list(F32_BWD_CASES))
def test_fine_nocolor_f32_matches_plain(dev, case):
    """K2 f32 without the color net (out, g, e), then K3 f32 without it,
    with and without dW, on unit cotangents."""
    sdf_kw, n = F32_BWD_CASES[case]
    cfg, pack, args = _f32_setup(sdf_kw, n, dev, False)
    before = FF.KERNEL.launches
    got = FF.hand_fine_color_fwd(*args, pack)
    assert FF.KERNEL.launches == before + 1
    want = FF.hand_fine_color_plain(*args, pack)
    for name, g, w, shape in zip(("out", "g", "e"), got, want,
                                 [(n, cfg.d_out), (n, 3), (n, cfg.input_width)]):
        assert g.shape == shape
        _f32_close(g, w, name)
    _f32_bwd_rule("nocolor", sdf_kw, n, dev)


@pytest.mark.parametrize("case", list(F32_BWD_CASES))
def test_trunk_sdf_u_f32_matches_plain(dev, case):
    """K5 f32 (out, u), then K6 f32 with and without dW, on unit
    cotangents."""
    sdf_kw, n = F32_BWD_CASES[case]
    cfg, _, params = _nets(sdf_kw, dev)
    pack = pack_trunk_sdf(params["sdf"], cfg._replace(trunk_dtype="f32"))
    assert pack.meta.dtype == "f32"
    e = _embedding(cfg, n, dev, seed=2)
    before = FT.KERNEL_FWD.launches
    got = FT.hand_trunk_sdf_u_fwd(e, pack)
    assert FT.KERNEL_FWD.launches == before + 1
    for name, g, w in zip(("out", "u"), got, FT.hand_trunk_sdf_u_plain(e, pack)):
        _f32_close(g, w, name)
    _f32_bwd_rule("trunk", sdf_kw, n, dev)


@pytest.mark.parametrize("x_scale", [0.0, 0.70710678])
def test_dw_gemm_f32_matches_f64(dev, x_scale):
    """The f32 mode's split-over-points dW = (x_scale X)^T Y, alone, at a
    ragged size: against f64 sums of the same f32 values, and += on a
    second call; two runs give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(7)
    M, K, N = 33001, 1408, 256
    X = torch.randn((M, K), generator=gen, device=dev)
    Y = torch.randn((M, N), generator=gen, device=dev)
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    ws = torch.empty((FF._WS_FLOATS,), device=dev)
    want = ((X.double() * x_scale) if x_scale else X.double()).T @ Y.double()
    outs = []
    for _ in range(2):
        out = torch.zeros((K, N), device=dev)
        FF._tn(blib, X, K, K, Y, N, M, out, 0, ws, stream, x_scale=x_scale)
        outs.append(out.clone())
        FF._tn(blib, X, K, K, Y, N, M, out, 1, ws, stream, x_scale=x_scale)
        assert float((out.double() - 2 * want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(outs[0], outs[1])
    assert float((outs[0].double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# gemm_f32_kernel alone, every epilogue, against the f64 product of the
# same f32 values with the epilogue in f64.  3xTF32 with a fresh
# accumulator per K step keeps the product within ~3e-7 of its norm (a
# single TF32 product: ~3e-4), so every output is held within GEMM_F32_TOL
# of its range at the max; S = sigmoid(beta z), whose slope reaches
# beta / 4, within that times beta / 4 (the card reads 1.7e-5 of S's
# range: z's error, 6.8e-7, times the slope).  Ragged M (33,001 rows: a partial last tile),
# the skip concat K1 + K2 = 256 + 1408 with its f32 1/sqrt2, N = 320 (a
# half-empty column tile) and 1408 (the u-chain into the embedding).
GEMM_F32_TOL = 1e-5
GEMM_M, GEMM_BETA = 33001, 100.0
# name -> (epilogue, K2 of the concat (0: none), N, split)
GEMM_F32_CASES = {
    "f32": (FH.EPI_F32, 1408, 320, 0),
    "sigmoid": (FH.EPI_SIGMOID, 0, 320, 0), "softplus": (FH.EPI_SOFTPLUS, 1408, 320, 0),
    "relu": (FH.EPI_RELU, 0, 1408, 0),
    "uchain": (FH.EPI_UCHAIN, 0, 320, 256), "uchain_e": (FH.EPI_UCHAIN, 0, 1408, 0),
    "dz": (FT.EPI_DZ, 0, 320, 256), "ut": (FT.EPI_UT, 0, 320, 0),
    "mask": (FF.EPI_MASK, 0, 320, 0),
}


def _gemm_f32_run(case, dev):
    """One launch of the case on seeded inputs: (inputs, outputs)."""
    mode, K2, N, split = GEMM_F32_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    M, K1 = GEMM_M, 256
    x = dict(A1=rnd(M, K1), A2=rnd(M, K2) if K2 else None, B=rnd(K1 + K2, N, scale=0.03),
             bias=rnd(N, scale=0.1), a_scale=0.70710678 if K2 else 0.0, hscale=0.7,
             escale=0.6, S=torch.sigmoid(rnd(M, N)), DS=rnd(M, N), CS=rnd(N),
             Act=rnd(M, N), U0=rnd(M, N - split))
    out = dict(C=torch.full((M, N), 7.0, device=dev), Cf=torch.empty((M, N), device=dev),
               DS=torch.empty((M, N), device=dev), S=torch.empty((M, N), device=dev),
               U=x["U0"].clone())
    kw = dict(n_store=N - 3, a_scale=x["a_scale"], hscale=x["hscale"], escale=x["escale"],
              split=split)
    if mode == FH.EPI_SOFTPLUS:
        kw["S"] = out["S"]
    elif mode == FH.EPI_UCHAIN:
        kw.update(S=x["S"], U=out["U"], u_acc=1, Cf=out["Cf"] if split else None)
    elif mode == FT.EPI_DZ:
        kw.update(S=x["S"], DS=x["DS"], U=out["U"], Cf=out["Cf"])
    elif mode == FT.EPI_UT:
        kw.update(S=x["S"], DS=out["DS"], CS=x["CS"], cs_ld=0)
    elif mode == FF.EPI_MASK:
        kw.update(Act=x["Act"], Cf=out["Cf"])
    FH.gemm(FF._bwd_lib(), x["A1"], K1, x["A2"], K2, x["B"], N, x["bias"], M, mode,
            out["C"], N, stream=torch.cuda.current_stream().cuda_stream, **kw)
    torch.cuda.synchronize()
    return x, out


def _gemm_f32_want(case, x):
    """{output: (f64 reference, the region the kernel writes)}."""
    mode, K2, N, split = GEMM_F32_CASES[case]
    return _epilogue_want(mode, K2, N, split, N - 3, x)


def _epilogue_want(mode, K2, N, split, n_store, x):
    """The f64 references of one epilogue on A = [A1 | A2] (K2 = 0: A1
    alone) scaled by x["a_scale"] in f32."""
    A = x["A1"].double() if not K2 else torch.cat([x["A1"], x["A2"]], 1).double()
    if x["a_scale"]:
        A = (A.float() * x["a_scale"]).double()   # the kernel scales in f32
    z = A @ x["B"].double() + x["bias"].double()
    h, e = x["hscale"], x["escale"]
    S = x["S"].double()
    if mode in (FH.EPI_F32, FH.EPI_SIGMOID):
        c = {FH.EPI_F32: z, FH.EPI_SIGMOID: torch.sigmoid(z)}[mode]
        return {"C": (c[:, :n_store], (slice(None), slice(0, n_store)))}
    if mode == FH.EPI_SOFTPLUS:
        sp = torch.nn.functional.softplus(GEMM_BETA * z) / GEMM_BETA
        return {"C": (sp, ...),
                "S": (torch.sigmoid(GEMM_BETA * z), ...)}
    if mode == FH.EPI_RELU:
        return {"C": (z.clamp_min(0.0), ...)}
    if mode in (FH.EPI_UCHAIN, FT.EPI_DZ):
        lo, hi = (slice(None), slice(0, split)), (slice(None), slice(0, N - split))
        zl = z[:, :split] * h
        if mode == FT.EPI_DZ:
            s = S[:, :split]
            zl = zl * s + x["DS"].double()[:, :split] * (GEMM_BETA * s * (1 - s))
            u = z[:, split:] * e
        else:
            u = x["U0"].double() + z[:, split:] * e
        want = {"U": (u, hi)}
        if split:
            want.update(Cf=(zl, lo), C=(zl * S[:, :split] if mode == FH.EPI_UCHAIN else zl, lo))
        return want
    if mode == FT.EPI_UT:
        return {"DS": (z * x["CS"].double(), ...), "C": (z * S * h, ...)}
    zm = torch.where(x["Act"] > 0, z, torch.zeros_like(z))
    return {"Cf": (zm, ...), "C": (zm, ...)}


@pytest.mark.parametrize("case", list(GEMM_F32_CASES))
def test_gemm_f32_matches_f64(dev, case):
    """gemm_f32_kernel alone with each epilogue: every output within
    GEMM_F32_TOL of its f64 reference's range; a second launch gives the
    same bits."""
    x, got = _gemm_f32_run(case, dev)
    _, again = _gemm_f32_run(case, dev)
    for name, (want, region) in _gemm_f32_want(case, x).items():
        g = got[name][region]
        assert g.shape == want.shape and torch.isfinite(g).all(), name
        err = float((g.double() - want).abs().max())
        slope = GEMM_BETA / 4 if name == "S" else 1.0
        assert err <= GEMM_F32_TOL * slope * float(want.abs().max()), (name, err)
        assert torch.equal(g, again[name][region]), name


# gemm_kernel alone (the bf16 GEMM: wgmma on a TMA ring), every epilogue,
# against the f64 sum of the same bf16 operands with the epilogue in f64.
# The tensor core's f32 sums sit ~1.4e-6 from f64 in L2 at K 1408
# (bench_gemm.py), so the f32 outputs are held within GEMM_BF16_TOL of
# their range at the max, S = sigmoid(beta z) within that times beta / 4
# (its slope), and the bf16 outputs within one bf16 ulp (2^-8 of the
# value) more.  Ragged M (33,001 rows), the skip concat 256 + 1408 with
# bf16(1/sqrt2), a concat whose K2 (1400) and K1 (200) end inside a K step
# with NaN in the columns past them (TMA's zero fill must cover the step,
# never those bytes), N = 264 stored up to 257, N = 320 (a part-empty
# column tile) and 1408.
GEMM_BF16_TOL = 2e-5
# name -> (epilogue, K1, K2 (0: no concat), N, split, a_scale)
GEMM_BF16_CASES = {
    "f32_ragged_k2": (FH.EPI_F32, 256, 1400, 264, 0, 0.0),
    "f32_ragged_k1": (FH.EPI_F32, 200, 1408, 256, 0, 0.70703125),
    "f32_k1408": (FH.EPI_F32, 1408, 0, 320, 0, 0.0),
    "sigmoid": (FH.EPI_SIGMOID, 256, 0, 320, 0, 0.0),
    "softplus": (FH.EPI_SOFTPLUS, 256, 1408, 256, 0, 0.70703125),
    "relu": (FH.EPI_RELU, 256, 0, 1408, 0, 0.0),
    "uchain": (FH.EPI_UCHAIN, 256, 0, 320, 256, 0.0),
    "uchain_e": (FH.EPI_UCHAIN, 256, 0, 1408, 0, 0.0),
    "dz": (FT.EPI_DZ, 256, 0, 320, 256, 0.0),
    "ut": (FT.EPI_UT, 256, 0, 320, 0, 0.0),
    "mask": (FF.EPI_MASK, 256, 0, 320, 0, 0.0),
}
_BF16_C = (FH.EPI_SOFTPLUS, FH.EPI_RELU, FH.EPI_UCHAIN, FT.EPI_DZ, FT.EPI_UT,
           FF.EPI_MASK)


def _gemm_bf16_run(case, dev):
    """One launch of the case on seeded inputs: (inputs, outputs)."""
    mode, K1, K2, N, split, a_scale = GEMM_BF16_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def ragged(K):  # rows padded to a multiple of 64 columns, NaN past K
        t = rnd(GEMM_M, -(-K // 64) * 64).bfloat16()
        t[:, K:] = float("nan")
        return t

    M = GEMM_M
    bf = torch.bfloat16
    x = dict(A1=ragged(K1), A2=ragged(K2) if K2 else None,
             B=rnd(K1 + K2, N, scale=0.03).bfloat16(), bias=rnd(N, scale=0.1), hscale=0.7,
             escale=0.6, S=torch.sigmoid(rnd(M, N)), DS=rnd(M, N), CS=rnd(N),
             Act=rnd(M, N).bfloat16(), U0=rnd(M, N - split))
    c_type = bf if mode in _BF16_C else torch.float32
    out = dict(C=torch.full((M, N), 7.0, device=dev, dtype=c_type),
               Cf=torch.empty((M, N), device=dev), DS=torch.empty((M, N), device=dev),
               S=torch.empty((M, N), device=dev), U=x["U0"].clone())
    kw = dict(n_store=N - 7, a_scale=a_scale, hscale=x["hscale"], escale=x["escale"],
              split=split)
    if mode == FH.EPI_SOFTPLUS:
        kw["S"] = out["S"]
    elif mode == FH.EPI_UCHAIN:
        kw.update(S=x["S"], U=out["U"], u_acc=1, Cf=out["Cf"] if split else None)
    elif mode == FT.EPI_DZ:
        kw.update(S=x["S"], DS=x["DS"], U=out["U"], Cf=out["Cf"])
    elif mode == FT.EPI_UT:
        kw.update(S=x["S"], DS=out["DS"], CS=x["CS"], cs_ld=0)
    elif mode == FF.EPI_MASK:
        kw.update(Act=x["Act"], Cf=out["Cf"])
    FH.gemm(FF._bwd_lib(), x["A1"], K1, x["A2"], K2, x["B"], N, x["bias"], M, mode,
            out["C"], N, stream=torch.cuda.current_stream().cuda_stream, **kw)
    torch.cuda.synchronize()
    return x, out


def _gemm_bf16_want(case, x):
    """{output: (f64 reference, the region the kernel writes)}: the f32
    case's references on A = [A1 | A2] rounded as the kernel rounds it."""
    mode, K1, K2, N, split, a_scale = GEMM_BF16_CASES[case]
    A = x["A1"][:, :K1] if not K2 else torch.cat([x["A1"][:, :K1], x["A2"][:, :K2]], 1)
    if a_scale:
        A = (A.float() * a_scale).bfloat16()   # the skip concat: bf16(x * bf16(1/sqrt2))
    y = dict(x, A1=A, A2=None, a_scale=0.0, Act=x["Act"].float())
    return _epilogue_want(mode, 0, N, split, N - 7, y)


@pytest.mark.parametrize("case", list(GEMM_BF16_CASES))
def test_gemm_bf16_matches_f64(dev, case):
    """gemm_kernel alone with each epilogue: every f32 output within
    GEMM_BF16_TOL of its f64 reference's range, every bf16 output within
    one bf16 ulp more; nothing past K1 or K2 read; a second launch gives
    the same bits."""
    x, got = _gemm_bf16_run(case, dev)
    _, again = _gemm_bf16_run(case, dev)
    for name, (want, region) in _gemm_bf16_want(case, x).items():
        g = got[name][region]
        assert g.shape == want.shape and torch.isfinite(g).all(), name
        err = (g.double() - want).abs()
        slope = GEMM_BETA / 4 if name == "S" else 1.0
        limit = GEMM_BF16_TOL * slope * float(want.abs().max())
        if g.dtype == torch.bfloat16:
            err = err - 2.0 ** -8 * want.abs()
        assert float(err.max()) <= limit, (name, float(err.max()), limit)
        assert torch.equal(g, again[name][region]), name


@pytest.mark.parametrize("x_scale", [0.0, 0.70703125])
def test_dw_gemm_bf16_tails_match_f64(dev, x_scale):
    """gemm_tn_kernel alone at N = 320 (a part-empty column tile) on
    33,001 points, whose split leaves a short last range, with X's rows
    wider than K (NaN past K, never read): against the f64 sum of the same
    bf16 values; two runs give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(9)
    M, K, N = GEMM_M, 256, 320
    X = torch.randn((M, K + 64), generator=gen, device=dev).bfloat16()
    X[:, K:] = float("nan")
    Y = torch.randn((M, N), generator=gen, device=dev).bfloat16()
    split = FT.WL.tn_split(K, N, M, FT._TN_BLOCKS_BF16)
    assert M % split and M % split % 64, "the last range should be short and ragged"
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    ws = torch.empty((FF._WS_FLOATS,), device=dev)
    Xr = X[:, :K]
    Xr = (Xr.float() * x_scale).bfloat16() if x_scale else Xr
    want = Xr.double().T @ Y.double()
    outs = []
    for _ in range(2):
        out = torch.zeros((K, N), device=dev)
        FF._tn(blib, X, X.stride(0), K, Y, N, M, out, 0, ws, stream, x_scale=x_scale)
        torch.cuda.synchronize()
        outs.append(out)
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
    assert float((outs[0].double() - want).abs().max()) <= 1e-4 * float(want.abs().max())


# The per-point kernels redesigned for the card: hand_embed_kernel (tiles
# of points staged in shared memory, stored by bulk copies) and
# colsum_partial_kernel (db in a fixed order, csrc/trunk.cuh).
EMBED_POINTS = {"bf16": (torch.bfloat16, PL.emb_points(2)),
                "f32": (torch.float32, PL.emb_points(4))}


@pytest.mark.parametrize("kind", list(EMBED_POINTS))
@pytest.mark.parametrize("which", ["1", "P-1", "70001"])
def test_embed_matches_plain(dev, kind, which):
    """The embedding alone, at the flagship's widths (vL 10, rL 7, lde
    1408), into a NaN-filled buffer of more rows than it writes: every row
    it writes within the kernel rule of embed_plain on the same card
    inputs (one rounding to the type; sin / cos in another library), the
    padding columns exactly 0 (an unwritten one stays NaN), the rows past
    m untouched; one launch."""
    dtype, P = EMBED_POINTS[kind]
    m = {"1": 1, "P-1": P - 1, "70001": 70001}[which]
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, m + 5, seed=8)
    e = torch.full((m + 5, 1408), float("nan"), device=dev, dtype=dtype)
    lib, stream = FH._lib("fused_hand"), torch.cuda.current_stream().cuda_stream
    before = FH.EMBED.launches
    FH.embed(lib, pts, m, rotT, off, cut, 10, 7, e, stream)
    torch.cuda.synchronize()
    assert FH.EMBED.launches == before + 1
    want = FH.embed_plain(pts[:m], rotT, off, cut, 10, 7, 1408, dtype)
    _assert_close(e[:m].float(), want.float())
    assert bool((e[:m, 1386:] == 0).all())
    assert bool(torch.isnan(e[m:].float()).all())


def test_embed_rejects_what_the_kernel_does_not_take(dev):
    """A base off a 16-byte boundary, rows not a multiple of 16 bytes apart
    or narrower than the embedding: the wrapper raises and the C entry
    point refuses (cudaErrorInvalidValue), with no other path."""
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    pts = _points(joints, 64)
    lib, stream = FH._lib("fused_hand"), torch.cuda.current_stream().cuda_stream
    buf = torch.zeros((64, 1416), device=dev, dtype=torch.bfloat16)
    for e in (buf[:, 1:1409], buf[:, :1404].contiguous(), buf[:, :1380].contiguous()):
        with pytest.raises(ValueError):
            FH.embed(lib, pts, 64, rotT, off, cut, 10, 7, e, stream)
    e = buf[:, 1:1409]
    rc = lib.honerf_hand_embed(pts.data_ptr(), 64, rotT.data_ptr(), off.data_ptr(),
                               cut.data_ptr(), 10, 7, e.data_ptr(), e.stride(0), stream)
    assert rc == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("N", [64, 256, 320])
def test_colsum_matches_its_order_bit_for_bit(dev, N):
    """db's column sum alone on a ragged 56,449 rows of a 320-wide f32
    buffer: the same bits as colsum_ordered_plain (its order in elementwise
    f32 adds) on the card, within 1e-3 of the f64 sum (the f32 noise of a
    sum of ~5.6e4 normal values of size ~240: ~1e-4), the same bits on a
    rerun, and += with acc."""
    gen = torch.Generator(device=dev).manual_seed(N)
    M = 56449
    Z = torch.randn((M, 320), generator=gen, device=dev)
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    ws = torch.empty((FF._WS_FLOATS,), device=dev)
    outs = []
    before = FT.COLSUM.launches
    for _ in range(2):
        out = torch.full((N,), float("nan"), device=dev)
        FF._colsum(blib, Z, N, M, out, 0, ws, stream)
        torch.cuda.synchronize()
        outs.append(out)
    assert FT.COLSUM.launches == before + 2
    want = FT.colsum_ordered_plain(Z, N, M)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert float((outs[0].double() - Z[:, :N].double().sum(0)).abs().max()) <= 1e-3
    acc = torch.ones((N,), device=dev)
    FF._colsum(blib, Z, N, M, acc, 1, ws, stream)
    assert torch.equal(acc, FT.colsum_ordered_plain(Z, N, M, torch.ones((N,), device=dev), 1))


# uchain_seed_kernel (the u-chain's seed, 8 columns a thread, csrc/trunk.cuh)
# and fine_bwd_rev_kernel (K3's reverse-chain transpose in tiles of points
# staged in shared memory, csrc/fused_fine_bwd.cu).
SEED_TYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("kind", ["f32"])
@pytest.mark.parametrize("m", [1, 7, 70001])
def test_uchain_seed_matches_plain_bit_for_bit(dev, kind, m):
    """The seed alone (the f32 trunk's; the bf16 trunk seeds inside
    hand_uchain_kernel) at the flagship's widths (W_last 256 x 320, s 256
    columns) into a NaN-filled t of more rows than it writes: the same
    bits as uchain_seed_plain and as torch.mul(s, c, out=t) (one f32
    product), the rows past m untouched; one launch."""
    dtype = SEED_TYPES[kind]
    gen = torch.Generator(device=dev).manual_seed(m)
    w = (0.1 * torch.randn((256, 320), generator=gen, device=dev)).to(dtype)
    s = torch.rand((m + 5, 256), generator=gen, device=dev)
    t = torch.full((m + 5, 256), float("nan"), device=dev, dtype=dtype)
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    before = FT.UCHAIN.launches
    FT.uchain_seed(lib, w, s, m, t, stream)
    torch.cuda.synchronize()
    assert FT.UCHAIN.launches == before + 1
    assert torch.equal(t[:m], FT.uchain_seed_plain(w, s, m, dtype))
    lib_t = torch.empty((m, 256), device=dev, dtype=dtype)
    torch.mul(s[:m], w[:, 0].float(), out=lib_t)
    assert torch.equal(t[:m], lib_t)
    assert bool(torch.isnan(t[m:].float()).all())


def test_uchain_seed_rejects_what_the_kernel_does_not_take(dev):
    """s or t off a 16-byte boundary, a width or row stride not a multiple
    of 8, a bf16 t (the bf16 trunk's seed is hand_uchain_kernel's): the
    wrapper raises and the C entry point refuses (cudaErrorInvalidValue),
    with no other path."""
    w = torch.randn((256, 320), device=dev)
    buf = torch.rand((64, 272), device=dev)
    tbuf = torch.zeros((64, 272), device=dev)
    lib, stream = FT._lib(), torch.cuda.current_stream().cuda_stream
    for s, t in ((buf.view(-1)[1:64 * 256 + 1].view(64, 256), tbuf[:, :256]),
                 (buf[:, :256].contiguous(), tbuf[:, 1:257]),
                 (buf[:, :252].contiguous(), tbuf[:, :252])):
        with pytest.raises(ValueError):
            FT.uchain_seed(lib, w, s, 64, t, stream)
    with pytest.raises(ValueError):
        FT.uchain_seed(lib, w.to(torch.bfloat16), buf[:, :256].contiguous(), 64,
                       tbuf[:, :256].to(torch.bfloat16), stream)
    s = buf.view(-1)[1:64 * 256 + 1]
    rc = lib.honerf_uchain_seed_f32(w.data_ptr(), w.stride(0), s.data_ptr(), 256, 64,
                                    tbuf.data_ptr(), 272, stream)
    assert rc == 1  # cudaErrorInvalidValue


def _bwdrev_case(dev, m, dtype, seed=9):
    """The flagship meta, pose, and seeded inputs of m points (+5 rows),
    with NaN-filled outputs of m + 5 rows."""
    meta = FF.FineMeta(v_multires=10, r_multires=7, d_hidden=256, n_layers=9, skip=4,
                       d_out=257, dtype="f32" if dtype == torch.float32 else "bf16")
    tm = meta.trunk_meta
    joints, bt_inv, t_pose = _pose(dev)
    pose = FH.pack_hand_pose(bt_inv, t_pose)
    n = m + 5
    gen = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randn((n, 8), generator=gen, device=dev)
    ins = (_points(joints, n, seed=seed), pose, packed, torch.randn((n,), generator=gen, device=dev),
           torch.randn((n, 3), generator=gen, device=dev),
           torch.randn((n, meta.color_in), generator=gen, device=dev))
    nan = float("nan")
    outs = (torch.full((n, tm.Ep), nan, device=dev, dtype=dtype),
            torch.full((n, tm.Ep), nan, device=dev, dtype=dtype),
            torch.full((n, 4), nan, device=dev),
            torch.full((n, tm.Op), nan, device=dev),
            torch.full((n, tm.Op), nan, device=dev, dtype=dtype))
    return meta, ins, outs


@pytest.mark.parametrize("kind", list(SEED_TYPES))
@pytest.mark.parametrize("which", ["1", "P-1", "70001"])
def test_fine_bwd_rev_matches_plain(dev, kind, which):
    """The reverse-chain transpose alone at the flagship's widths into
    NaN-filled outputs of more rows than it writes: du_b, du_s, dgt, dzf
    and dzb against fine_bwd_rev_plain on the same card inputs, bf16
    under the kernel rule (median 1e-4, max 1e-2 of the range: one
    rounding to bf16 after sin / cos of another library), f32 within 1e-4
    of the range at the median and the max; du's padding exactly 0 (an
    unwritten column stays NaN), dz exactly the plain version's, the rows
    past m untouched; one launch."""
    dtype = SEED_TYPES[kind]
    m = {"1": 1, "P-1": PL.bwr_points(torch.empty((), dtype=dtype).element_size()) - 1,
         "70001": 70001}[which]
    meta, (pts, (rotT, off, cut), packed, dsdf, dg, dx), outs = _bwdrev_case(dev, max(m, 1), dtype)
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    before = FF.BWDREV.launches
    FF.fine_bwd_rev(blib, pts, m, rotT, off, cut, meta, packed, dsdf, dg, dx, *outs, stream)
    torch.cuda.synchronize()
    assert FF.BWDREV.launches == before + 1
    want = FF.fine_bwd_rev_plain(pts[:m], rotT, off, cut, meta, packed[:m], dsdf[:m], dg[:m],
                                 dx[:m], dtype)
    got = (outs[0], outs[1], outs[2][:, :3], outs[3], outs[4])
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip(got[:3], want[:3]):
        err = (g[:m].float() - w.float()).abs().flatten()
        scale = max(float(w.float().abs().max()), 1e-6)
        assert bool(torch.isfinite(g[:m].float()).all())
        assert float(err.median()) <= 1e-4 * scale and float(err.max()) <= tol * scale
    E = meta.emb_width
    assert bool((outs[0][:m, E:] == 0).all()) and bool((outs[1][:m, E:] == 0).all())
    assert torch.equal(got[3][:m], want[3]) and torch.equal(got[4][:m], want[4])
    for g in got:
        assert bool(torch.isnan(g[m:].float()).all())


def test_fine_bwd_rev_rejects_what_the_kernel_does_not_take(dev):
    """An output off a 16-byte boundary, or dz rows not a multiple of 8
    columns apart: the wrapper raises and the C entry point refuses
    (cudaErrorInvalidValue), with no other path."""
    meta, (pts, (rotT, off, cut), packed, dsdf, dg, dx), outs = _bwdrev_case(dev, 64,
                                                                            torch.bfloat16)
    blib, stream = FF._bwd_lib(), torch.cuda.current_stream().cuda_stream
    du_b, du_s, dgt, dzf, dzb = outs
    n = du_b.shape[0]
    off_du = torch.zeros((n * 1408 + 8,), device=dev, dtype=torch.bfloat16)[1:1 + n * 1408]
    wide_f, wide_b = (torch.zeros((n, 336), device=dev, dtype=d)
                      for d in (torch.float32, torch.bfloat16))
    narrow_f, narrow_b = (torch.zeros((n, 324), device=dev, dtype=d)
                          for d in (torch.float32, torch.bfloat16))
    for bad in ((off_du.view(n, 1408), du_s, dgt, dzf, dzb),
                (du_b, du_s, dgt, wide_f[:, 1:321], wide_b[:, :320]),
                (du_b, du_s, dgt, narrow_f[:, :320], narrow_b[:, :320])):
        with pytest.raises(ValueError):
            FF.fine_bwd_rev(blib, pts, 64, rotT, off, cut, meta, packed, dsdf, dg, dx, *bad,
                            stream)
    rc = blib.honerf_fine_bwd_rev(
        pts.data_ptr(), 64, rotT.data_ptr(), off.data_ptr(), cut.data_ptr(), 10, 7,
        packed.data_ptr(), dsdf.data_ptr(), dg.data_ptr(), dx.data_ptr(), dx.stride(0), 1408, 256,
        256, 4, du_b.data_ptr() + 8, du_s.data_ptr(), 1408, dgt.data_ptr(), dzf.data_ptr(),
        dzb.data_ptr(), 320, 320, stream)
    assert rc == 1  # cudaErrorInvalidValue


# hand_trunk_fwd_kernel and hand_uchain_kernel: the bf16 trunk in two
# launches (csrc/trunk_fused.cu), which K1, K2, K5 and the recompute of K3
# and K6 run.
FUSED_TRUNK_M = (1, 63, 64, 65, 1001, 65613)


def _fused_trunk(dev, d_out=257):
    """The flagship trunk (the nets of the card tests above, FULL) as its
    callers pack it: K2's pack (d_out 257) or K1's (the sdf column)."""
    cfg, ccfg, params = _nets(FULL, dev)
    if d_out == 1:
        fused = FH.FusedHandSDF(params["sdf"], cfg)
        return fused.meta.trunk, SimpleNamespace(ws=fused.ws, bs=fused.bs, wts=None)
    pack = pack_fine_color(params, cfg, ccfg)
    return pack.meta.trunk_meta, pack


def _fused_e(dev, tm, m):
    """The bf16 embedding (hand_embed_kernel) of m points near the joints."""
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    e = torch.empty((m, tm.Ep), device=dev, dtype=torch.bfloat16)
    FH.embed(FH._lib("fused_hand"), _points(joints, m), m, rotT, off, cut, 10, 7, e,
             torch.cuda.current_stream().cuda_stream)
    return e


@pytest.mark.parametrize("keep", [False, True], ids=["render", "keep"])
@pytest.mark.parametrize("m", FUSED_TRUNK_M)
def test_fused_trunk_matches_plain(dev, m, keep):
    """Each kernel against its plain version on the same inputs, into
    NaN-filled buffers (the rule above): the forward's z, sigmoid rows and
    kept activations against trunk_fwd_plain; the u-chain's u, t and c
    rows run on the plain forward's sigmoid rows against
    trunk_uchain_plain (t rounded to bf16 as stored).  The sigmoid rows
    s = sigmoid(100 z) at the median alone: their slope of up to 25 turns
    an input's bf16 flip into ~25x that; their max through u, the u-chain
    kernel on the kernel's rows against the plain chain on the plain rows.
    At one point the kept rows are held to the rule's max alone: the
    median of one point's row is that point's own error, which one bf16
    flip upstream in the chain moves as a whole.  One launch a kernel a
    call; a second run's bits."""
    tm, pack = _fused_trunk(dev)
    e, n, nan = _fused_e(dev, tm, m), tm.n_layers, float("nan")
    acts, ss, z = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm)
    u, ts, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    plain_ss = torch.stack(ss)

    def run():
        rows = lambda dt: [torch.full((m, tm.Hp), nan, device=dev, dtype=dt)  # noqa: E731
                           for _ in range(n - 1)]
        o = dict(ss=torch.full((n - 1, m, tm.Hp), nan, device=dev),
                 acts=rows(torch.bfloat16) if keep else None,
                 z=torch.full((m, 257), nan, device=dev),
                 u=torch.full((m, tm.Ep), nan, device=dev),
                 u_k=torch.full((m, tm.Ep), nan, device=dev),
                 ts=rows(torch.bfloat16) if keep else None,
                 cs=[None] + rows(torch.float32)[1:] if keep else None)
        before = (FT.TRUNK_FWD.launches, FT.TRUNK_UCHAIN.launches)
        FT.trunk_fwd(e, m, pack.ws, pack.bs, tm, ss=o["ss"], acts=o["acts"], z=o["z"])
        FT.trunk_uchain(m, pack.ws, pack.wts, tm, plain_ss, u=o["u"], ts=o["ts"], cs=o["cs"])
        FT.trunk_uchain(m, pack.ws, pack.wts, tm, o["ss"], u=o["u_k"])
        torch.cuda.synchronize()
        assert (FT.TRUNK_FWD.launches, FT.TRUNK_UCHAIN.launches) == (before[0] + 1,
                                                                     before[1] + 2)
        return o

    o, again = run(), run()
    _assert_close(o["z"], z[:, :257])
    _assert_close(o["u"], u)
    _assert_close(o["u_k"], u)
    for l in range(n - 1):
        err = (o["ss"][l] - ss[l]).abs().flatten()
        assert torch.isfinite(o["ss"][l]).all() and float(err.median()) <= 1e-4
        if keep:
            _assert_close(o["acts"][l].float(), acts[l], median=m > 1)
            _assert_close(o["ts"][l].float(), ts[l].to(torch.bfloat16).float(), median=m > 1)
            if l:
                _assert_close(o["cs"][l], cs[l], median=m > 1)
    for k, v in o.items():
        for x, y in zip(v if isinstance(v, list) else [v], again[k] if isinstance(v, list)
                        else [again[k]]):
            assert x is None or torch.equal(x, y), k


@pytest.mark.parametrize("m", FUSED_TRUNK_M + (262144,))
def test_fused_trunk_sdf_column_matches_plain(dev, m):
    """K1's mode: the sdf column only, no sigmoid rows; a second run's bits."""
    tm, pack = _fused_trunk(dev, d_out=1)
    e = _fused_e(dev, tm, m)
    got = [torch.full((m,), float("nan"), device=dev) for _ in range(2)]
    for sdf in got:
        FT.trunk_fwd(e, m, pack.ws, pack.bs, tm, sdf=sdf)
    _, _, z = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm)
    torch.cuda.synchronize()
    _assert_close(got[0], z[:, 0])
    assert torch.equal(got[0], got[1])


def test_fused_trunk_reciprocal_is_frcp_rn(dev):
    """The forward's sigmoid reciprocal (tf_rcp12) has __frcp_rn's bits at
    every f32 in [1, 2]."""
    assert FT.rcp12_mismatches(dev) == 0


def test_fused_trunk_rejects_what_the_kernels_do_not_take(dev):
    """An f32 trunk, z beside sdf, misaligned or narrow rows, keep without
    the sigmoid rows: ValueError before a launch."""
    tm, pack = _fused_trunk(dev)
    e, n = _fused_e(dev, tm, 70), tm.n_layers
    ss = torch.empty((n - 1, 70, tm.Hp), device=dev)
    bad_e = torch.empty((70, tm.Ep + 1), device=dev, dtype=torch.bfloat16)[:, :tm.Ep]
    acts = [torch.empty((70, tm.Hp), device=dev, dtype=torch.bfloat16) for _ in range(n - 1)]
    before = FT.TRUNK_FWD.launches, FT.TRUNK_UCHAIN.launches
    for kw in (dict(tm=tm._replace(dtype="f32"), ss=ss),
               dict(z=torch.empty((70, 257), device=dev), sdf=torch.empty(70, device=dev)),
               dict(e=bad_e, ss=ss), dict(ss=ss[:, :, :128]), dict(acts=acts)):
        args = dict(e=e, tm=tm) | kw
        with pytest.raises(ValueError):
            FT.trunk_fwd(args.pop("e"), 70, pack.ws, pack.bs, args.pop("tm"), **args)
    with pytest.raises(ValueError):
        FT.trunk_uchain(70, pack.ws, pack.wts, tm, ss, ts=acts)
    assert (FT.TRUNK_FWD.launches, FT.TRUNK_UCHAIN.launches) == before


# The f32 trunk's pair (hand_trunk_fwd_f32_kernel, hand_uchain_f32_kernel,
# 3xTF32 on wgmma): f32 values on both sides, only the order of the sums
# differs, so every output within F32_TOL of its range at the median and
# the max; against f64 in L2 no worse than the split launches (one
# gemm_f32_kernel a layer and uchain_seed_kernel) by TRUNK32_VS_SPLIT.
TRUNK32_VS_SPLIT = 1.25


def _fused_trunk32(dev, sdf_kw=FULL):
    cfg, ccfg, params = _nets(sdf_kw, dev)
    pack = pack_fine_color(params, cfg._replace(trunk_dtype="f32"),
                           ccfg._replace(trunk_dtype="f32"))
    return pack.meta.trunk_meta, pack


def _fused_e32(dev, pack, m):
    """The f32 embedding (hand_embed_kernel) of m points near the joints."""
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    meta = pack.meta
    e = torch.empty((m, meta.trunk_meta.Ep), device=dev, dtype=torch.float32)
    FH.embed(FH._lib("fused_hand"), _points(joints, m), m, rotT, off, cut, meta.v_multires,
             meta.r_multires, e, torch.cuda.current_stream().cuda_stream)
    return e


def _trunk32_outputs(dev, tm, m, keep, with_z=True, with_u=True):
    nan, n = float("nan"), tm.n_layers
    rows = lambda: [torch.full((m, tm.Hp), nan, device=dev) for _ in range(n - 1)]  # noqa
    return dict(ss=torch.full((n - 1, m, tm.Hp), nan, device=dev),
                acts=rows() if keep else None,
                z=torch.full((m, tm.d_out), nan, device=dev) if with_z else None,
                u=torch.full((m, tm.Ep), nan, device=dev) if with_u else None,
                ts=rows() if keep else None, cs=[None] + rows()[1:] if keep else None)


def _trunk32_run(e, m, pack, tm, o):
    FT.trunk_fwd(e, m, pack.ws, pack.bs, tm, ss=o["ss"], acts=o["acts"], z=o["z"])
    FT.trunk_uchain(m, pack.ws, pack.wts, tm, o["ss"], u=o["u"], ts=o["ts"], cs=o["cs"])


def _f32_rule(got, want):
    err = (got - want).abs().flatten()
    scale = max(float(want.abs().max()), 1e-6)
    assert torch.isfinite(got).all()
    assert float(err.median()) <= F32_TOL * scale and float(err.max()) <= F32_TOL * scale


@pytest.mark.parametrize("keep", [False, True], ids=["render", "keep"])
@pytest.mark.parametrize("m", FUSED_TRUNK_M)
def test_fused_trunk_f32_matches_plain(dev, m, keep):
    """Every output of the pair (z, the sigmoid rows, u; with keep the
    activation, t and c rows) into NaN-filled buffers against
    trunk_fwd_plain / trunk_uchain_plain under the f32 rule; one launch of
    each kernel a call, none of the split launches; a second run's bits."""
    tm, pack = _fused_trunk32(dev)
    e, n = _fused_e32(dev, pack, m), tm.n_layers
    acts, ss, z = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm)
    u, ts, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)

    def run():
        o = _trunk32_outputs(dev, tm, m, keep)
        kerns = (FT.TRUNK_FWD_F32, FT.TRUNK_UCHAIN_F32, FH.GEMM_F32, FT.UCHAIN)
        before = [k.launches for k in kerns]
        _trunk32_run(e, m, pack, tm, o)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kerns, before)] == [1, 1, 0, 0]
        return o

    o, again = run(), run()
    _f32_rule(o["z"], z[:, :tm.d_out])
    _f32_rule(o["u"], u)
    for l in range(n - 1):
        _f32_rule(o["ss"][l], ss[l])
        if keep:
            _f32_rule(o["acts"][l], acts[l])
            _f32_rule(o["ts"][l], ts[l])
            if l:
                _f32_rule(o["cs"][l], cs[l])
    for k, v in o.items():
        for x, y in zip(v if isinstance(v, list) else [v], again[k] if isinstance(v, list)
                        else [again[k]]):
            assert x is None or torch.equal(x, y), k


@pytest.mark.parametrize("m", [1, 65, 4097])
def test_fused_trunk_f32_narrow_widths(dev, m):
    """SMALL's trunk (Hp 64, Op 128: 32 and 64 columns a consumer) and the
    recompute's outputs without z and u, under the f32 rule."""
    tm, pack = _fused_trunk32(dev, SMALL)
    e = _fused_e32(dev, pack, m)
    acts, ss, z = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm)
    u, ts, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    o = _trunk32_outputs(dev, tm, m, keep=False)
    _trunk32_run(e, m, pack, tm, o)
    k = _trunk32_outputs(dev, tm, m, keep=True, with_z=False, with_u=False)
    _trunk32_run(e, m, pack, tm, k)
    torch.cuda.synchronize()
    _f32_rule(o["z"], z[:, :tm.d_out])
    _f32_rule(o["u"], u)
    for l in range(tm.n_layers - 1):
        _f32_rule(k["ss"][l], ss[l])
        _f32_rule(k["acts"][l], acts[l])
        _f32_rule(k["ts"][l], ts[l])


def test_fused_trunk_f32_no_worse_than_the_split_launches(dev):
    """At 56,448 points (an f32 step's fine points), z, u and the last
    sigmoid row of the pair and of the split launches against the f64
    chain: the pair's relative L2 within TRUNK32_VS_SPLIT of the split's."""
    tm, pack = _fused_trunk32(dev)
    m = 56448
    e = _fused_e32(dev, pack, m)
    o = _trunk32_outputs(dev, tm, m, keep=False)
    _trunk32_run(e, m, pack, tm, o)
    sp = _trunk32_outputs(dev, tm, m, keep=False)
    FT.cuda_trunk_forward_split(FF._lib(), e, m, pack.ws, pack.bs, pack.wts, tm,
                                dict(ss=sp["ss"], acts=[], ts=[]),
                                torch.cuda.current_stream().cuda_stream, z=sp["z"], u=sp["u"])
    W = [w.double() for w in pack.ws]
    x0 = e.double()
    a, s64 = x0, []
    for l in range(tm.n_layers):
        x = torch.cat([a, x0], 1) / np.sqrt(2.0) if l == tm.skip else a
        y = x @ W[l] + pack.bs[l].double()
        if l < tm.n_layers - 1:
            s64.append(torch.sigmoid(100.0 * y))
            a = torch.logaddexp(100.0 * y, torch.zeros_like(y)) / 100.0
    z64 = y[:, :tm.d_out]
    t = W[-1][:tm.Hp, 0] * s64[-1]
    for l in range(tm.n_layers - 2, -1, -1):
        mm = t @ W[l].T
        if l == tm.skip:
            c, u64 = mm[:, :tm.Hp] / np.sqrt(2.0), mm[:, tm.Hp:] / np.sqrt(2.0)
        else:
            c = mm
        if l:
            t = c * s64[l - 1]
        else:
            u64 = u64 + c
    torch.cuda.synchronize()
    rel = lambda g, r: float((g.double() - r).norm() / r.norm())  # noqa: E731
    for got, split, ref in ((o["z"], sp["z"], z64), (o["u"], sp["u"], u64),
                            (o["ss"][-1], sp["ss"][-1], s64[-1])):
        assert rel(got, ref) <= TRUNK32_VS_SPLIT * rel(split, ref) + 1e-9


def test_fused_trunk_f32_rejects_what_the_kernels_do_not_take(dev):
    """A bf16 e for an f32 trunk, an sdf column, no sigmoid rows, a width
    the tiles do not split (Hp 192): ValueError before a launch."""
    tm, pack = _fused_trunk32(dev)
    e, n = _fused_e32(dev, pack, 70), tm.n_layers
    ss = torch.empty((n - 1, 70, tm.Hp), device=dev)
    before = FT.TRUNK_FWD_F32.launches, FT.TRUNK_UCHAIN_F32.launches
    for kw in (dict(e=e.to(torch.bfloat16), ss=ss), dict(ss=ss, sdf=torch.empty(70, device=dev)),
               dict(z=torch.empty((70, 257), device=dev)),
               dict(tm=tm._replace(d_hidden=192), ss=torch.empty((n - 1, 70, 192), device=dev))):
        args = dict(e=e, tm=tm) | kw
        with pytest.raises(ValueError):
            FT.trunk_fwd(args.pop("e"), 70, pack.ws, pack.bs, args.pop("tm"), **args)
    assert (FT.TRUNK_FWD_F32.launches, FT.TRUNK_UCHAIN_F32.launches) == before


# ---------------------------------------------------------------------------
# hand_trunk_ut_f32_kernel and hand_trunk_dz_f32_kernel: the f32 trunk's
# backward in two launches (csrc/trunk_bwd_f32.cu), under the f32 rule
# ---------------------------------------------------------------------------

def _bwd32_inputs(dev, tm, pack, m, seed=11):
    """The backward chains' inputs at m points: the forward's sigmoid rows
    and the u-chain's c rows (the plain versions on the card, at the f32
    embedding of m points), seeded cotangents du (du_b, du_s = du / sqrt2)
    and the top one (Op columns)."""
    e = _fused_e32(dev, pack, m)
    _, ss, _ = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm, last=False)
    _, ts, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    g = torch.Generator(device=dev).manual_seed(seed)
    du = torch.randn((m, tm.Ep), device=dev, generator=g)
    n = tm.n_layers
    return dict(e=e, du_b=du, du_s=du * FT.INV_SQRT2, ss=torch.stack(ss), ts=ts,
                cs=[None] + cs[1:n - 1], c_last=pack.ws[n - 1][:, 0].contiguous(),
                top=torch.randn((m, tm.Op), device=dev, generator=g))


def _bwd32_outputs(dev, tm, m, keep):
    nan, n, Hp = float("nan"), tm.n_layers, tm.Hp
    rows = lambda k: [torch.full((m, Hp), nan, device=dev) for _ in range(k)]  # noqa: E731
    return dict(ds=torch.full((n - 1, m, Hp), nan, device=dev),
                de=torch.full((m, tm.Ep), nan, device=dev),
                dms=[None] + rows(n - 1) if keep else None, dzs=rows(n - 1) if keep else None)


def _bwd32_plain(x, m, pack, tm):
    n = tm.n_layers
    ds, dms = FT.trunk_ut_plain(x["du_b"], x["du_s"], m, pack.ws, x["ss"],
                                x["cs"] + [x["c_last"]], tm, keep=True)
    de, dzs = FT.trunk_dz_plain(x["top"], m, pack.ws, x["ss"], torch.stack(ds), tm, keep=True)
    return dict(ds=ds, de=de, dms=dms, dzs=dzs[:n - 1])


def _bwd32_run(x, m, pack, tm, o, ds=None):
    """trunk_ut, then trunk_dz on ds (the plain version's, so each kernel is
    held alone) or on the upward kernel's rows."""
    FT.trunk_ut(m, pack.ws, tm, x["du_b"], x["du_s"], x["ss"], x["cs"], x["c_last"], o["ds"],
                o["dms"])
    FT.trunk_dz(m, pack.ws, tm, x["top"], x["ss"], o["ds"] if ds is None else ds, o["de"],
                o["dzs"])


@pytest.mark.parametrize("keep", [False, True], ids=["frozen", "dw"])
@pytest.mark.parametrize("m", FUSED_TRUNK_M)
def test_trunk_bwd_f32_matches_plain(dev, m, keep):
    """Every output of the two chains (ds, de; with dW every kept dm and dz
    row) into NaN-filled buffers against trunk_ut_plain / trunk_dz_plain
    under the f32 rule; one launch of each kernel a call, no f32 GEMM; a
    second run's bits."""
    tm, pack = _fused_trunk32(dev)
    x = _bwd32_inputs(dev, tm, pack, m)
    want = _bwd32_plain(x, m, pack, tm)
    ds_plain = torch.stack(want["ds"])

    def run():
        o = _bwd32_outputs(dev, tm, m, keep)
        kerns = (FT.TRUNK_UT_F32, FT.TRUNK_DZ_F32, FH.GEMM_F32)
        before = [k.launches for k in kerns]
        _bwd32_run(x, m, pack, tm, o, ds=ds_plain)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kerns, before)] == [1, 1, 0]
        return o

    o, again = run(), run()
    _f32_rule(o["de"], want["de"])
    for l in range(tm.n_layers - 1):
        _f32_rule(o["ds"][l], want["ds"][l])
        if keep:
            _f32_rule(o["dms"][l + 1], want["dms"][l + 1])
            _f32_rule(o["dzs"][l], want["dzs"][l])
    for k, v in o.items():
        for a, b in zip(v if isinstance(v, list) else [v], again[k] if isinstance(v, list)
                        else [again[k]]):
            assert a is None or torch.equal(a, b), k


@pytest.mark.parametrize("m", [1, 65, 4097])
def test_trunk_bwd_f32_narrow_widths(dev, m):
    """SMALL's trunk (Hp 64, Op 128: 32 columns a consumer, de in pieces of
    64), both chains chained as the main path runs them, under the f32
    rule."""
    tm, pack = _fused_trunk32(dev, SMALL)
    x = _bwd32_inputs(dev, tm, pack, m)
    want = _bwd32_plain(x, m, pack, tm)
    o = _bwd32_outputs(dev, tm, m, keep=True)
    _bwd32_run(x, m, pack, tm, o)
    torch.cuda.synchronize()
    _f32_rule(o["de"], want["de"])
    for l in range(tm.n_layers - 1):
        _f32_rule(o["ds"][l], want["ds"][l])
        _f32_rule(o["dms"][l + 1], want["dms"][l + 1])
        _f32_rule(o["dzs"][l], want["dzs"][l])


def test_trunk_bwd_f32_no_worse_than_the_split_launches(dev):
    """At 56,448 points (an f32 step's fine points), de, every dW and db of
    cuda_trunk_backward (the two chains, then the dW launch on their
    rows) and of cuda_trunk_backward_split against the f64 chains: the
    fused chains' relative L2 within TRUNK32_VS_SPLIT of the split's; the
    fused call launches no gemm_f32_kernel.  The kept activation and t rows
    are the planes of one tensor each, as trunk_buffers makes them (the dW
    launch reads each as one map)."""
    tm, pack = _fused_trunk32(dev)
    m, n, Hp, Ep = 56448, tm.n_layers, tm.Hp, tm.Ep
    x = _bwd32_inputs(dev, tm, pack, m)
    stream = torch.cuda.current_stream().cuda_stream
    lib = FF._lib()
    acts, _, _ = FT.trunk_fwd_plain(x["e"], m, pack.ws, pack.bs, tm, last=False)
    acts = list(torch.stack(acts[:n - 1]).unbind(0))
    buf = dict(ss=x["ss"], acts=acts, ts=list(torch.stack(x["ts"][:n - 1]).unbind(0)),
               cs=x["cs"])
    got = {}
    for name, fn in (("fused", FT.cuda_trunk_backward), ("split", FT.cuda_trunk_backward_split)):
        bw = FT.trunk_bwd_buffers(pack.ws, tm, m, dev, tm.Op)
        bw["du_b"].copy_(x["du_b"])
        bw["du_s"].copy_(x["du_s"])
        bw["dzf"][0].copy_(x["top"])
        bw["dzb"][0].copy_(x["top"])
        dws = [torch.zeros(w.shape, device=dev) for w in pack.ws]
        dbs = [torch.zeros(b.shape, device=dev) for b in pack.bs]
        before = FH.GEMM_F32.launches
        fn(lib, m, x["e"], pack.ws, pack.wts, tm, buf, bw, dws, dbs, True, 0,
           torch.empty((FT._WS_FLOATS,), device=dev), stream)
        torch.cuda.synchronize()
        assert (FH.GEMM_F32.launches - before == 0) == (name == "fused")
        got[name] = [bw["de"].clone()] + dws + dbs
    # the f64 chains on the same f32 values
    W = [w.double() for w in pack.ws]
    S = [s.double() for s in x["ss"]]
    C = [None] + [c.double() for c in x["cs"][1:]] + [x["c_last"].double()]
    du, inv = x["du_b"].double(), 1.0 / np.sqrt(2.0)
    dm, dms, ds = du, [du], []
    for l in range(n - 1):
        xx = torch.cat([dm, du * inv], 1) if l == tm.skip else dm
        dt = xx @ W[l]
        ds.append(dt * C[l + 1])
        dm = dt * S[l] * (inv if l + 1 == tm.skip else 1.0)
        dms.append(torch.cat([dm, du * inv], 1) if l + 1 == tm.skip else dm)
    dz, dzs, de = x["top"].double(), [None] * n, None
    dzs[n - 1] = dz
    for l in range(n - 1, 0, -1):
        din = dz @ W[l].T
        if l == tm.skip:
            da, de = din[:, :Hp] * inv, din[:, Hp:] * inv
        else:
            da = din
        dz = dzs[l - 1] = da * S[l - 1] + ds[l - 1] * (100.0 * S[l - 1] * (1.0 - S[l - 1]))
    de = de + dz @ W[0].T
    e64, onehot = x["e"].double(), torch.zeros((m, tm.Op), device=dev, dtype=torch.float64)
    onehot[:, 0] = 1.0
    T = [t.double() for t in x["ts"][:n - 1]] + [onehot]
    ins = [e64] + [torch.cat([a.double(), e64], 1) * inv if l == tm.skip else a.double()
                   for l, a in zip(range(1, n), acts)]
    ref = [de] + [dms[l].T @ T[l] + ins[l].T @ dzs[l] for l in range(n)] + [
        dzs[l].sum(0) for l in range(n)]
    rel = lambda g, r: float((g.double() - r).norm() / max(float(r.norm()), 1e-300))  # noqa
    for k, (f, s_, r) in enumerate(zip(got["fused"], got["split"], ref)):
        assert rel(f, r) <= TRUNK32_VS_SPLIT * rel(s_, r) + 1e-9, k


def test_trunk_bwd_f32_rejects_what_the_kernels_do_not_take(dev):
    """A bf16 trunk, a width the tiles do not split (Hp 192), a bf16 du:
    ValueError before a launch."""
    tm, pack = _fused_trunk32(dev)
    x = _bwd32_inputs(dev, tm, pack, 70)
    o = _bwd32_outputs(dev, tm, 70, keep=False)
    before = FT.TRUNK_UT_F32.launches, FT.TRUNK_DZ_F32.launches
    for kw in (dict(tm=tm._replace(dtype="bf16")), dict(tm=tm._replace(d_hidden=192)),
               dict(du_b=x["du_b"].to(torch.bfloat16))):
        a = dict(x, tm=tm) | kw
        with pytest.raises(ValueError):
            FT.trunk_ut(70, pack.ws, a["tm"], a["du_b"], a["du_s"], a["ss"], a["cs"],
                        a["c_last"], o["ds"])
    with pytest.raises(ValueError):
        FT.trunk_dz(70, pack.ws, tm._replace(dtype="bf16"), x["top"], x["ss"], o["ds"], o["de"])
    assert (FT.TRUNK_UT_F32.launches, FT.TRUNK_DZ_F32.launches) == before


# ---------------------------------------------------------------------------
# An f32 pass's weight gradients in one launch (trunk_dw_f32_kernel)
# ---------------------------------------------------------------------------

DW32_M = (1, 63, 64, 65, 3001)


def _dw32_case(dev, m, color, sdf_kw=FULL, C=None, seed=5):
    """Seeded rows of an f32 pass's dW launch at m points (fused_fine.dw_rows'
    keys; each list the planes of one tensor of C >= m rows, NaN past m), the
    flagship's (or sdf_kw's) padded f32 gradients and, with color, K3's color
    rows and gradients."""
    tm, pack = _fused_trunk32(dev, sdf_kw)
    meta = pack.meta
    C = C or m
    n, Hp, Ep, Op = tm.n_layers, tm.Hp, tm.Ep, tm.Op
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        x = torch.randn(shape, device=dev, generator=g)
        x[..., m:, :] = float("nan")
        return x

    du = r(C, Ep)
    rows = dict(du_b=du, du_s=du * FT.INV_SQRT2, e=r(C, Ep), dms=[None] + list(r(n - 1, C, Hp)),
                dzs=list(r(n - 1, C, Hp)), acts=list(r(n - 1, C, Hp)),
                ts=list(r(n - 1, C, Hp)), top=r(C, Op), onehot=torch.zeros((C, Op), device=dev))
    rows["onehot"][:, 0] = 1.0
    dws = [torch.zeros(w.shape, device=dev) for w in pack.ws]
    dbs = [torch.zeros(b.shape, device=dev) for b in pack.bs]
    crows = None
    if color:
        cw = pack.cws[0].shape[1]
        crows = FT.dw_color_rows(r(C, meta.Fp + meta.Gp), list(r(meta.c_layers - 1, C, cw)),
                                 list(r(meta.c_layers, C, cw)),
                                 [torch.zeros(w.shape, device=dev) for w in pack.cws],
                                 [torch.zeros(b.shape, device=dev) for b in pack.cbs])
    return tm, rows, dws, dbs, crows


def _dw32_outputs(dws, dbs, crows, fill):
    """Fresh gradients of the same shapes: NaN (fill None) or seeded values."""
    g = torch.Generator(device=dws[0].device).manual_seed(8)
    make = (lambda t: torch.full_like(t, float("nan"))) if fill is None else (  # noqa: E731
        lambda t: torch.randn(t.shape, device=t.device, generator=g))
    w, b = [make(t) for t in dws], [make(t) for t in dbs]
    c = None if crows is None else dict(crows, dcws=[make(t) for t in crows["dcws"]],
                                        dcbs=[make(t) for t in crows["dcbs"]])
    return w, b, c


def _dw32_all(w, b, c):
    return list(w) + list(b) + ([] if c is None else list(c["dcws"]) + list(c["dcbs"]))


@pytest.mark.parametrize("acc", [0, 1], ids=["first", "acc"])
@pytest.mark.parametrize("color", [False, True], ids=["trunk", "color"])
@pytest.mark.parametrize("m", DW32_M)
def test_trunk_dw_f32_matches_plain(dev, m, color, acc):
    """Every dW and db of the launch (the flagship trunk, with K3's color
    net or without; rows NaN past m) into NaN-filled gradients (acc 0) or
    onto seeded ones (acc 1), against trunk_dw_plain on the card under the
    f32 rule; one launch, no TN GEMM or column sum; a second run's bits."""
    tm, rows, dws, dbs, crows = _dw32_case(dev, m, color, C=m + 5)
    want = _dw32_outputs(dws, dbs, crows, None if not acc else 1)
    FT.trunk_dw_plain(m, tm, rows, want[0], want[1], acc, want[2])

    def run():
        w, b, c = _dw32_outputs(dws, dbs, crows, None if not acc else 1)
        kerns = (FT.TRUNK_DW_F32, FH.GEMM_TN_F32, FT.COLSUM)
        before = [k.launches for k in kerns]
        FT.trunk_dw(m, tm, rows, w, b, acc, torch.cuda.current_stream().cuda_stream, c)
        torch.cuda.synchronize()
        assert [k.launches - x for k, x in zip(kerns, before)] == [1, 0, 0]
        return _dw32_all(w, b, c)

    got, again = run(), run()
    for a, b in zip(got, _dw32_all(*want)):
        _f32_rule(a, b)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 65, 4097])
def test_trunk_dw_f32_narrow_widths(dev, m):
    """SMALL's trunk and color net (Hp 64: one consumer's rows a layer,
    64-column tiles) under the f32 rule."""
    tm, rows, dws, dbs, crows = _dw32_case(dev, m, True, sdf_kw=SMALL)
    want = _dw32_outputs(dws, dbs, crows, None)
    FT.trunk_dw_plain(m, tm, rows, want[0], want[1], 0, want[2])
    w, b, c = _dw32_outputs(dws, dbs, crows, None)
    FT.trunk_dw(m, tm, rows, w, b, 0, torch.cuda.current_stream().cuda_stream, c)
    torch.cuda.synchronize()
    for a, b_ in zip(_dw32_all(w, b, c), _dw32_all(*want)):
        _f32_rule(a, b_)


def _dw64(m, tm, rows, crows):
    """trunk_dw_plain's gradients in f64 on the same f32 rows."""
    n, Hp, skip, inv = tm.n_layers, tm.Hp, tm.skip, 1.0 / np.sqrt(2.0)
    d = lambda x: x[:m].double()  # noqa: E731
    du_b, du_s, e = d(rows["du_b"]), d(rows["du_s"]), d(rows["e"])
    dw, db = [], []
    for l in range(n):
        dz = d(rows["top"]) if l == n - 1 else d(rows["dzs"][l])
        x = e if l == 0 else (torch.cat([d(rows["acts"][l - 1]), e], 1) * inv if l == skip
                              else d(rows["acts"][l - 1]))
        w = x.T @ dz
        if l == n - 1:
            w[:, 0] += d(rows["dms"][l]).sum(0)
        else:
            dm = du_b if l == 0 else (torch.cat([d(rows["dms"][l]), du_s], 1) if l == skip
                                      else d(rows["dms"][l]))
            w = dm.T @ d(rows["ts"][l]) + w
        dw.append(w)
        db.append(dz.sum(0))
    cw, cb = [], []
    for l, dcw in enumerate(crows["dcws"]):
        a = torch.cat([e, d(crows["cx2"])], 1) if l == 0 else d(crows["cacts"][l - 1])
        dz = d(crows["cdz"][l])[:, :dcw.shape[1]]
        cw.append(a.T @ dz)
        cb.append(dz.sum(0))
    return dw + db + cw + cb


def test_trunk_dw_f32_no_worse_than_the_split_launches(dev):
    """At an f32 pass's 28,288 points with the color net: every dW and db
    of trunk_dw and of cuda_trunk_dw_split (the TN GEMMs, their reduces and
    the column sums) against the f64 sums of the same rows, the launch's
    relative L2 within TRUNK32_VS_SPLIT of the split sequence's."""
    m = 28288
    tm, rows, dws, dbs, crows = _dw32_case(dev, m, True)
    stream = torch.cuda.current_stream().cuda_stream
    got = {}
    w, b, c = _dw32_outputs(dws, dbs, crows, None)
    FT.trunk_dw(m, tm, rows, w, b, 0, stream, c)
    got["fused"] = _dw32_all(w, b, c)
    w, b, c = _dw32_outputs(dws, dbs, crows, None)
    before = FH.GEMM_TN_F32.launches
    FT.cuda_trunk_dw_split(FF._bwd_lib(), m, tm, rows, w, b, 0,
                           torch.empty((FT._WS_FLOATS,), device=dev), stream, c)
    torch.cuda.synchronize()
    assert FH.GEMM_TN_F32.launches - before == 26
    got["split"] = _dw32_all(w, b, c)
    ref = _dw64(m, tm, rows, crows)
    rel = lambda g, r: float((g.double() - r).norm() / max(float(r.norm()), 1e-300))  # noqa
    for k, (f, s_, r) in enumerate(zip(got["fused"], got["split"], ref)):
        assert rel(f, r) <= TRUNK32_VS_SPLIT * rel(s_, r) + 1e-9, k


def test_trunk_dw_f32_rejects_what_the_kernel_does_not_take(dev):
    """A bf16 trunk, bf16 gradients, rows that are not the planes of one
    tensor: ValueError before a launch."""
    tm, rows, dws, dbs, _ = _dw32_case(dev, 70, False)
    before = FT.TRUNK_DW_F32.launches
    with pytest.raises(ValueError):
        FT.trunk_dw(70, tm._replace(dtype="bf16"), rows, dws, dbs, 0)
    with pytest.raises(ValueError):
        FT.trunk_dw(70, tm, rows, [w.to(torch.bfloat16) for w in dws], dbs, 0)
    with pytest.raises(ValueError):
        FT.trunk_dw(70, tm, dict(rows, dzs=[x.clone() for x in rows["dzs"]]), dws, dbs, 0)
    assert FT.TRUNK_DW_F32.launches == before


# ---------------------------------------------------------------------------
# The f32 color net in two launches (color_fwd_f32_kernel, color_bwd_f32_kernel)
# ---------------------------------------------------------------------------

COLOR32_M = (1, 63, 64, 65, 1001, 28224)


def _color32_case(dev, m, sdf_kw=FULL, C=None, seed=6):
    """The f32 color net's inputs at m points (C >= m rows, NaN past m):
    seeded e and cx2 rows and dcolor, the plain forward's sigmoid in packed
    and its relu rows (the planes of one tensor), the f32 pack."""
    tm, pack = _fused_trunk32(dev, sdf_kw)
    meta = pack.meta
    C = C or m
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        x = torch.randn(shape, device=dev, generator=g)
        x[m:] = float("nan")
        return x

    e, cx2, dcolor = r(C, tm.Ep), r(C, meta.Fp + meta.Gp), r(C, 3)
    color, acts = FF.color_fwd_plain(e, cx2, m, pack.cws, pack.cbs, meta)
    packed = torch.full((C, 8), float("nan"), device=dev)
    packed[:m, 4:7] = color
    cacts = FT.planes(meta.c_layers - 1, C, pack.cws[0].shape[1], dev, torch.float32)
    for a, want in zip(cacts, acts):
        a.fill_(float("nan"))
        a[:m] = want
    return pack, e, cx2, dcolor, packed, cacts


def _color32_outputs(dev, pack, C, fwd: bool, with_dz: bool = True):
    """NaN-filled outputs: the forward's packed rows and relu planes, or the
    transpose's dx and (with_dz) dz planes."""
    meta, nan = pack.meta, float("nan")
    H = pack.cws[0].shape[1]
    if fwd:
        return (torch.full((C, 8), nan, device=dev),
                [a.fill_(nan) for a in FT.planes(meta.c_layers - 1, C, H, dev, torch.float32)])
    dz = FT.planes(meta.c_layers, C, H, dev, torch.float32) if with_dz else None
    return (torch.full((C, meta.color_in), nan, device=dev),
            None if dz is None else [z.fill_(nan) for z in dz])


@pytest.mark.parametrize("keep", [False, True], ids=["render", "keep"])
@pytest.mark.parametrize("m", COLOR32_M)
def test_color_fwd_f32_matches_plain(dev, m, keep):
    """The color (packed[:, 4:7]) and with keep the four relu rows into
    NaN-filled buffers against color_fwd_plain under the f32 rule, the
    rest of packed untouched; one launch, no GEMM; a second run's bits."""
    pack, e, cx2, _, want_p, want_a = _color32_case(dev, m, C=m + 3)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        packed, cacts = _color32_outputs(dev, pack, m + 3, True)
        kerns = (FF.COLOR_FWD_F32, FH.GEMM_F32)
        before = [k.launches for k in kerns]
        FF.color_fwd_f32(e, cx2, m, pack.cws, pack.cbs, pack.meta, packed,
                         cacts if keep else None, stream)
        torch.cuda.synchronize()
        assert [k.launches - x for k, x in zip(kerns, before)] == [1, 0]
        return packed, cacts

    (packed, cacts), (again, again_a) = run(), run()
    _f32_rule(packed[:m, 4:7], want_p[:m, 4:7])
    assert torch.isnan(packed[:, :4]).all() and torch.isnan(packed[:, 7]).all()
    assert torch.isnan(packed[m:]).all() and torch.equal(packed[:m, 4:7], again[:m, 4:7])
    for a, w, b in zip(cacts, want_a, again_a):
        if keep:
            _f32_rule(a[:m], w[:m])
            assert torch.equal(a[:m], b[:m]) and torch.isnan(a[m:]).all()
        else:
            assert torch.isnan(a).all()


@pytest.mark.parametrize("with_dz", [False, True], ids=["frozen", "dw"])
@pytest.mark.parametrize("m", COLOR32_M)
def test_color_bwd_f32_matches_plain(dev, m, with_dz):
    """dx and with dW every layer's dz row into NaN-filled buffers against
    color_bwd_plain (at the same sigmoid and relu rows) under the f32
    rule; one launch, no GEMM or color_dz_kernel; a second run's bits."""
    pack, _, _, dcolor, packed, cacts = _color32_case(dev, m, C=m + 3)
    want_dx, want_dz = FF.color_bwd_plain(m, pack.cws, pack.meta, packed, dcolor, cacts)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        dx, cdz = _color32_outputs(dev, pack, m + 3, False, with_dz)
        kerns = (FF.COLOR_BWD_F32, FH.GEMM_F32, FF.COLOR_DZ)
        before = [k.launches for k in kerns]
        FF.color_bwd_f32(m, pack.cws, pack.meta, packed, dcolor, cacts, dx, cdz, stream)
        torch.cuda.synchronize()
        assert [k.launches - x for k, x in zip(kerns, before)] == [1, 0, 0]
        return dx, cdz

    (dx, cdz), (again, again_z) = run(), run()
    _f32_rule(dx[:m], want_dx)
    assert torch.isnan(dx[m:]).all() and torch.equal(dx[:m], again[:m])
    for z, w, b in zip(cdz or (), want_dz, again_z or ()):
        _f32_rule(z[:m, :w.shape[1]], w)
        assert torch.equal(z[:m, :w.shape[1]], b[:m, :w.shape[1]]) and torch.isnan(z[m:]).all()


@pytest.mark.parametrize("m", [1, 65, 4097])
def test_color_f32_narrow_widths(dev, m):
    """SMALL's color net (64-wide hidden layers, three layers) under the
    f32 rule, both kernels."""
    pack, e, cx2, dcolor, want_p, cacts = _color32_case(dev, m, sdf_kw=SMALL)
    stream = torch.cuda.current_stream().cuda_stream
    packed, acts = _color32_outputs(dev, pack, m, True)
    FF.color_fwd_f32(e, cx2, m, pack.cws, pack.cbs, pack.meta, packed, acts, stream)
    dx, cdz = _color32_outputs(dev, pack, m, False)
    FF.color_bwd_f32(m, pack.cws, pack.meta, want_p, dcolor, cacts, dx, cdz, stream)
    torch.cuda.synchronize()
    _f32_rule(packed[:, 4:7], want_p[:, 4:7])
    for a, w in zip(acts, cacts):
        _f32_rule(a, w)
    want_dx, want_dz = FF.color_bwd_plain(m, pack.cws, pack.meta, want_p, dcolor, cacts)
    _f32_rule(dx, want_dx)
    for z, w in zip(cdz, want_dz):
        _f32_rule(z[:, :w.shape[1]], w)


def _color64(m, pack, e, cx2, packed, dcolor, cacts):
    """The color net's forward (color, relu rows) and its transpose (dx, dz
    rows, at packed's sigmoid and cacts' masks) in f64 on the same f32
    inputs."""
    meta = pack.meta
    n, d = meta.c_layers, lambda x: x[:m].double()  # noqa: E731
    a = torch.cat([d(e[:, :meta.trunk_meta.Ep]), d(cx2)], 1)
    acts = []
    for l, (w, b) in enumerate(zip(pack.cws, pack.cbs)):
        z = a @ w.double() + b.double()
        if l + 1 < n:
            a = torch.relu(z)
            acts.append(a)
    color = torch.sigmoid(z[:, :3])
    s = d(packed[:, 4:7])
    dz = torch.nn.functional.pad(s * (1.0 - s) * d(dcolor), (0, pack.cws[-1].shape[1] - 3))
    dzs = [None] * n
    for l in range(n - 1, -1, -1):
        dzs[l] = dz
        da = dz @ pack.cws[l].double().T
        if l:
            dz = torch.where(d(cacts[l - 1]) > 0, da, 0.0)
    return [color] + acts, [da] + dzs


def test_color_f32_no_worse_than_the_split_launches(dev):
    """At an f32 pass's 28,224 points: the color, the relu rows, dx and every
    dz row of the fused pair and of the split launches (_color_fwd_split,
    _color_bwd_split: one gemm_f32_kernel a layer, color_dz_kernel) against
    f64 on the same inputs, the pair's relative L2 within TRUNK32_VS_SPLIT
    of the split launches'."""
    m = 28224
    pack, e, cx2, dcolor, packed, cacts = _color32_case(dev, m)
    stream = torch.cuda.current_stream().cuda_stream
    got = {}
    p, a = _color32_outputs(dev, pack, m, True)
    FF.color_fwd_f32(e, cx2, m, pack.cws, pack.cbs, pack.meta, p, a, stream)
    dx, cdz = _color32_outputs(dev, pack, m, False)
    FF.color_bwd_f32(m, pack.cws, pack.meta, packed, dcolor, cacts, dx, cdz, stream)
    got["fused"] = ([p[:, 4:7]] + a, [dx] + cdz)
    p, a = _color32_outputs(dev, pack, m, True)
    before = FH.GEMM_F32.launches, FF.COLOR_DZ.launches
    FF._color_fwd_split(FF._lib(), e, cx2, m, pack, p, stream, a)
    dx, cdz = _color32_outputs(dev, pack, m, False)
    FF._color_bwd_split(FF._bwd_lib(), m, pack, dict(e=e, cx2=cx2, cacts=cacts), packed, dcolor,
                        dx, cdz, stream)
    torch.cuda.synchronize()
    n = pack.meta.c_layers
    assert (FH.GEMM_F32.launches - before[0], FF.COLOR_DZ.launches - before[1]) == (2 * n, 1)
    got["split"] = ([p[:, 4:7]] + a, [dx] + cdz)
    ref = _color64(m, pack, e, cx2, packed, dcolor, cacts)
    rel = lambda g, r: float((g[:, :r.shape[1]].double() - r).norm()  # noqa: E731
                             / max(float(r.norm()), 1e-300))
    for part in (0, 1):
        for k, (f, s_, r) in enumerate(zip(got["fused"][part], got["split"][part], ref[part])):
            assert rel(f, r) <= TRUNK32_VS_SPLIT * rel(s_, r) + 1e-9, (part, k)


def test_color_f32_rejects_what_the_kernels_do_not_take(dev):
    """A bf16 pack, a bf16 meta, dcolor of another shape, relu rows that are
    not f32: ValueError before a launch."""
    pack, e, cx2, dcolor, packed, cacts = _color32_case(dev, 70)
    meta, stream = pack.meta, torch.cuda.current_stream().cuda_stream
    dx, cdz = _color32_outputs(dev, pack, 70, False)
    before = FF.COLOR_FWD_F32.launches, FF.COLOR_BWD_F32.launches
    bf16 = [w.to(torch.bfloat16) for w in pack.cws]
    for kw in (dict(cws=bf16), dict(meta=meta._replace(dtype="bf16"))):
        a = dict(cws=pack.cws, meta=meta) | kw
        with pytest.raises(ValueError):
            FF.color_fwd_f32(e, cx2, 70, a["cws"], pack.cbs, a["meta"], packed, None, stream)
        with pytest.raises(ValueError):
            FF.color_bwd_f32(70, a["cws"], a["meta"], packed, dcolor, cacts, dx, cdz, stream)
    with pytest.raises(ValueError):
        FF.color_bwd_f32(70, pack.cws, meta, packed, dcolor[:, :2], cacts, dx, cdz, stream)
    with pytest.raises(ValueError):
        FF.color_bwd_f32(70, pack.cws, meta, packed, dcolor, [c.double() for c in cacts], dx,
                         cdz, stream)
    assert (FF.COLOR_FWD_F32.launches, FF.COLOR_BWD_F32.launches) == before


# ---------------------------------------------------------------------------
# The bf16 color net in two launches (color_fwd_kernel, color_bwd_kernel)
# ---------------------------------------------------------------------------

COLOR16_M = (1, 63, 64, 65, 127, 128, 129, 1001, 65613)
BF16 = torch.bfloat16


def _color16_case(dev, m, sdf_kw=FULL, C=None, seed=6):
    """The bf16 color net's inputs at m points (C >= m rows, NaN past m):
    seeded bf16 e and cx2 rows and f32 dcolor, the plain forward's sigmoid
    in packed and its bf16 relu rows (the planes of one tensor), the bf16
    pack (made on the card: cwts)."""
    cfg, ccfg, params = _nets(sdf_kw, dev)
    pack = pack_fine_color(params, cfg, ccfg)
    meta = pack.meta
    C = C or m
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, dtype=torch.float32):
        x = torch.randn(shape, device=dev, generator=g)
        x[m:] = float("nan")
        return x.to(dtype)

    e = r(C, meta.trunk_meta.Ep, dtype=BF16)
    cx2, dcolor = r(C, meta.Fp + meta.Gp, dtype=BF16), r(C, 3)
    color, acts = FF.color_fwd_plain(e, cx2, m, pack.cws, pack.cbs, meta)
    packed = torch.full((C, 8), float("nan"), device=dev)
    packed[:m, 4:7] = color
    cacts = FT.planes(meta.c_layers - 1, C, pack.cws[0].shape[1], dev, BF16)
    for a, want in zip(cacts, acts):
        a.fill_(float("nan"))
        a[:m] = want
    return pack, e, cx2, dcolor, packed, cacts


def _color16_outputs(dev, pack, C, fwd: bool, with_dz: bool = True):
    """NaN-filled outputs: the forward's packed rows and bf16 relu planes,
    or the transpose's dx and (with_dz) f32 and bf16 dz planes."""
    meta, nan = pack.meta, float("nan")
    H = pack.cws[0].shape[1]
    if fwd:
        return (torch.full((C, 8), nan, device=dev),
                [a.fill_(nan) for a in FT.planes(meta.c_layers - 1, C, H, dev, BF16)])
    dz = dzb = None
    if with_dz:
        dz = [z.fill_(nan) for z in FT.planes(meta.c_layers, C, H, dev, torch.float32)]
        dzb = [z.fill_(nan) for z in FT.planes(meta.c_layers, C, H, dev, BF16)]
    return torch.full((C, meta.color_in), nan, device=dev), dz, dzb


@pytest.mark.parametrize("keep", [False, True], ids=["render", "keep"])
@pytest.mark.parametrize("m", COLOR16_M)
def test_color_fwd_matches_plain(dev, m, keep):
    """The color (packed[:, 4:7]) and with keep the four bf16 relu rows into
    NaN-filled buffers against color_fwd_plain under the bf16 rule, the
    rest of packed untouched; one launch, no GEMM; a second run's bits."""
    pack, e, cx2, _, want_p, want_a = _color16_case(dev, m, C=m + 3)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        packed, cacts = _color16_outputs(dev, pack, m + 3, True)
        kerns = (FF.COLOR_FWD, FH.GEMM)
        before = [k.launches for k in kerns]
        FF.color_fwd(e, cx2, m, pack.cws, pack.cbs, pack.meta, packed, cacts if keep else None,
                     stream)
        torch.cuda.synchronize()
        assert [k.launches - x for k, x in zip(kerns, before)] == [1, 0]
        return packed, cacts

    (packed, cacts), (again, again_a) = run(), run()
    _assert_close(packed[:m, 4:7], want_p[:m, 4:7])
    assert torch.isnan(packed[:, :4]).all() and torch.isnan(packed[:, 7]).all()
    assert torch.isnan(packed[m:]).all() and torch.equal(packed[:m, 4:7], again[:m, 4:7])
    for a, w, b in zip(cacts, want_a, again_a):
        if keep:
            _assert_close(a[:m].float(), w[:m].float())
            assert torch.equal(a[:m], b[:m]) and torch.isnan(a[m:].float()).all()
        else:
            assert torch.isnan(a.float()).all()


@pytest.mark.parametrize("with_dz", [False, True], ids=["frozen", "dw"])
@pytest.mark.parametrize("m", COLOR16_M)
def test_color_bwd_matches_plain(dev, m, with_dz):
    """dx and with dW every layer's dz row (f32, and its bf16 rounding) into
    NaN-filled buffers against color_bwd_plain (at the same sigmoid and
    relu rows) under the bf16 rule; one launch, no GEMM or
    color_dz_kernel; a second run's bits."""
    pack, _, _, dcolor, packed, cacts = _color16_case(dev, m, C=m + 3)
    want_dx, want_dz = FF.color_bwd_plain(m, pack.cws, pack.meta, packed, dcolor, cacts)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        dx, cdz, cdzb = _color16_outputs(dev, pack, m + 3, False, with_dz)
        kerns = (FF.COLOR_BWD, FH.GEMM, FF.COLOR_DZ)
        before = [k.launches for k in kerns]
        FF.color_bwd(m, pack.cws, pack.cwts, pack.meta, packed, dcolor, cacts, dx, cdz, cdzb,
                     stream)
        torch.cuda.synchronize()
        assert [k.launches - x for k, x in zip(kerns, before)] == [1, 0, 0]
        return dx, cdz, cdzb

    (dx, cdz, cdzb), (again, again_z, _) = run(), run()
    _assert_close(dx[:m], want_dx)
    assert torch.isnan(dx[m:]).all() and torch.equal(dx[:m], again[:m])
    for z, zb, w, b in zip(cdz or (), cdzb or (), want_dz, again_z or ()):
        k = w.shape[1]
        _assert_close(z[:m, :k], w)
        assert torch.equal(zb[:m, :k], z[:m, :k].to(BF16))
        assert torch.equal(z[:m, :k], b[:m, :k]) and torch.isnan(z[m:]).all()


@pytest.mark.parametrize("m", [1, 65, 4097])
def test_color_bf16_narrow_widths(dev, m):
    """SMALL's color net (64-wide hidden layers) under the bf16 rule, both
    kernels, dx in pieces of 64 and 128 columns."""
    pack, e, cx2, dcolor, want_p, cacts = _color16_case(dev, m, sdf_kw=SMALL)
    stream = torch.cuda.current_stream().cuda_stream
    packed, acts = _color16_outputs(dev, pack, m, True)
    FF.color_fwd(e, cx2, m, pack.cws, pack.cbs, pack.meta, packed, acts, stream)
    dx, cdz, cdzb = _color16_outputs(dev, pack, m, False)
    FF.color_bwd(m, pack.cws, pack.cwts, pack.meta, want_p, dcolor, cacts, dx, cdz, cdzb, stream)
    torch.cuda.synchronize()
    _assert_close(packed[:, 4:7], want_p[:, 4:7])
    for a, w in zip(acts, cacts):
        _assert_close(a.float(), w.float())
    want_dx, want_dz = FF.color_bwd_plain(m, pack.cws, pack.meta, want_p, dcolor, cacts)
    _assert_close(dx, want_dx)
    for z, w in zip(cdz, want_dz):
        _assert_close(z[:, :w.shape[1]], w)


def _color16_both(dev, pack, m, e, cx2, dcolor, packed, cacts, fused: bool):
    """Every output of the forward (color, relu rows) and of the transpose
    (dx, f32 dz rows, bf16 dz rows) through the pair or the split launches
    (_color_fwd_split / _color_bwd_split: one gemm_kernel a layer,
    color_dz_kernel first)."""
    stream = torch.cuda.current_stream().cuda_stream
    p, a = _color16_outputs(dev, pack, m, True)
    dx, cdz, cdzb = _color16_outputs(dev, pack, m, False)
    if fused:
        FF.color_fwd(e, cx2, m, pack.cws, pack.cbs, pack.meta, p, a, stream)
        FF.color_bwd(m, pack.cws, pack.cwts, pack.meta, packed, dcolor, cacts, dx, cdz, cdzb,
                     stream)
    else:
        FF._color_fwd_split(FF._lib(), e, cx2, m, pack, p, stream, a)
        FF._color_bwd_split(FF._bwd_lib(), m, pack, dict(e=e, cx2=cx2, cacts=cacts), packed,
                            dcolor, dx, cdz, stream, cdzb)
    torch.cuda.synchronize()
    widths = [w.shape[1] for w in pack.cws]
    return ([p[:m, 4:7]] + [x[:m] for x in a] + [dx[:m]] + [z[:m, :k] for z, k in zip(cdz, widths)]
            + [z[:m, :k] for z, k in zip(cdzb, widths)])


@pytest.mark.parametrize("m", [1, 129, 56448, 65613])
def test_color_bf16_keeps_the_split_launches_bits(dev, m):
    """The pair sums each output in gemm_kernel's order (64-deep K steps of
    wgmma, layer 0's e range then cx2's, epilogue8's arithmetic): the
    color, the relu rows, dx and every dz row (f32 and bf16) equal the
    split launches' bit for bit (SHA-256 of the bytes)."""
    import hashlib

    pack, e, cx2, dcolor, packed, cacts = _color16_case(dev, m)
    fused = _color16_both(dev, pack, m, e, cx2, dcolor, packed, cacts, True)
    split = _color16_both(dev, pack, m, e, cx2, dcolor, packed, cacts, False)

    def digest(x):
        return hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    n = pack.meta.c_layers
    names = (["color"] + [f"relu[{l}]" for l in range(n - 1)] + ["dx"]
             + [f"dz[{l}]" for l in range(n)] + [f"dzb[{l}]" for l in range(n)])
    moved = [w for w, f, s in zip(names, fused, split) if digest(f) != digest(s)]
    assert not moved, f"bits moved: {moved}"


def test_color_bf16_rejects_what_the_kernels_do_not_take(dev):
    """An f32 pack, an f32 meta, dcolor of another shape, relu rows that are
    not bf16, no transposed weights, one dz type only: ValueError before a
    launch."""
    pack, e, cx2, dcolor, packed, cacts = _color16_case(dev, 70)
    meta, stream = pack.meta, torch.cuda.current_stream().cuda_stream
    dx, cdz, cdzb = _color16_outputs(dev, pack, 70, False)
    before = FF.COLOR_FWD.launches, FF.COLOR_BWD.launches
    f32 = [w.float() for w in pack.cws]
    for kw in (dict(cws=f32), dict(meta=meta._replace(dtype="f32"))):
        a = dict(cws=pack.cws, meta=meta) | kw
        with pytest.raises(ValueError):
            FF.color_fwd(e, cx2, 70, a["cws"], pack.cbs, a["meta"], packed, None, stream)
        with pytest.raises(ValueError):
            FF.color_bwd(70, a["cws"], pack.cwts, a["meta"], packed, dcolor, cacts, dx, cdz,
                         cdzb, stream)
    bad = ((dcolor[:, :2], cacts, pack.cwts, cdz, cdzb), (dcolor, [c.float() for c in cacts],
                                                          pack.cwts, cdz, cdzb),
           (dcolor, cacts, None, cdz, cdzb), (dcolor, cacts, pack.cwts, cdz, None))
    for dc, ca, wt, z, zb in bad:
        with pytest.raises(ValueError):
            FF.color_bwd(70, pack.cws, wt, meta, packed, dc, ca, dx, z, zb, stream)
    assert (FF.COLOR_FWD.launches, FF.COLOR_BWD.launches) == before


# hand_trunk_ut_kernel and hand_trunk_dz_kernel: the bf16 trunk's backward
# chains in two launches (csrc/trunk_bwd.cu), which K3 and K6 run on a
# bf16 trunk.
BWD16_M = (1, 63, 64, 65, 129, 1001, 65613)


def _bwd16_case(dev, m, sdf_kw=FULL, seed=12):
    """The bf16 pack of sdf_kw's nets, and the chains' inputs at m points
    near the joints: the forward's rows (the plain versions on the bf16
    embedding: kept activations and t rows as bf16 planes, f32 sigmoid and
    c rows), seeded cotangents du (du_b = bf16(du), du_s = bf16(du /
    sqrt2)) and the top one (Op columns, bf16); the c rows, like the kept
    ones, the planes of one tensor, as trunk_buffers keeps them."""
    cfg, ccfg, params = _nets(sdf_kw, dev)
    pack = pack_fine_color(params, cfg, ccfg)
    tm, n = pack.meta.trunk_meta, pack.meta.trunk_meta.n_layers
    joints, bt_inv, t_pose = _pose(dev)
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    e = torch.empty((m, tm.Ep), device=dev, dtype=torch.bfloat16)
    FH.embed(FH._lib("fused_hand"), _points(joints, m), m, rotT, off, cut, cfg.v_multires,
             cfg.r_multires, e, torch.cuda.current_stream().cuda_stream)
    acts, ss, _ = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm, last=False)
    _, ts, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    planes = lambda xs: list(torch.stack([x.to(torch.bfloat16) for x in xs]).unbind(0))  # noqa
    g = torch.Generator(device=dev).manual_seed(seed)
    du = torch.randn((m, tm.Ep), device=dev, generator=g)
    x = dict(e=e, ss=torch.stack(ss), acts=planes(acts), ts=planes(ts[:n - 1]),
             cs=[None] + list(torch.stack(cs[1:n - 1]).unbind(0)),
             c_last=pack.ws[n - 1][:, 0].float().contiguous(),
             du_b=du.to(torch.bfloat16), du_s=(du * FT.INV_SQRT2).to(torch.bfloat16),
             top=torch.randn((m, tm.Op), device=dev, generator=g).to(torch.bfloat16))
    return tm, pack, x


def _bwd16_outputs(dev, tm, m, keep):
    nan, n, Hp = float("nan"), tm.n_layers, tm.Hp
    rows = lambda k, dt: list(torch.full((k, m, Hp), nan, device=dev, dtype=dt)  # noqa: E731
                              .unbind(0))
    return dict(ds=torch.full((n - 1, m, Hp), nan, device=dev),
                de=torch.full((m, tm.Ep), nan, device=dev),
                dms=[None] + rows(n - 1, torch.bfloat16) if keep else None,
                dzs=rows(n - 1, torch.float32) if keep else None,
                dzbs=rows(n - 1, torch.bfloat16) if keep else None)


@pytest.mark.parametrize("keep", [False, True], ids=["frozen", "dw"])
@pytest.mark.parametrize("m", BWD16_M)
def test_trunk_bwd_bf16_matches_plain(dev, m, keep):
    """Each chain alone against its plain version on the same inputs, into
    NaN-filled buffers (the rule above; the median only past one point):
    the upward chain's ds and kept dm rows (bf16) against trunk_ut_plain
    (its dm rounded to bf16 as stored), the downward chain on the plain
    ds, its de and kept dz rows against trunk_dz_plain, the bf16 dz rows
    the f32 rows rounded; one launch of each kernel a call, no gemm_kernel;
    a second run's bits."""
    tm, pack, x = _bwd16_case(dev, m)
    n = tm.n_layers
    ds, dms = FT.trunk_ut_plain(x["du_b"], x["du_s"], m, pack.ws, x["ss"],
                                x["cs"] + [x["c_last"]], tm, keep=True)
    de, dzs = FT.trunk_dz_plain(x["top"], m, pack.ws, x["ss"], torch.stack(ds), tm, keep=True)
    ds_plain = torch.stack(ds)

    def run():
        o = _bwd16_outputs(dev, tm, m, keep)
        kerns = (FT.TRUNK_UT, FT.TRUNK_DZ, FH.GEMM)
        before = [k.launches for k in kerns]
        FT.trunk_ut(m, pack.ws, tm, x["du_b"], x["du_s"], x["ss"], x["cs"], x["c_last"],
                    o["ds"], o["dms"])
        FT.trunk_dz(m, pack.ws, tm, x["top"], x["ss"], ds_plain, o["de"], o["dzs"],
                    wts=pack.wts, dzbs=o["dzbs"])
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kerns, before)] == [1, 1, 0]
        return o

    o, again = run(), run()
    _assert_close(o["de"], de, median=m > 1)
    for l in range(n - 1):
        _assert_close(o["ds"][l], ds[l], median=m > 1)
        if keep:
            _assert_close(o["dms"][l + 1].float(), dms[l + 1].to(torch.bfloat16).float(),
                          median=m > 1)
            _assert_close(o["dzs"][l], dzs[l], median=m > 1)
            assert torch.equal(o["dzbs"][l], o["dzs"][l].to(torch.bfloat16))
    for k, v in o.items():
        for a, b in zip(v if isinstance(v, list) else [v], again[k] if isinstance(v, list)
                        else [again[k]]):
            assert a is None or torch.equal(a, b), k


def _bwd16_both(dev, tm, pack, x, m, keep, fused: bool):
    """Every output of the trunk's backward (ds, de; with dW the kept dm,
    dz (f32, bf16) rows, every dW and db) through cuda_trunk_backward (the
    pair, then the dW sequence) or cuda_trunk_backward_split (one
    gemm_kernel a layer), from the same rows."""
    stream = torch.cuda.current_stream().cuda_stream
    bw = FT.trunk_bwd_buffers(pack.ws, tm, m, dev, tm.Op, keep)
    bw["du_b"].copy_(x["du_b"])
    bw["du_s"].copy_(x["du_s"])
    bw["dzb"][0].copy_(x["top"])
    bw["dzf"][0].copy_(x["top"].float())
    buf = dict(ss=x["ss"], acts=x["acts"], ts=x["ts"], cs=x["cs"])
    dws = [torch.zeros(w.shape, device=dev) for w in pack.ws] if keep else None
    dbs = [torch.zeros(b.shape, device=dev) for b in pack.bs] if keep else None
    fn = FT.cuda_trunk_backward if fused else FT.cuda_trunk_backward_split
    before = FH.GEMM.launches
    fn(FF._lib(), m, x["e"], pack.ws, pack.wts, tm, buf, bw, dws, dbs, keep, 0,
       torch.empty((FT._WS_FLOATS,), device=dev), stream)
    torch.cuda.synchronize()
    assert (FH.GEMM.launches == before) == fused
    n = tm.n_layers
    out = {f"ds[{l}]": bw["ds"][l][:m] for l in range(n - 1)}
    out["de"] = bw["de"][:m]
    if keep:
        out |= {f"dm[{l}]": bw["dms"][l][:m] for l in range(1, n)}
        out |= {f"dz[{l}]": bw["dzs"][l][:m] for l in range(n - 1)}
        out |= {f"dzb[{l}]": bw["dzbs"][l][:m] for l in range(n - 1)}
        out |= {f"dW[{l}]": w for l, w in enumerate(dws)} | {f"db[{l}]": b
                                                              for l, b in enumerate(dbs)}
    return out


@pytest.mark.parametrize("keep", [False, True], ids=["frozen", "dw"])
@pytest.mark.parametrize("m", BWD16_M)
def test_trunk_bwd_bf16_keeps_the_split_launches_bits(dev, m, keep):
    """The pair sums each output in gemm_kernel's order (64-deep K steps of
    wgmma, the skip's tile range then du_s's, epilogue8's arithmetic) and
    the dW sequence runs on its kept rows in the split launches' order: ds,
    de and with dW every kept dm and dz row (f32 and bf16), every dW and db
    equal the split launches' bit for bit (SHA-256 of the bytes)."""
    import hashlib

    tm, pack, x = _bwd16_case(dev, m)
    fused = _bwd16_both(dev, tm, pack, x, m, keep, True)
    split = _bwd16_both(dev, tm, pack, x, m, keep, False)

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    assert all(torch.isfinite(v.float()).all() for v in fused.values())
    moved = [k for k in fused if digest(fused[k]) != digest(split[k])]
    assert not moved, f"bits moved: {moved}"


@pytest.mark.parametrize("m", [1, 65, 4097])
def test_trunk_bwd_bf16_narrow_widths(dev, m):
    """SMALL's trunk (Hp 64, Op 128: 64 columns a consumer, de in pieces of
    64 and 128), both chains chained as the main path runs them, under the
    rule above."""
    tm, pack, x = _bwd16_case(dev, m, SMALL)
    ds, dms = FT.trunk_ut_plain(x["du_b"], x["du_s"], m, pack.ws, x["ss"],
                                x["cs"] + [x["c_last"]], tm, keep=True)
    de, dzs = FT.trunk_dz_plain(x["top"], m, pack.ws, x["ss"], torch.stack(ds), tm, keep=True)
    o = _bwd16_outputs(dev, tm, m, keep=True)
    FT.trunk_ut(m, pack.ws, tm, x["du_b"], x["du_s"], x["ss"], x["cs"], x["c_last"], o["ds"],
                o["dms"])
    FT.trunk_dz(m, pack.ws, tm, x["top"], x["ss"], o["ds"], o["de"], o["dzs"], wts=pack.wts,
                dzbs=o["dzbs"])
    torch.cuda.synchronize()
    _assert_close(o["de"], de, median=m > 1)
    for l in range(tm.n_layers - 1):
        _assert_close(o["ds"][l], ds[l], median=m > 1)
        _assert_close(o["dms"][l + 1].float(), dms[l + 1].to(torch.bfloat16).float(),
                      median=m > 1)
        _assert_close(o["dzs"][l], dzs[l], median=m > 1)


def test_trunk_bwd_bf16_rejects_what_the_kernels_do_not_take(dev):
    """f32 weights under a bf16 trunk, a width the tiles do not split (Hp
    192), an f32 du, no transposed weights, f32 dz rows without their bf16
    ones: ValueError before a launch."""
    tm, pack, x = _bwd16_case(dev, 70)
    o = _bwd16_outputs(dev, tm, 70, keep=True)
    before = FT.TRUNK_UT.launches, FT.TRUNK_DZ.launches
    f32 = [w.float() for w in pack.ws]
    for kw in (dict(ws=f32), dict(tm=tm._replace(d_hidden=192)), dict(du_b=x["du_b"].float())):
        a = dict(x, tm=tm, ws=pack.ws) | kw
        with pytest.raises(ValueError):
            FT.trunk_ut(70, a["ws"], a["tm"], a["du_b"], a["du_s"], a["ss"], a["cs"],
                        a["c_last"], o["ds"])
    for kw in (dict(ws=f32), dict(wts=None), dict(dzbs=None)):
        a = dict(ws=pack.ws, wts=pack.wts, dzbs=o["dzbs"]) | kw
        with pytest.raises(ValueError):
            FT.trunk_dz(70, a["ws"], tm, x["top"], x["ss"], o["ds"], o["de"], o["dzs"],
                        wts=a["wts"], dzbs=a["dzbs"])
    assert (FT.TRUNK_UT.launches, FT.TRUNK_DZ.launches) == before


# The fitting stage's video step and result extraction (the video
# slice): chip_smoke's full-width fit nets and its video check; the
# get_res meshes through K1 and K4 against their plain versions' meshes.

def test_video_step_matches_cpu(dev):
    """Two video steps ('1234') on the card (K1, K2 f32, the frozen K3 f32)
    against the CPU's (their plain versions) at the card's ladder samples:
    chip_smoke.video_check_readings, every reading within its limit."""
    import chip_smoke as CS

    r = CS.video_check_readings(torch, CS.fit_nets(torch, dev), dev)
    assert CS.video_check_worst(r) <= 1.0


@pytest.mark.parametrize("part", ("hand", "obj"))
def test_get_res_mesh_matches_plain(dev, part):
    """get_res's 64^3 mesh of the hand (FusedHandSDF: K1) and the object
    (FusedObjSDF: K4) at a fitted pose against the plain versions' mesh
    (chip_smoke.mesh_rule: the grid's median point within 1e-4 of the
    range, then the K4 mesh check's rule at a level inside the box: vertex
    and triangle counts within 1%, every kernel vertex within one voxel of
    the plain mesh; for K1's bf16 mesh 99% of them, every one within two:
    mesh_rule's docstring)."""
    import chip_smoke as CS
    from honerf_torch.data.synthetic import posed_hand_example
    from honerf_torch.extract import bounds_from_points, evaluate_sdf_grid

    fn = CS.fit_nets(torch, dev)
    # GetResRunner.sdf_fns's packs of the nets
    hand = FH.FusedHandSDF(fn.nets["hand"]["sdf"], fn.hand_sdf)
    obj = FS.FusedObjSDF(fn.nets["obj"]["sdf"], fn.obj_sdf)
    joints = posed_hand_example()[0]
    bt = bone_transforms_from_mano_joints(torch.as_tensor(joints, device=dev)[None])[0]
    t_pose = torch.as_tensor(canonical_hand_joints(0.0), device=dev)
    to = torch.as_tensor(joints.mean(0) + np.asarray([0.0, -0.02, 0.06], np.float32), device=dev)
    if part == "hand":
        rotT, off, cut = FH.pack_hand_pose(bt, t_pose)
        kern = lambda p: hand(p, bt, t_pose)  # noqa: E731
        plain = lambda p: FH.fused_hand_sdf_plain(p, rotT, off, cut, hand.ws, hand.bs,  # noqa: E731
                                                  hand.meta)
        pts, counter = joints, FH.KERNEL
    else:
        kern = lambda p: obj(p - to)  # noqa: E731
        plain = lambda p: FS.fused_obj_sdf_plain((p - to).contiguous(), obj.ws, obj.bs,  # noqa: E731
                                                 obj.meta)
        pts, counter = to.cpu().numpy()[None], FS.KERNEL
    lo, hi = bounds_from_points(pts, 0.08)
    before = counter.launches
    gk = evaluate_sdf_grid(kern, lo, hi, 64, device=dev)
    assert counter.launches > before
    gp = evaluate_sdf_grid(plain, lo, hi, 64, device=dev)
    ok, text = CS.mesh_rule(torch, dev, gk, gp, bf16=part == "hand")
    assert ok, text
