"""The bf16 color net's plain versions (fused_fine_full.color_fwd_plain,
color_bwd_plain: what color_fwd_kernel and color_bwd_kernel are held
against on the card) against the JAX package's `_color_fwd_block` /
`_color_bwd_block` with FineMeta(dtype='bf16'), K2's plain pass against
the new plain forward, and the CPU wrappers (CPU):
  * the plain versions (color and relu rows; dx, every dz row, and with
    dW dcW = a^T dz and dcb = sum dz) against JAX's `_color_fwd_block`
    (with residuals) / `_color_bwd_block` (res_stash, with and without dW)
    in bf16 within 1e-3 of the range (the same bf16 operands, f32 sums in
    another order: a rare activation one bf16 ulp apart);
  * K2's and K3's plain passes run these functions (K3's backward is
    the res_stash form, JAX's stash mode): tests/test_torch_fused_fine_full.py
    and tests/test_torch_fine_bwd.py hold them, bf16 and f32, against the
    JAX kernels in interpret mode;
  * on the CPU the wrappers write their plain versions' rows, count no
    launch, and refuse an f32 pack; K2's buffers keep no relu rows
    without keep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine_full as JFF
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import fused_hand as FH
from test_torch_color_bf16_layout import _color_case

SMALL = FF.FineMeta(2, 1, 16, 5, 2, 17, "bf16", c_hidden=64, c_layers=3)
BF16 = torch.bfloat16

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package, and the CPU wrappers
# ---------------------------------------------------------------------------

def _jmeta(meta):
    return JFF.FineMeta(v_multires=meta.v_multires, r_multires=meta.r_multires,
                        d_hidden=meta.d_hidden, n_layers=meta.n_layers, skip=meta.skip,
                        d_out=meta.d_out, dtype="bf16", with_color=True, c_hidden=meta.c_hidden,
                        c_layers=meta.c_layers, grad_L=meta.grad_L)


def _assert_jax_close(got, want, tol=1e-3):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()), 1e-6)


def _to_np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("want_dw", [False, True], ids=["no_dw", "dw"])
def test_plain_color_matches_jax_blocks(want_dw):
    """color_fwd_plain's color and relu rows against JAX's _color_fwd_block
    (with residuals), then color_bwd_plain's dx and dz rows at the sigmoid
    it read back and the kept rows against JAX's _color_bwd_block
    (res_stash) on the same kernel-layout bf16 x, weights and dcolor at
    SMALL (color input 448, 64-wide hidden layers); with dW, the port's
    dcW = a^T dz and dcb = sum dz (its _color_bwd_block) against JAX's."""
    B = 24
    cws, cbs, e, cx2, dcolor = _color_case(SMALL, B, seed=7)
    jm = _jmeta(SMALL)
    x = torch.cat([e, cx2], 1)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jw = [jnp.asarray(w.float().numpy()).astype(jnp.bfloat16) for w in cws]
    jb = [jnp.asarray(b.numpy())[None] for b in cbs]
    j_color, _zs, j_acts = JFF._color_fwd_block(jm, jx, jw, jb, with_residuals=True)
    color, acts = FF.color_fwd_plain(e, cx2, B, cws, cbs, SMALL)
    _assert_jax_close(color, _to_np(j_color)[:, :3])
    for a, ja in zip(acts, j_acts[1:]):
        _assert_jax_close(_to_np(a), _to_np(ja))
    packed = torch.zeros((B, 8))
    packed[:, 4:7] = color
    dx, dzs = FF.color_bwd_plain(B, cws, SMALL, packed, dcolor, acts)
    dcol = np.pad(dcolor.numpy(), ((0, 0), (0, 61)))
    sig8 = np.asarray(j_color, np.float32)[:, :8]
    j_dx, j_dcw, j_dcb = JFF._color_bwd_block(jm, jx, jw, jb, jnp.asarray(dcol), want_dw=want_dw,
                                              res_stash=(jnp.asarray(sig8), j_acts))
    _assert_jax_close(dx, j_dx)
    if not want_dw:
        assert j_dcw is None
        for i in (0, 5, 17):   # a point's dcb is its dz row
            _, _, j_dcb1 = JFF._color_bwd_block(
                jm, jx[i:i + 1], jw, jb, jnp.asarray(dcol[i:i + 1]),
                res_stash=(jnp.asarray(sig8[i:i + 1]), [a[i:i + 1] for a in j_acts]))
            for dz, jdz in zip(dzs, j_dcb1):
                _assert_jax_close(dz[i:i + 1], jdz)
        return
    p_dx, dcws, dcbs, p_dzs = FF._color_bwd_block(SMALL, color, [x.float()] + acts, cws, dcolor,
                                                  True)
    assert torch.equal(p_dx, dx) and all(torch.equal(a, b) for a, b in zip(p_dzs, dzs))
    for dw, jdw in zip(dcws, j_dcw):
        _assert_jax_close(dw, jdw)
    for db, jdb in zip(dcbs, j_dcb):
        _assert_jax_close(db, np.asarray(jdb)[0])


def test_k2_plain_pass_runs_the_new_color_function():
    """K2's plain pass (the CPU path tests/test_torch_fused_fine_full.py
    holds against JAX's kernel in interpret mode, bf16 and f32) forms the
    color of its own rows [e | feat | grad-PE] as color_fwd_plain does, to
    the bit, relu rows included."""
    from test_torch_parity import SMALL as NET, configs, hand_pose, net_params, points_near, t

    from honerf_torch.models.fields import fine_color_weights
    from honerf_torch.ops.fused_hand import pack_hand_pose

    _, _, tcfg, tccfg = configs(NET, "bf16")
    _, tp = net_params(NET)
    bt, tpose, joints = hand_pose()
    pts = t(points_near(joints, 40, seed=6))
    meta, ws, bs, cws, cbs = fine_color_weights(tp, tcfg, tccfg)
    pack = FF.pack_fine_weights(ws, bs, cws, cbs, meta)
    rotT, off, cut = pack_hand_pose(t(bt), t(tpose))
    _s, _g, color, res = FF._fine_fwd_block(meta, pts, rotT, off, cut, pack, residuals=True)
    acts = res[5]
    Ep = meta.trunk_meta.Ep
    x = acts[0]
    p_color, p_acts = FF.color_fwd_plain(x[:, :Ep].to(BF16), x[:, Ep:].to(BF16), pts.shape[0],
                                         pack.cws, pack.cbs, meta)
    assert torch.equal(p_color, color)
    assert all(torch.equal(a.float(), b) for a, b in zip(p_acts, acts[1:]))


def test_cpu_wrappers_write_plain_rows_and_count_nothing():
    m, C, nan = 50, 60, float("nan")
    cws, cbs, e, cx2, dcolor = _color_case(SMALL, C, seed=9)
    n, H = SMALL.c_layers, cws[0].shape[1]
    packed = torch.full((C, 8), nan)
    cacts = FT.planes(n - 1, C, H, "cpu", BF16)
    for a in cacts:
        a.fill_(nan)
    counters = (FF.COLOR_FWD, FF.COLOR_BWD, FF.COLOR_DZ, FH.GEMM)
    before = [k.launches for k in counters]
    FF.color_fwd(e, cx2, m, cws, cbs, SMALL, packed, cacts)
    color, acts = FF.color_fwd_plain(e, cx2, m, cws, cbs, SMALL)
    assert torch.equal(packed[:m, 4:7], color) and torch.isnan(packed[m:]).all()
    assert torch.isnan(packed[:, :4]).all() and torch.isnan(packed[:, 7]).all()
    for a, want in zip(cacts, acts):
        assert torch.equal(a[:m], want) and torch.isnan(a[m:].float()).all()
    dx = torch.full((C, SMALL.color_in), nan)
    cdz, cdzb = FT.planes(n, C, H, "cpu", torch.float32), FT.planes(n, C, H, "cpu", BF16)
    for z in cdz + cdzb:
        z.fill_(nan)
    FF.color_bwd(m, cws, None, SMALL, packed, dcolor, cacts, dx, cdz, cdzb)
    p_dx, p_dzs = FF.color_bwd_plain(m, cws, SMALL, packed, dcolor, cacts)
    assert torch.equal(dx[:m], p_dx) and torch.isnan(dx[m:]).all()
    for z, zb, want in zip(cdz, cdzb, p_dzs):
        w = want.shape[1]
        assert torch.equal(z[:m, :w], want) and torch.isnan(z[m:]).all()
        assert torch.equal(zb[:m, :w], want.to(BF16)) and torch.isnan(zb[m:].float()).all()
    assert [k.launches for k in counters] == before
    f32 = [w.float() for w in cws]
    for meta, ws in ((SMALL._replace(dtype="f32"), cws), (SMALL, f32)):
        with pytest.raises(ValueError):
            FF.color_fwd(e, cx2, m, ws, cbs, meta, packed)
        with pytest.raises(ValueError):
            FF.color_bwd(m, ws, None, meta, packed, dcolor, cacts, dx)
    with pytest.raises(ValueError):
        FF.color_bwd(m, cws, None, SMALL, packed, dcolor, cacts, dx, cdz)
    pack = FF.FinePack((), (), tuple(cws), tuple(cbs), None, None, SMALL)
    assert FF._fwd_buffers(pack, 8, "cpu", keep=False)["cacts"] == []
    assert len(FF._fwd_buffers(pack, 8, "cpu", keep=True)["cacts"]) == n - 1
