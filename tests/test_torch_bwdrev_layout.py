"""The layout arithmetic of the u-chain seed and of K3's reverse-chain
transpose (honerf_torch/ops/perpoint_layout.py), held against
csrc/trunk.cuh, csrc/fused_fine_bwd.cu and the JAX package.

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there); what surrounds them is checked here
on the CPU: the headers' constants are the module's; every column of
du_b, du_s, dzf and dzb in every row of a tile, the ragged last tile's
included, is written exactly once, and the bulk copies store exactly the
rows of each output; the tiles fit the shared memory in bf16 and f32;
fine_bwd_rev_plain's du and dg_total agree with JAX's `_gpe_transpose` +
`_emb_rev_transpose_block`; the tile map run with the kernel's arithmetic
in torch f32 equals fine_bwd_rev_plain; the seed's threads write every
column of every row once, and uchain_seed_plain is jnp's product rounded
to bf16, bit for bit.  Runs in ~25 s (JAX's trace of the transpose ~15).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine_full as JF
from honerf_tpu.ops.fused_hand import pack_hand_pose as jax_pack_hand_pose
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import perpoint_layout as PL
from test_torch_parity import hand_pose, points_near, t

CSRC = Path(PL.__file__).resolve().parent / "csrc"
# the flagship (confs/wmask_realhand_hand1.conf): Ep 1408, Op 320, Fp 256, L 4
META = FF.FineMeta(v_multires=10, r_multires=7, d_hidden=256, n_layers=9, skip=4, d_out=257)
SMALL = FF.FineMeta(v_multires=3, r_multires=2, d_hidden=64, n_layers=3, skip=1, d_out=65,
                    grad_L=2)


def _header_constants(header, prefix):
    """The header's `constexpr int <prefix>_* = expr`, evaluated in order."""
    env = {}
    text = (CSRC / header).read_text()
    for name, expr in re.findall(rf"^constexpr int ({prefix}_\w+) =\s+([^;]+);", text, flags=re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


@pytest.mark.parametrize("header,prefix,names", [("trunk.cuh", "US", PL.US_CONSTANTS),
                                                 ("fused_fine_bwd.cu", "BWR", PL.BWR_CONSTANTS)])
def test_header_constants_are_the_modules(header, prefix, names):
    env = _header_constants(header, prefix)
    assert set(env) == set(names)
    for name in names:
        assert env[name] == getattr(PL, name), name


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_bwdrev_tiles_fit_shared_memory(esize):
    # the widest rows a tile holds, within the header's cap, and
    # BWR_BLOCKS_PER_SM blocks a SM within its shared memory
    assert PL.bwr_tile_bytes(PL.BWR_EP_MAX, PL.BWR_OP_MAX, esize) <= PL.BWR_TILE_BYTES_MAX
    assert PL.bwr_smem_bytes(PL.BWR_EP_MAX, PL.BWR_OP_MAX, esize) <= PL.BWR_SMEM_MAX
    assert PL.BWR_BLOCKS_PER_SM * (PL.BWR_SMEM_MAX + PL.SMEM_RESERVED) <= PL.SMEM_PER_SM
    # the flagship: a point's rows are 7,552 bytes in bf16 and 13,824 in
    # f32; every sub-tile and the stage rows start 16-byte aligned
    tm = META.trunk_meta
    P = PL.bwr_points(esize)
    assert PL.bwr_tile_bytes(tm.Ep, tm.Op, esize) == P * {2: 7552, 4: 13824}[esize]
    for off, row in PL.bwr_subtile_offsets(tm.Ep, tm.Op, esize).values():
        assert off % 16 == 0 and row % 16 == 0
    assert PL.bwr_tile_bytes(tm.Ep, tm.Op, esize) % 16 == 0
    # the pass-3 units of a bf16 tile fill a block's threads once
    assert P * 63 <= PL.BWR_THREADS


@pytest.mark.parametrize("meta", [META, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_bwdrev_tile_columns_written_once(meta, esize):
    tm = meta.trunk_meta
    Ep, Op, E = tm.Ep, tm.Op, meta.emb_width
    P = PL.bwr_points(esize)
    width = {"du_b": Ep, "du_s": Ep, "dzf": Op, "dzb": Op}
    pad = {k: np.zeros((2, P, w), np.int32) for k, w in width.items()}
    for b, pt, sub, col in PL.bwr_pad_columns(P, Ep, meta.v_multires, meta.r_multires):
        pad[sub][b, pt, col] += 1
    for k in ("du_b", "du_s"):
        assert (pad[k][:, :, E:] == 1).all() and (pad[k][:, :, :E] == 0).all()
    for rows in sorted({P, 1, max(P - 1, 1)}):      # a full tile, M < P, a ragged tail
        count = {k: pad[k][0].copy() for k in width}
        units = PL.bwr_units(rows, meta.v_multires, meta.r_multires, Op)
        assert len(units) == rows * (21 + Op // 8 + 63)
        for _, pt, _, cols in units:
            assert pt < rows
            for sub, col in cols:
                count[sub][pt, col] += 1
        for k, c in count.items():
            assert (c[:rows] == 1).all(), (k, rows)   # every column of a stored row once
            assert (c[rows:, :E] == 0).all(), (k, rows)


@pytest.mark.parametrize("M", [1, 3, 4, 20001])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("lddz", [320, 384], ids=["dense", "strided"])
def test_bwdrev_bulk_copies_store_each_output_once(M, esize, lddz):
    tm = META.trunk_meta
    Ep, Op = tm.Ep, tm.Op
    grid = PL.bwr_grid(M, esize)
    assert 1 <= grid <= PL.BWR_BLOCKS_PER_SM * 132
    spans = {}
    for tile in range(PL.bwr_tiles(M, esize)):
        for name, off, n in PL.bwr_bulk_copies(M, esize, Ep, Ep, Op, lddz, tile):
            assert off % 16 == 0 and n % 16 == 0 and n > 0
            spans.setdefault(name, []).append((off, n))
    row = {"du_b": (Ep * esize, Ep * esize), "du_s": (Ep * esize, Ep * esize),
           "dzf": (Op * 4, lddz * 4), "dzb": (Op * esize, lddz * esize)}
    for name, (n_row, ld) in row.items():
        covered = sorted(spans[name])
        written = np.zeros(M * ld, bool)
        for off, n in covered:
            if ld == n_row:
                assert not written[off:off + n].any()
                written[off:off + n] = True
            else:
                assert n == n_row and off % ld == 0 and not written[off:off + n].any()
                written[off:off + n] = True
        want = np.zeros((M, ld), bool)
        want[:, :n_row] = True
        assert np.array_equal(written, want.reshape(-1)), name


def test_bwdrev_operand_checks():
    ok = {"du_b": 0x1000, "du_s": 0x9000, "dzf": 0x20000, "dzb": 0x30000}
    PL.check_bwr_operands(ok, 1408, 320, 2, 10, 7, 1408, 320, 4)
    PL.check_bwr_operands(ok, 1408, 384, 4, 10, 7, 1408, 320, 4)
    bad = [(dict(ok, dzb=0x30008), 1408, 320, 2, 1408, 320, 4),
           (ok, 1404, 320, 2, 1404, 320, 4), (ok, 1408, 324, 2, 1408, 324, 4),
           (ok, 1380, 320, 2, 1380, 320, 4), (ok, 1600, 320, 2, 1600, 320, 4),
           (ok, 1408, 320, 2, 1408, 448, 4), (ok, 1408, 320, 2, 1408, 320, 9),
           (ok, 1408, 312, 2, 1408, 320, 4)]
    for bases, lddu, lddz, esize, Ep, Op, L in bad:
        with pytest.raises(ValueError):
            PL.check_bwr_operands(bases, lddu, lddz, esize, 10, 7, Ep, Op, L)


def _rev_inputs(meta, n, seed):
    """Seeded points near the hand's joints and the kernel's other inputs:
    packed (g in columns 1-3), dsdf, dg and the color input's cotangent
    dx, normal."""
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, n, seed=seed, scale=0.08)
    rng = np.random.default_rng(seed + 10)
    packed = np.zeros((n, 8), np.float32)
    packed[:, 1:4] = rng.normal(size=(n, 3))
    dsdf, dg = rng.normal(size=(n,)), rng.normal(size=(n, 3))
    dx = rng.normal(size=(n, meta.color_in))
    return (bt, tpose, pts, packed, dsdf.astype(np.float32), dg.astype(np.float32),
            dx.astype(np.float32))


@pytest.mark.parametrize("seed", [4, 5])
def test_fine_bwd_rev_plain_matches_jax(seed):
    """fine_bwd_rev_plain against JAX's reverse-chain transpose on the same
    seeded inputs (vL 10, rL 7, grad_L 4, 300 points): dg_total within
    1e-6 of its range (the two sums' orders differ; seed 4 reads 5.5e-8);
    each du column within 1e-4 of that column's largest |du| (sin / cos
    of another library, amplified 2^l by the recurrence; du reaches ~3e5
    where the cutoff gate is steep; seed 4 reads 3.3e-5 of its column);
    the padding 0, du_s du's product by 1/sqrt2, dz the shifted copy."""
    n = 300
    bt, tpose, pts, packed, dsdf, dg, dx = _rev_inputs(META, n, seed)
    tm = META.trunk_meta
    Ep, Op, Fp, L, E = tm.Ep, tm.Op, META.Fp, META.grad_L, META.emb_width
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    du_b, du_s, dgt, dz, dzb = FF.fine_bwd_rev_plain(t(pts), rotT, off, cut, META, t(packed),
                                                     t(dsdf), t(dg), t(dx), torch.float32)
    jm = JF.FineMeta(v_multires=10, r_multires=7, d_hidden=256, n_layers=9, skip=4, d_out=257,
                     dtype="f32")
    jr, jo, jc = jax_pack_hand_pose(jnp.asarray(bt), jnp.asarray(tpose))
    st = JF._emb_fwd_block(jnp.asarray(np.pad(pts, ((0, 0), (0, 5)))), jr, jo, jc, jm)
    u0 = jnp.zeros((n, E))
    _g, chain = JF._emb_rev_block(st, jr, u0, jm)
    g8 = jnp.asarray(np.pad(packed[:, 1:4], ((0, 0), (0, 5))))
    want_dgt = jnp.asarray(np.pad(dg, ((0, 0), (0, 5)))) + JF._gpe_transpose(
        jm, g8, jnp.asarray(dx[:, Ep + Fp:Ep + Fp + 8 * (1 + 2 * L)]))
    want_du = np.asarray(JF._emb_rev_transpose_block(st, chain, jr, u0, want_dgt, jm)[0])
    want_dgt = np.asarray(want_dgt)[:, :3]
    assert du_b.shape == (n, Ep) and dz.shape == (n, Op) and bool(torch.isfinite(du_b).all())
    assert np.abs(dgt.numpy() - want_dgt).max() <= 1e-6 * np.abs(want_dgt).max()
    err = np.abs(du_b[:, :E].numpy() - want_du).max(0)
    assert (err <= 1e-4 * np.abs(want_du).max(0)).all(), float((err / np.abs(want_du).max(0)).max())
    assert bool((du_b[:, E:] == 0).all())
    assert torch.equal(du_s, du_b * FT.INV_SQRT2)
    assert torch.equal(dz[:, 0], t(dsdf)) and torch.equal(dz[:, 1:257], t(dx[:, Ep:Ep + 256]))
    assert bool((dz[:, 257:] == 0).all()) and torch.equal(dzb, dz)


@pytest.mark.parametrize("meta,seed", [(META, 4), (SMALL, 6)], ids=["flagship", "small"])
def test_bwdrev_map_with_the_kernels_arithmetic_is_the_plain_version(meta, seed):
    """The tile map (bwr_units) run with the kernel's arithmetic in torch
    f32 (bwr_tile_model) against fine_bwd_rev_plain: every column written
    (no NaN left), du within 1e-6 of its range (the two take their
    products in another order; the flagship reads 3.6e-8), dg_total
    within 1e-6 of its range, dz exactly."""
    n = 200
    bt, tpose, pts, packed, dsdf, dg, dx = _rev_inputs(meta, n, seed)
    tm = meta.trunk_meta
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    args = (t(packed), t(dsdf), t(dg), t(dx))
    du, dgt, dz = PL.bwr_tile_model(t(pts), rotT, off, cut, meta.v_multires, meta.r_multires,
                                    *args, tm.Ep, meta.d_out - 1, meta.Fp, meta.grad_L, tm.Op)
    want = FF.fine_bwd_rev_plain(t(pts), rotT, off, cut, meta, *args, torch.float32)
    assert not bool(torch.isnan(du).any()) and not bool(torch.isnan(dz).any())
    assert float((du - want[0]).abs().max()) <= 1e-6 * float(want[0].abs().max())
    assert float((dgt - want[2]).abs().max()) <= 1e-6 * float(want[2].abs().max())
    assert torch.equal(dz, want[3])


def test_fine_bwd_rev_wrapper_on_the_cpu_writes_the_plain_rows():
    meta = SMALL
    tm = meta.trunk_meta
    n, m = 40, 33
    bt, tpose, pts, packed, dsdf, dg, dx = _rev_inputs(meta, n, 7)
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    nan = float("nan")
    du_b, du_s = (torch.full((n, tm.Ep), nan, dtype=torch.bfloat16) for _ in range(2))
    dzf, dzb = torch.full((n, tm.Op), nan), torch.full((n, tm.Op), nan, dtype=torch.bfloat16)
    dgt = torch.full((n, 4), nan)
    before = FF.BWDREV.launches
    FF.fine_bwd_rev(None, t(pts), m, rotT, off, cut, meta, t(packed), t(dsdf), t(dg), t(dx),
                    du_b, du_s, dgt, dzf, dzb, None)
    assert FF.BWDREV.launches == before
    want = FF.fine_bwd_rev_plain(t(pts[:m]), rotT, off, cut, meta, t(packed[:m]), t(dsdf[:m]),
                                 t(dg[:m]), t(dx[:m]), torch.bfloat16)
    for got, w in zip((du_b, du_s, dgt[:, :3], dzf, dzb), want):
        assert torch.equal(got[:m], w)
        assert bool(torch.isnan(got[m:].float()).all())


# ---------------------------------------------------------------------------
# The u-chain's seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,M", [(256, 1), (256, 7), (256, 8), (256, 20001), (64, 1001),
                                     (2048, 3), (2048, 1001)])
def test_seed_columns_written_once(width, M):
    grid = PL.us_grid(M, width)
    rows = PL.us_rows(width)
    assert 1 <= grid <= PL.US_BLOCKS_PER_SM * 132 and rows * (width // PL.US_VEC) <= PL.US_THREADS
    count = np.zeros((M, width // PL.US_VEC), np.int32)
    for b in range(grid):
        for th in range(PL.US_THREADS):
            for m, c0 in PL.us_columns(M, width, b, th, grid):
                assert c0 % PL.US_VEC == 0
                count[m, c0 // PL.US_VEC] += 1
    assert (count == 1).all()


def test_seed_operand_checks():
    PL.check_us_operands(0x1000, 0x2000, 256, 256)
    PL.check_us_operands(0x1000, 0x2000, 2048, 2056)
    for s, tb, width, ldt in ((0x1004, 0x2000, 256, 256), (0x1000, 0x2002, 256, 256),
                              (0x1000, 0x2000, 260, 264), (0x1000, 0x2000, 256, 252),
                              (0x1000, 0x2000, 256, 260), (0x1000, 0x2000, 2056, 2056)):
        with pytest.raises(ValueError):
            PL.check_us_operands(s, tb, width, ldt)


def test_seed_plain_is_jnps_product_in_bf16_bit_for_bit():
    """uchain_seed_plain (one f32 product rounded once) against jnp's
    (s * W[:, 0]).astype(bfloat16) on seeded inputs: the same bits; f32
    the same product unrounded."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(256, 320)).astype(np.float32) * 0.1
    s = rng.uniform(size=(1000, 256)).astype(np.float32)
    w_bf = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray((jnp.asarray(s) * w_bf[:, 0].astype(jnp.float32)).astype(jnp.bfloat16))
    got = FT.uchain_seed_plain(torch.as_tensor(np.array(w_bf.astype(jnp.float32))).to(
        torch.bfloat16), t(s), 1000, torch.bfloat16)
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    got32 = FT.uchain_seed_plain(t(w), t(s), 1000, torch.float32)
    assert np.array_equal(got32.numpy(), s * w[:, 0])


def test_seed_wrapper_on_the_cpu_writes_the_plain_rows():
    w = torch.randn(256, 320).to(torch.bfloat16)
    s = torch.rand(50, 256)
    tt = torch.full((64, 264), float("nan"), dtype=torch.bfloat16)
    before = FT.UCHAIN.launches
    FT.uchain_seed(None, w, s, 40, tt, None)
    assert FT.UCHAIN.launches == before
    assert torch.equal(tt[:40, :256], FT.uchain_seed_plain(w, s, 40, torch.bfloat16))
    assert bool(torch.isnan(tt[40:].float()).all()) and bool(torch.isnan(tt[:, 256:].float()).all())
