"""The layout arithmetic of the embedding kernel and the column sum
(honerf_torch/ops/perpoint_layout.py), held against csrc/common.cuh and
csrc/trunk.cuh and against the JAX package.

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there); what surrounds them is checked here
on the CPU: the headers' constants are the module's; every column of every
row of an embedding tile, the ragged last tile's included, is written
exactly once, the bulk copies store exactly the rows of e, and the tiles
fit the shared memory in bf16 and f32; the tile map run with the kernel's
arithmetic in torch f32 agrees with JAX's channel-major embedding; the
column sum's stated order (fused_fine.colsum_ordered_plain) is what a
thread-by-thread model of the kernel adds, bit for bit, and is within f32
noise of the f64 sum.  Runs in a few seconds.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.models.embedding import hand_embedding_flat as jax_hand_embedding_flat
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import perpoint_layout as PL
from test_torch_parity import hand_pose, points_near, t

CSRC = Path(PL.__file__).resolve().parent / "csrc"
FLAGSHIP = dict(vL=10, rL=7, lde=1408)


def _header_constants():
    """The headers' namespace-level `constexpr int EMB_* / CS_* = expr`,
    evaluated in order."""
    env = {}
    for header in ("common.cuh", "trunk.cuh"):
        text = (CSRC / header).read_text()
        for name, expr in re.findall(r"^constexpr int ((?:EMB|CS)_\w+) = ([^;]+);", text,
                                     flags=re.M):
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_header_constants_are_the_modules():
    env = _header_constants()
    assert set(env) == set(PL.CONSTANTS)
    for name in PL.CONSTANTS:
        assert env[name] == getattr(PL, name), name


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_embedding_tiles_fit_shared_memory(esize):
    # a tile of the widest row: P x EMB_LDE_MAX elements, within the
    # header's cap; EMB_BLOCKS_PER_SM blocks a SM fit its shared memory
    P = PL.emb_points(esize)
    assert P * PL.EMB_LDE_MAX * esize == PL.EMB_TILE_BYTES_MAX
    assert PL.emb_smem_bytes(PL.EMB_LDE_MAX, esize) <= PL.EMB_SMEM_MAX
    assert PL.EMB_BLOCKS_PER_SM * (PL.EMB_SMEM_MAX + PL.SMEM_RESERVED) <= PL.SMEM_PER_SM
    # the flagship's row: 2,816 bytes in bf16, 5,632 in f32; a 45 KB tile
    lde = FLAGSHIP["lde"]
    assert lde * esize % 16 == 0 and P * lde * esize == 45056
    # the second buffer and the stage rows start 16-byte aligned
    assert P * lde * esize % 16 == 0 and 2 * P * lde * esize % 16 == 0


@pytest.mark.parametrize("vL,rL,lde", [(10, 7, 1408), (3, 2, 512), (1, 1, 256)],
                         ids=["flagship", "small", "narrow"])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_embedding_tile_columns_written_once(vL, rL, lde, esize):
    P = PL.emb_points(esize)
    E = PL.emb_width(vL, rL)
    pad = np.zeros((2, P, lde), np.int32)
    for row, col in PL.emb_pad_columns(P, lde, vL, rL):
        pad.reshape(2 * P, lde)[row, col] += 1
    assert (pad[:, :, E:] == 1).all() and (pad[:, :, :E] == 0).all()
    for rows in (P, 1, P - 3):                     # a full tile, M < P, a ragged tail
        count = pad[0].copy()
        units = PL.emb_units(rows, vL, rL)
        assert len(units) == 84 * rows
        for _, pt, _, _, cols in units:
            assert pt < rows
            np.add.at(count[pt], cols, 1)
        assert (count[:rows] == 1).all(), rows      # every column of a stored row once
        assert (count[rows:, :E] == 0).all()        # no unit touches a row past M


@pytest.mark.parametrize("M", [1, 15, 16, 70001, 131072])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_embedding_bulk_copies_store_e_once(M, esize):
    lde = FLAGSHIP["lde"]
    grid = PL.emb_grid(M, esize)
    assert 1 <= grid <= PL.EMB_BLOCKS_PER_SM * 132
    spans = sorted(PL.emb_bulk_bytes(M, esize, lde, tile)
                   for b in range(grid) for tile in PL.emb_block_tiles(M, esize, b, grid))
    assert len(spans) == PL.emb_tiles(M, esize)
    at = 0
    for off, n in spans:
        assert off == at and n % 16 == 0 and 0 < n <= PL.EMB_TILE_BYTES_MAX
        at = off + n
    assert at == M * lde * esize


def test_embedding_operand_checks():
    PL.check_emb_operand(0x1000, 1408, 2, 10, 7)
    PL.check_emb_operand(0x1000, 1408, 4, 10, 7)
    for base, lde, esize in ((0x1002, 1408, 2), (0x1000, 1404, 2), (0x1000, 1380, 2),
                             (0x1000, 1600, 4)):
        with pytest.raises(ValueError):
            PL.check_emb_operand(base, lde, esize, 10, 7)


def _frequencies(vL, rL, lde):
    """2^l of each column's frequency l (1 for v h, r h and the padding)."""
    f = np.ones(lde)
    for l in range(vL):
        f[21 + 21 * l: 42 + 21 * l] = f[21 + 21 * (vL + l): 42 + 21 * (vL + l)] = 2.0 ** l
    rb = 21 * (1 + 2 * vL)
    for l in range(rL):
        f[rb + 63 + 63 * l: rb + 126 + 63 * l] = 2.0 ** l
        f[rb + 63 + 63 * (rL + l): rb + 126 + 63 * (rL + l)] = 2.0 ** l
    return f


@pytest.mark.parametrize("seed", [4, 5])
def test_embedding_map_matches_jax(seed):
    """The tile map with the kernel's arithmetic in torch f32 against JAX's
    channel-major embedding (sin / cos of 2^l x directly, r = q / v),
    padded, 300 points: each column of frequency l within 2^l x 4e-6 (the
    kernel's r = q rsqrt(v^2) and JAX's q / v differ by up to ~4e-6 near a
    bone's origin, and each step of the recurrence doubles an error; the
    worst of seed 4 reads 2.0e-4 at l = 6, 0.78 of its limit)."""
    bt, tpose, joints = hand_pose()
    pts = points_near(joints, 300, seed=seed, scale=0.08)
    vL, rL, lde = FLAGSHIP["vL"], FLAGSHIP["rL"], FLAGSHIP["lde"]
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    got = PL.emb_tile_model(t(pts), rotT, off, cut, vL, rL, lde)
    want = np.asarray(jax_hand_embedding_flat(jnp.asarray(pts), jnp.asarray(bt),
                                              jnp.asarray(tpose), vL, rL)[0])
    want = np.pad(want, ((0, 0), (0, lde - want.shape[1])))
    assert got.shape == (300, lde) and bool(torch.isfinite(got).all())
    err = np.abs(got.numpy() - want)
    assert (err <= 4e-6 * _frequencies(vL, rL, lde)).all(), float(err.max())
    # the plain version of the wrapper gives the same f32 values
    e32 = FH.embed_plain(t(pts), rotT, off, cut, vL, rL, lde, torch.float32)
    np.testing.assert_allclose(e32.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_embed_wrapper_on_the_cpu_writes_the_plain_rows():
    bt, tpose, joints = hand_pose()
    pts = t(points_near(joints, 40, seed=5))
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    e = torch.full((64, 512), float("nan"), dtype=torch.bfloat16)
    before = FH.EMBED.launches
    FH.embed(None, pts, 40, rotT, off, cut, 3, 2, e, None)
    assert FH.EMBED.launches == before
    assert torch.equal(e[:40], FH.embed_plain(pts, rotT, off, cut, 3, 2, 512))
    assert bool(torch.isnan(e[40:].float()).all())


def _colsum_thread_model(Z, N, m):
    """colsum_partial_kernel thread by thread, in numpy f32 scalars: what
    each thread, warp and last block adds, in the kernel's order."""
    lay = PL.colsum_split(m, N)
    split, S = lay["split"], lay["S"]
    f = np.float32
    part = np.zeros((S, N), f)
    for s in range(S):
        r0, r1 = s * split, min(m, (s + 1) * split)
        t_w = []
        for w in range(PL.CS_WARPS):
            a = [np.zeros(N, f) for _ in range(PL.CS_ACC)]
            for base in range(r0, r1, PL.CS_ROW_STEP):
                for k in range(PL.CS_ACC):
                    r = base + PL.CS_WARPS * k + w
                    if r < r1:
                        a[k] = a[k] + Z[r, :N]
            t_w.append((a[0] + a[1]) + (a[2] + a[3]))
        p = t_w[0]
        for w in range(1, PL.CS_WARPS):
            p = p + t_w[w]
        part[s] = p
    q = []
    for w in range(PL.CS_WARPS):
        acc = np.zeros(N, f)
        for s in range(w, S, PL.CS_WARPS):
            acc = acc + part[s]
        q.append(acc)
    tot = q[0]
    for w in range(1, PL.CS_WARPS):
        tot = tot + q[w]
    return tot


@pytest.mark.parametrize("m,N", [(1, 4), (45, 8), (1000, 12), (3000, 136)])
def test_colsum_order_is_the_kernels(m, N):
    rng = np.random.default_rng(m)
    Z = (rng.normal(size=(m, N + 4)) * np.exp(rng.normal(size=(m, 1)) * 3)).astype(np.float32)
    want = _colsum_thread_model(Z, N, m)
    got = FT.colsum_ordered_plain(torch.as_tensor(Z), N, m)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m,N", [(56448, 256), (56448, 320), (70001, 64)])
def test_colsum_ordered_plain_is_the_sum(m, N):
    """Within f32 noise of the f64 sum (|err| <= 1e-5 of the sum of |Z|),
    the same bits twice, and += on acc."""
    rng = np.random.default_rng(N)
    Z = torch.as_tensor(rng.normal(size=(m, 320)).astype(np.float32))
    a = FT.colsum_ordered_plain(Z, N, m)
    assert torch.equal(a, FT.colsum_ordered_plain(Z, N, m))
    want = Z[:, :N].double().sum(0)
    assert float((a.double() - want).abs().max()) <= 1e-5 * float(Z[:, :N].abs().sum(0).max())
    out = torch.ones(N + 3)
    FT.colsum_ordered_plain(Z, N, m, out, acc=1)
    assert torch.equal(out[:N], 1.0 + a) and torch.equal(out[N:], torch.ones(3))
    lay = PL.colsum_split(m, N)
    assert lay["split"] % PL.CS_ROW_STEP == 0 and lay["S"] * lay["split"] >= m
    assert lay["S"] * lay["tiles"] <= PL.CS_BLOCKS + lay["tiles"]
    assert PL.colsum_workspace(m, N) <= FT._WS_FLOATS


def test_colsum_wrapper_on_the_cpu_and_its_preconditions():
    Z = torch.randn(300, 72)
    out = torch.zeros(64)
    before = FT.COLSUM.launches
    FT._colsum(None, Z, 64, 300, out, 0, None, None)
    assert FT.COLSUM.launches == before
    assert torch.equal(out, FT.colsum_ordered_plain(Z, 64, 300))
    r = PL.colsum_row_owner(5 * 96 + 2 * 32 + 3 * 8 + 7, 96)
    assert r == (5, 2, 3, 7)
    for N in (6, PL.CS_COLS * PL.CS_MAX_TILES + 4):
        with pytest.raises(ValueError):
            PL.colsum_split(100, N)
