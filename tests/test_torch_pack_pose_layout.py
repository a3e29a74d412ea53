"""The pack of e (trunk_pack_e_kernel, K5 / K6's operand) and K3's pose sums
(pose_sum_kernel): their plain versions against the JAX package and their
layout arithmetic (honerf_torch/ops/perpoint_layout.py) against
csrc/fused_trunk.cu, csrc/fused_fine_bwd.cu and the kernels' contracts.

The kernels run only on the card (tests/test_torch_cuda.py holds them bit
for bit against their plain versions there).  Here: the sources' PK_* and
PS_* constants are the module's; trunk_pack_e_plain is JAX's
jnp.pad(e, ...).astype(...) bit for bit, rounding ties included; on CPU
tensors the wrappers write their plain versions' rows, count no launch and
refuse what the kernels do not take; the pack's row plan, run on the bytes
of e at every source offset mod 16 and both row strides, writes every
column below Ep of every row once, zeros past E, loads only inside its
row and at its pieces' alignment; the pose sum's split sums every row once
with about two blocks a SM at a step's sizes and few at small ones, and
pose_sum_ordered_plain is a thread-by-thread walk of the kernel's order
bit for bit and within f32 noise of f64.  K3's drotT / doff against JAX
stay in tests/test_torch_fine_bwd.py.  Runs in a few seconds.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine as FJ
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import perpoint_layout as PL

CSRC = Path(PL.__file__).resolve().parent / "csrc"
E, EP = 1386, 1408   # the flagship's embedding and its padded width


def _constants(source, prefix):
    env = {}
    text = (CSRC / source).read_text()
    for decl in re.findall(rf"^constexpr int ({prefix}\w+ = [^;]+);", text, flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


@pytest.mark.parametrize("source,prefix,names", [("fused_trunk.cu", "PK_", PL.PK_CONSTANTS),
                                                 ("fused_fine_bwd.cu", "PS_", PL.PS_CONSTANTS)])
def test_source_constants_are_the_helpers(source, prefix, names):
    env = _constants(source, prefix)
    assert set(env) == set(names)
    for name in names:
        assert env[name] == getattr(PL, name), name


# ---------------------------------------------------------------------------
# The pack of e
# ---------------------------------------------------------------------------

def _e_with_ties(n, seed=0):
    """Seeded normal e (n, E) in f32 whose first columns sit on and beside
    bf16 rounding ties: exact ties (the low 16 bits 0x8000, odd and even
    upper halves) and one f32 ulp either side of them."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, E)).astype(np.float32)
    bits = e.view(np.uint32)
    low = np.array([0x8000, 0x7FFF, 0x8001], dtype=np.uint32)
    cols = 3 * 64
    hi = bits[:, :cols] & np.uint32(0xFFFF0000)
    bits[:, :cols] = hi | np.tile(low, cols // 3)[None, :]
    return e


def _jax_pack(e, dtype):
    meta = FJ.TrunkMeta(emb_width=E, d_hidden=256, n_layers=9, skip=4, d_out=257, dtype=dtype)
    Ep = FJ._round_up(E, FJ._LANE)
    assert Ep == EP
    got = jnp.pad(jnp.asarray(e), ((0, 0), (0, Ep - E))).astype(FJ._cast(meta))
    return np.asarray(got.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_pack_plain_is_jax_bit_for_bit(dtype):
    """trunk_pack_e_plain against JAX's operand of K5 / K6
    (honerf_tpu/ops/fused_fine.py:527): the same bits, ties and their
    neighbours included, the padding zero."""
    e = _e_with_ties(37)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = FT.trunk_pack_e_plain(torch.as_tensor(e), 37, EP, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (37, EP)
    want = _jax_pack(e, dtype)
    assert np.array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    assert not got[:, E:].float().any()
    if dtype == "bf16":   # the ties went both ways: round to nearest even
        up = (got[:, :192].float().numpy().view(np.uint32) >> 16) != (
            e[:, :192].view(np.uint32) >> 16)
        assert 0 < up.mean() < 1


def test_pack_wrapper_on_the_cpu_writes_the_plain_rows():
    e = torch.as_tensor(_e_with_ties(11, seed=1))
    for dt in (torch.bfloat16, torch.float32):
        eb = torch.full((13, EP), float("nan"), dtype=dt)
        before = FT.PACK.launches
        FT.trunk_pack_e(None, e[2:], 9, eb, None)
        assert FT.PACK.launches == before
        assert torch.equal(eb[:9], FT.trunk_pack_e_plain(e[2:], 9, EP, dt))
        assert bool(torch.isnan(eb[9:].float()).all())


def test_pack_wrapper_refuses_what_the_kernel_does_not_take():
    e, eb = torch.randn((8, 64)), torch.empty((8, 128), dtype=torch.bfloat16)
    for args in ((e.double(), 8, eb), (e, 8, eb.to(torch.float16)), (e[:, ::2], 8, eb),
                 (e, 9, eb), (e, -1, eb), (e, 8, eb[:, :32]), (e[0], 1, eb)):
        with pytest.raises(ValueError):
            FT.trunk_pack_e(None, *args, None)
    # what only the card's launch checks: a misaligned out, rows of out not
    # 16 bytes apart, a width off 8 columns, lde below E, e off 4 bytes
    for args in ((2, 128, 2, 64, 64, 128), (0, 124, 2, 64, 64, 120), (0, 128, 2, 64, 64, 124),
                 (0, 128, 2, 60, 64, 128), (0, 128, 4, 64, 64, 128, 2)):
        with pytest.raises(ValueError):
            PL.check_pack_operands(*args)
    PL.check_pack_operands(0, 1408, 2, 1386, 1386, 1408, 8)


def _pack_model(flat, base, lde, M, esize, ldo):
    """eb (M, EP) as float64, NaN where nothing is written, filled vector by
    vector as pack_columns says from the f32 buffer `flat` (e's rows at
    byte offset base + 4 lde m); asserts each vector's pieces lie inside
    its row and on their own width, and each store on 16 bytes."""
    out = np.full((M, EP), np.nan)
    writes = np.zeros((M, EP), dtype=int)
    for m in range(M):
        s_addr = base + 4 * lde * m
        for kind, lane, cols, pieces, st in PL.pack_columns(s_addr, E, EP, esize,
                                                            d_addr=m * ldo * esize):
            assert 0 <= lane < 32 and st % 16 == 0
            vals = np.zeros(PL.pack_vec(esize))
            for addr, nbytes in pieces:
                assert addr % nbytes == 0 and s_addr <= addr and addr + nbytes <= s_addr + 4 * E
                for b in range(0, nbytes, 4):
                    c = (addr + b - s_addr) // 4
                    vals[c - cols[0]] = flat[(addr + b) // 4]
            if kind == "full":
                assert sum(n for _, n in pieces) == 4 * PL.pack_vec(esize)
            out[m, cols] = vals
            writes[m, cols] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("lde", [E, EP])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_pack_plan_writes_every_column_once(lde, offset):
    """The plan on 9 rows of e at a source offset of 0, 4, 8 or 12 bytes
    past 16 and row strides 1386 (every other row 8 bytes off) and 1408:
    every (row, column < Ep) written once, the padding zero, the values
    those of trunk_pack_e_plain bit for bit; loads at the widest piece the
    row's alignment allows."""
    M = 9
    rng = np.random.default_rng(offset + lde)
    flat = rng.normal(size=(offset // 4 + M * lde + 8,)).astype(np.float32)
    rows = torch.as_tensor(flat[offset // 4:offset // 4 + M * lde].reshape(M, lde))
    for esize, dt in ((2, torch.bfloat16), (4, torch.float32)):
        model = _pack_model(flat, offset, lde, M, esize, EP)
        assert not model[:, E:].any()
        want = FT.trunk_pack_e_plain(rows[:, :E], M, EP, dt)
        got = torch.as_tensor(model.astype(np.float32)).to(dt)
        assert torch.equal(got, want)
    for m in range(M):
        lb = PL.pack_load_bytes(offset + 4 * lde * m)
        assert lb == {0: 16, 8: 8}.get((offset + 4 * lde * m) % 16, 4)
    assert PL.pack_plan(0, E, EP, 2) == (16, 173, 176)   # 1384..1391 straddles E
    assert PL.pack_plan(8, E, EP, 4) == (8, 346, 352)    # 1384..1387
    for esize, n_pad, last in ((2, 2, 1392), (4, 5, 1388)):
        kinds = [k for k, *_ in PL.pack_columns(8, E, EP, esize)]
        assert kinds.count("straddle") == 1 and kinds.count("pad") == n_pad
        straddle = [x for x in PL.pack_columns(8, E, EP, esize) if x[0] == "straddle"][0]
        assert straddle[2] == list(range(1384, last)) and len(straddle[3]) == 2


@pytest.mark.parametrize("M", [1, 7, 56448, 65536 + 77])
def test_pack_grid_takes_every_row_once(M):
    for resident in (1, 4, 8):
        grid = PL.pack_grid(M, resident)
        assert 1 <= grid <= resident * 132
        rows = [r for b in range(grid) for w in range(PL.PK_WARPS)
                for r in PL.pack_rows(M, b, w, grid)]
        assert sorted(rows) == list(range(M))
    # one batch of vectors a warp covers a flagship row, of either type
    assert PL.PK_BATCH >= EP and PL.PK_BATCH % (32 * PL.pack_vec(2)) == 0


# ---------------------------------------------------------------------------
# The pose sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 511, 512, 513, 18816, 28224, 56448])
def test_pose_split_sums_every_row_once(M):
    """Every row has one owner (block, step, accumulator, lane), inside its
    block's range; about two blocks a SM at a step's sizes, few blocks at
    small M."""
    lay = PL.pose_split(M)
    split, S = lay["split"], lay["S"]
    assert split >= PL.PS_ROW_STEP and S == -(-M // split)
    owners = set()
    for r in range(M):
        s, i, k, lane = PL.pose_row_owner(r, split)
        assert s < S and PL.PS_ROW_STEP * i + PL.PS_LANES * k + lane < split
        assert s * split + PL.PS_ROW_STEP * i + PL.PS_LANES * k + lane == r
        owners.add((s, i, k, lane))
    assert len(owners) == M
    if M >= 18816:
        assert 1.8 * 132 <= S <= PL.PS_BLOCKS_PER_SM * 132
    else:
        assert S <= 17
    assert PL.pose_workspace(M) == S * PL.PS_COLS <= FT._WS_FLOATS   # the scratch K3 passes
    assert PL.pose_split(M, 114)["S"] <= PL.PS_BLOCKS_PER_SM * 114 + 1


def _walk(X, n, split):
    """The kernel's order thread by thread in numpy f32 scalars: a list of
    each block's partial row (PS_COLS,)."""
    f = np.float32
    parts = []
    for s in range(-(-n // split)):
        r0, r1 = s * split, min(n, s * split + split)
        lanes = []
        for lane in range(PL.PS_LANES):
            a = [np.zeros(PL.PS_COLS, dtype=f) for _ in range(PL.PS_ACC)]
            for base in range(r0, r1, PL.PS_ROW_STEP):
                for k in range(PL.PS_ACC):
                    r = base + PL.PS_LANES * k + lane
                    if r < r1:
                        a[k] = (a[k] + X[r]).astype(f)
            lanes.append(((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7])))
        t = lanes[0]
        for x in lanes[1:]:
            t = (t + x).astype(f)
        parts.append(t)
    return parts


@pytest.mark.parametrize("M,sms", [(1, 132), (37, 132), (513, 132), (3001, 4), (6000, 8)])
def test_pose_plain_is_the_kernels_order(M, sms):
    """pose_sum_ordered_plain equals a Python walk of the stated order bit
    for bit (several blocks: few SMs), += with acc, and is within 1e-5 of
    the f64 sum relative to the sum of |P|."""
    rng = np.random.default_rng(M)
    P = rng.normal(size=(M + 3, 256)).astype(np.float32)
    got = FF.pose_sum_ordered_plain(torch.as_tensor(P), M, sms=sms)
    lay = PL.pose_split(M, sms)
    parts = np.stack(_walk(P, M, lay["split"]))
    want = _walk(parts, lay["S"], lay["S"])[0]
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    f64 = P[:M].astype(np.float64).sum(0)
    assert np.abs(got.numpy() - f64).max() <= 1e-5 * np.abs(P[:M]).astype(np.float64).sum(0).max()
    ones = torch.ones(256)
    acc = FF.pose_sum_ordered_plain(torch.as_tensor(P), M, ones, 1, sms=sms)
    assert acc is ones and torch.equal(acc, 1.0 + got)


def test_pose_wrapper_on_the_cpu_writes_the_plain_sums():
    rng = np.random.default_rng(5)
    P = torch.as_tensor(rng.normal(size=(700, 256)).astype(np.float32))
    out = torch.full((256,), float("nan"))
    before = FF.POSE.launches
    FF.pose_sum(None, P, 650, out, 0, None, None)
    assert FF.POSE.launches == before
    assert torch.equal(out, FF.pose_sum_ordered_plain(P, 650))
    FF.pose_sum(None, P, 650, out, 1, None, None)
    assert torch.equal(out, FF.pose_sum_ordered_plain(P, 650) + FF.pose_sum_ordered_plain(P, 650))
    for args in ((P.double(), 650), (P[:, :128], 650), (P[:, ::2], 650), (P, 701), (P, -1),
                 (P.t().contiguous().t(), 650)):
        with pytest.raises(ValueError):
            FF.pose_sum(None, *args, out, 0, None, None)
    with pytest.raises(ValueError):   # an out that is not 256 f32
        FF.pose_sum(None, P, 650, torch.empty(128), 0, None, None)
