"""The f32 hand trunk in two launches (csrc/trunk_fused_f32.cu:
hand_trunk_fwd_f32_kernel, hand_uchain_f32_kernel, 3xTF32 on wgmma): their
layout arithmetic (honerf_torch/ops/wgmma_layout.py, the TF32_* names)
held against the source and against a K-major TF32 wgmma's operand
layout, a model of their barriers, a model of their sum order against
f64, a model of their phases and loads against the port's plain versions,
and the plain versions against the JAX package's f32 kernel (CPU).

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  Here:
  * the source's TF32_* constants are the helper's; each block's shared
    memory fits in the 232,448 bytes a block may use;
  * every element the epilogues write into a tile lands where the A
    fragments of the next phase read it, once; e's TMA box lands where
    they read it; the weights' boxes land where each consumer's B
    descriptor makes a K-major TF32 wgmma read them;
  * the tile map stores every row of a ragged M once;
  * `ring_schedule` with pairs (a consumer frees a K step's two slots
    once both landed) ends on the flagship's phase tables under random
    interleavings, and finds a planted deadlock (a ring of one slot);
  * a model of the kernels' sums (the tf32 split, a fresh accumulator
    each 32-deep step into which each k8 product adds truncating, the
    step's sum added with round to nearest) sits within 1e-6 of f64 on the
    flagship's layer shapes, and the same products summed into one
    accumulator drift farther;
  * `tf32_model`, the kernels' phases and the producer's boxes (tiles of
    64 points, two slots a K step, [big; small] rows of
    fused_fine.tf32_operands) in f64, equals trunk_fwd_plain and
    trunk_uchain_plain in f32 within 1e-5 of each output's range;
  * trunk_fwd_plain + trunk_uchain_plain in f32 agree with JAX's
    hand_trunk_sdf_u with TrunkMeta(dtype='f32') in interpret mode at
    1e-5 of the range;
  * on the CPU the wrappers write their plain versions' rows for an f32
    trunk and count no launch, and refuse e in another dtype.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine as JF
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import wgmma_layout as WL
from test_torch_parity import t

# the TF32_* constants live in the header both f32 trunk sources include
SOURCE = Path(WL.__file__).resolve().parent / "csrc" / "tf32.cuh"
FLAG = FT.TrunkMeta(emb_width=1386, d_hidden=256, n_layers=9, skip=4, d_out=257, dtype="f32")
ROWS = [1408, 256, 256, 256, 1664, 256, 256, 256, 256]
COLS = [256] * 8 + [320]

torch.set_num_threads(1)


def test_source_constants_are_the_helpers():
    env = {}
    for decl in re.findall(r"^constexpr int (TF32_\w+ =[^;]+);", SOURCE.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    assert set(env) == set(WL.TF32_CONSTANTS)
    for name in WL.TF32_CONSTANTS:
        assert env[name] == getattr(WL, name), name


def test_shared_memory_fits_one_block():
    """The forward: the 64 KB f32 activation tile and four 40 KB slots (e's
    8 KB box, 256 B rows x 32 k); the u-chain: two 64 KB t tiles and three
    32 KB slots.  Both under the 232,448 bytes, every operand on the
    swizzle's 1024-byte period."""
    for parts, total in ((WL.tf32_smem_bytes(), WL.TF32_SMEM_BYTES),
                         (WL.tf32_uc_smem_bytes(), WL.TF32_UC_SMEM_BYTES)):
        assert sum(parts.values()) == total <= WL.SMEM_LIMIT == 232448
    assert WL.TF32_SMEM_BYTES == 230464 and WL.TF32_UC_SMEM_BYTES == 230448
    for off in (WL.TF32_CHUNK_BYTES, WL.TF32_ACT_BYTES, WL.TF32_A_BYTES, WL.TF32_BOX_BYTES,
                WL.TF32_STAGE_BYTES, WL.TF32_UC_STAGE_BYTES, 32 * 128):
        assert off % 1024 == 0
    assert WL.TF32_B_BYTES == 4 * WL.TF32_BOX_BYTES and WL.THREADS == 384


def test_tile_writes_land_where_the_fragments_read():
    """Every (row, column) of a tile once: the epilogues' float2 stores
    (both consumers, 128 columns each, tf32_acc_cell) at tf32_offset; the
    A fragments of a 32-deep step read each element of a chunk once per
    consumer, from the same bytes; e's TMA box puts element (row, col) at
    the byte the fragment reads it from."""
    writes = {}
    for thread in range(256):
        for i in range(64):
            row, col = WL.tf32_acc_cell(thread, i, 128)
            addr = WL.tf32_offset(row, col)
            if i % 2:
                assert addr == writes[(row, col - 1)] + 4       # the pair's second float
            else:
                assert addr % 8 == 0
            assert (row, col) not in writes
            writes[(row, col)] = addr
    assert len(writes) == WL.TF32_TILE * WL.TF32_WIDTH == len(set(writes.values()))
    for c in (0, 1):
        reads = {}
        for thread in range(128 * c, 128 * c + 128):
            for kk in range(4):
                for q in range(4):
                    row, col = WL.tf32_frag_cell(thread, kk, q)
                    assert (row, col) not in reads
                    reads[(row, col)] = WL.tf32_offset(row, col)
        assert len(reads) == WL.TF32_TILE * WL.TF32_BK
        for (row, col), addr in reads.items():
            assert addr == WL.tf32_box_offset(row, col) == writes[(row, col)]


@pytest.mark.parametrize("nw", [128, 64, 32])
def test_b_boxes_land_where_wgmma_reads(nw):
    """A slot's B: boxes of 64 rows x 32 k from the slot's B base, read by
    consumer c through a K-major descriptor from row c * nw, 32 bytes on a
    k8 step (SBO 1024: 8 rows of 128 bytes)."""
    b = 0x8000 + WL.TF32_A_BYTES
    for c in (0, 1):
        for n in range(c * nw, c * nw + nw):
            for k in range(WL.TF32_BK):
                box = (b + (n // WL.TF32_BOX_ROWS) * WL.TF32_BOX_BYTES
                       + WL.tf32_box_offset(n % WL.TF32_BOX_ROWS, k))
                desc = WL.smem_desc(b + c * nw * 128 + 32 * (k // 8), WL.K_MAJOR_LBO, WL.SBO)
                assert WL.desc_fields(desc)["swizzle"] == 1
                assert WL.tf32_b_read(desc, n - c * nw, k % 8) == box


def test_phase_tables_of_the_flagship():
    """K steps of 32 a phase: layer 0 44 over e's boxes, the skip 8 over
    the tile then 44 over e's from B's k 256 (scaled), 8 for every other
    layer; z as pieces of 256 and 64; the recompute without the last layer.
    Two slots a K step, e's box in the small one; B's small rows from the
    layer's out_pad.  The u-chain: 7 chain layers, then 6 pieces of u (5
    of 256 columns, one of 128), two phases each."""
    z = WL.tf32_phases(1408, 256, ROWS, COLS, 4, n_store=257)
    assert [p["act_steps"] + p["e_steps"] for p in z] == [44, 8, 8, 8, 52, 8, 8, 8, 8, 8]
    assert [(p["n0"], p["width"]) for p in z[-2:]] == [(0, 256), (256, 64)]
    assert [p["scale"] for p in z].index(1) == 4 and z[4]["e_row0"] == 256
    assert len(WL.tf32_phases(1408, 256, ROWS, COLS, 4)) == 8
    assert [p["width"] for p in WL.tf32_phases(1408, 256, ROWS, COLS[:8] + [192], 4,
                                               n_store=192)[-2:]] == [128, 64]
    loads = WL.tf32_loads(z, 5, COLS)
    assert len(loads[4]) == 2 * 52
    assert loads[4][16] == ((0, 320), [(4, 256, 256 + 64 * j) for j in range(4)])   # small
    assert loads[4][17] == (None, [(4, 256, 64 * j) for j in range(4)])             # big
    assert loads[9][0] == (None, [(8, 0, 320 + 256)])
    uc = WL.tf32_uc_phases(9, 4, 256, 1408, True)
    assert [(p["layer"], p["src"], p["dst"]) for p in uc[:7]] == [
        (7, 0, 0), (6, 0, 0), (5, 0, 0), (4, 0, 1), (3, 1, 1), (2, 1, 1), (1, 1, 1)]
    assert len(uc) == 7 + 12 and [p["row0"] for p in uc[7:11]] == [256, 0, 512, 256]
    assert [p["width"] for p in uc[7::2]] == [256] * 5 + [128]
    ul = WL.tf32_uc_loads(uc, 256, ROWS)
    assert ul[7][0] == [(8192 * j, 4, 0, 1664 + 256 + 64 * j) for j in range(4)]
    assert ul[8][3] == [(8192 * j, 0, 32, 64 * j) for j in range(4)]
    assert ul[-1][1] == [(0, 0, 0, 1280), (8192, 0, 0, 1344)]
    assert all(p["dst"] == 0 for p in WL.tf32_uc_phases(9, 4, 256, 1408, False))
    for bad in (dict(Hp=192), dict(Ep=1400)):
        with pytest.raises(ValueError):
            WL.tf32_phases(bad.get("Ep", 1408), bad.get("Hp", 256), ROWS, COLS, 4)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 1001, 65613])
def test_tile_map_stores_every_row_once(M):
    """One persistent block an SM (at most 132, none idle), each walking
    its tiles of 64; per column the consumer that owns it (128 threads)
    stores rows r and r + 8 of each tile, masked to M: every point once."""
    blocks = WL.tf32_tile_rows(M)
    assert len(blocks) == min(132, -(-M // WL.TF32_TILE)) and all(blocks.values())
    stored = np.zeros(M, np.int64)
    for tiles in blocks.values():
        for tile in tiles:
            for thread in range(0, 128, 4):      # consumer 0's lanes of column pair 0
                for i in (0, 2):
                    row = tile * WL.TF32_TILE + WL.tf32_acc_cell(thread, i, 128)[0]
                    if row < M:
                        stored[row] += 1
    assert (stored == 1).all()


SLOTS = {"forward z": [88, 16, 16, 16, 104, 16, 16, 16, 16, 16],
         "recompute": [88, 16, 16, 16, 104, 16, 16, 16], "u-chain": [16] * 19,
         "u-chain keep": [16] * 7}


@pytest.mark.parametrize("name", list(SLOTS))
def test_ring_schedule_ends(name):
    """Four (forward) or three (u-chain) slots, 1-3 tiles a block, in turn
    and under random interleavings: no deadlock."""
    stages = WL.TF32_STAGES if "u-chain" not in name else WL.TF32_UC_STAGES
    for tiles in (1, 2, 3):
        for seed in (None, 0, 1, 2, 3):
            assert WL.ring_schedule(SLOTS[name], tiles, stages, seed=seed, pairs=True) > 0


@pytest.mark.parametrize("stages", [1, 2])
def test_ring_schedule_finds_a_planted_deadlock(stages):
    """A ring of one slot deadlocks: the producer waits for the small slot
    to be freed, which a consumer frees only once the big one landed; two
    slots end."""
    if stages == 1:
        with pytest.raises(RuntimeError, match="deadlock"):
            WL.ring_schedule(SLOTS["u-chain keep"], 1, stages, pairs=True)
    else:
        assert WL.ring_schedule(SLOTS["u-chain keep"], 2, stages, pairs=True, seed=1) > 0


# ---------------------------------------------------------------------------
# The kernels' sums
# ---------------------------------------------------------------------------

def _rz(v: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero (the tensor core's adds)."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def sum_model(x: torch.Tensor, w: torch.Tensor, fresh: bool = True) -> torch.Tensor:
    """x @ w as the f32 trunk kernels sum it: both split into TF32 big and
    small; each 32-deep step's k8 products big.small, small.big, big.big
    (each exact in f64) added into an f32 accumulator truncating; with
    `fresh` the accumulator starts at zero each step and is added to the
    running sum with round to nearest, else it runs over the whole K."""
    xb, xs = (p.double() for p in FH.split_tf32(x))
    wb, ws = (p.double() for p in FH.split_tf32(w))
    run = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    acc = torch.zeros_like(run)
    for k0 in range(0, x.shape[1], WL.TF32_BK):
        if fresh:
            acc = torch.zeros_like(run)
        ks = [slice(k0 + 8 * kk, k0 + 8 * kk + 8) for kk in range(4)]
        prods = ([xb[:, k] @ ws[k] for k in ks] + [xs[:, k] @ wb[k] for k in ks]
                 + [xb[:, k] @ wb[k] for k in ks])
        for p in prods:
            acc = _rz(acc.double() + p)
        if fresh:
            run = run + acc
    return run if fresh else acc


@pytest.mark.parametrize("K,N", [(1408, 256), (256, 256), (1664, 256), (256, 320),
                                 (256, 1408)], ids=["layer0", "hidden", "skip", "last", "u"])
def test_sum_model_is_within_1e6_of_f64(K, N):
    """Trunk-like operands (activations >= 0, weights with a positive mean,
    so truncation biases every add the same way): the kernels' order sits
    within 1e-6 of the f64 product in L2 (the f32 GEMMs read 2.5-3.0e-7 on
    the card); one accumulator over the whole K drifts at least 3x farther
    at the deep layers."""
    g = torch.Generator().manual_seed(K + N)
    x = torch.rand((128, K), generator=g)
    w = (torch.randn((K, N), generator=g) + 0.5) / K ** 0.5
    exact = x.double() @ w.double()
    rel = lambda y: float((y.double() - exact).norm() / exact.norm())  # noqa: E731
    fresh, one = rel(sum_model(x, w)), rel(sum_model(x, w, fresh=False))
    assert fresh <= 1e-6
    if K >= 1408:
        assert one >= 3 * fresh and one > 1e-6


# ---------------------------------------------------------------------------
# The kernels' phases and boxes against the plain versions
# ---------------------------------------------------------------------------

def _prod3(x: torch.Tensor, b_small: torch.Tensor, b_big: torch.Tensor) -> torch.Tensor:
    """One K step's three products in f64: x split, B's rows (N, 32) from
    the small and the big slot."""
    xb, xs = (p.double() for p in FH.split_tf32(x))
    return xb @ b_small.double().T + xs @ b_big.double().T + xb @ b_big.double().T


def tf32_model(e, m, ws, bs, tm):
    """(acts, ss, z, u, ts, cs) from the two kernels' tables: tiles of 64
    points, each phase's K steps from tf32_loads / tf32_uc_loads, B's rows
    from fused_fine.tf32_operands at the boxes' (k, row), e's box or the
    tile as A (x f32(1/sqrt2) at the skip), the seed, the chain into two t
    tiles, u's pieces as u = f32(m_skip / sqrt2), then u + m_0; sums in
    f64, the elementwise functions in f32 as the plain versions."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    E = e[:m].float()
    rows, cols = [w.shape[0] for w in ws], [w.shape[1] for w in ws]
    fwd = [FT.tf32_operands(w, True) for w in ws]
    ucw = [FT.tf32_operands(w, False) for w in ws[:n - 1]]
    tiles = range(-(-m // WL.TF32_TILE))
    act = torch.zeros((m, Hp))
    acts, ss = [], []
    z = torch.zeros((m, cols[-1]))

    def box(op, boxes):
        return torch.cat([op[b[-1]:b[-1] + 64, b[-2]:b[-2] + 32] for b in boxes], 0)

    for ph in WL.tf32_phases(Ep, Hp, rows, cols, tm.skip, n_store=cols[-1]):
        acc = torch.zeros((m, ph["width"]), dtype=torch.float64)
        for tile in tiles:
            r = slice(tile * WL.TF32_TILE, min(m, (tile + 1) * WL.TF32_TILE))
            slots = WL.tf32_loads([ph], tile, cols)[0]
            for k in range(0, len(slots), 2):
                (a, small), (_, big) = slots[k], slots[k + 1]
                x = act[r, 16 * k:16 * k + 32] if a is None else E[r, a[0]:a[0] + 32]
                if ph["scale"]:
                    x = x * FT.INV_SQRT2
                acc[r] += _prod3(x, box(fwd[ph["layer"]], small), box(fwd[ph["layer"]], big))
        y = acc.float() + bs[ph["layer"]][ph["n0"]:ph["n0"] + ph["width"]]
        if ph["kind"] == WL.T32_HIDDEN:
            ss.append(torch.sigmoid(FT.BETA * y))
            act = FT._softplus_beta(y)
            acts.append(act)
        else:
            z[:, ph["n0"]:ph["n0"] + ph["width"]] = y[:, :cols[-1] - ph["n0"]]
    tt = [ws[n - 1][:Hp, 0] * ss[n - 2], None]
    ts, cs = {n - 2: tt[0]}, {}
    u = torch.zeros((m, Ep))
    phases = WL.tf32_uc_phases(n, tm.skip, Hp, Ep, True)
    loads = WL.tf32_uc_loads(phases, Hp, rows)
    for ph, slots in zip(phases, loads):
        acc = torch.zeros((m, ph["width"]), dtype=torch.float64)
        for k in range(0, len(slots), 2):
            x = tt[ph["src"]][:, 16 * k:16 * k + 32]
            acc += _prod3(x, box(ucw[ph["layer"]], slots[k]), box(ucw[ph["layer"]],
                                                                 slots[k + 1]))
        acc = acc.float()
        l = ph["layer"]
        if ph["kind"] == "chain":
            c = acc * (FT.INV_SQRT2 if l == tm.skip else 1.0)
            cs[l] = c
            tt[ph["dst"]] = ts[l - 1] = c * ss[l - 1]
        elif ph["kind"] == "skip":
            n0 = ph["row0"] - Hp
            u[:, n0:n0 + ph["width"]] = acc * FT.INV_SQRT2
        else:
            u[:, ph["row0"]:ph["row0"] + ph["width"]] += acc
    return acts, ss, z, u, ts, cs


def _pack(tm, seed):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32))
          for s in FT._dims(tm)]
    bs = [torch.from_numpy((rng.normal(size=s[1]) * 0.05).astype(np.float32))
          for s in FT._dims(tm)]
    return FT.pack_trunk_weights(ws, bs, tm)


def _close(got, want, tol=1e-5):
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("tm,m", [(FLAG, 130), (FT.TrunkMeta(90, 64, 5, 2, 17, "f32"), 70),
                                  (FT.TrunkMeta(200, 128, 6, 3, 65, "f32"), 64)],
                         ids=["flagship", "small", "narrow"])
def test_model_equals_plain(tm, m):
    pack = _pack(tm, 3)
    g = torch.Generator().manual_seed(4)
    e = FT._e_block(tm, torch.rand((m, tm.emb_width), generator=g) * 2 - 1)
    acts, ss, z, u, ts, cs = tf32_model(e, m, pack.ws, pack.bs, tm)
    p_acts, p_ss, p_z = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm)
    p_u, p_ts, p_cs = FT.trunk_uchain_plain(p_ss, pack.ws, tm)
    assert float(u.abs().max()) > 0 and float(z.abs().max()) > 0
    _close(z, p_z)
    _close(u, p_u)
    for l in range(tm.n_layers - 1):
        _close(acts[l], p_acts[l])
        _close(ss[l], p_ss[l], 1e-4)      # sigmoid(100 z): a slope of up to 25
        _close(ts[l], p_ts[l])
        if l:
            _close(cs[l], p_cs[l])


def test_tf32_operands_split_once_and_follow_writes():
    """[big; small] of w or w^T, both TF32 (low 13 bits clear), big + small
    within 2^-22 of w; kept on the tensor, made anew after a write."""
    w = torch.randn((96, 64))
    for transpose in (False, True):
        rows = FT.tf32_operands(w, transpose)
        x = w.T if transpose else w
        big, small = rows[:x.shape[0]], rows[x.shape[0]:]
        assert not (rows.view(torch.int32) & 0x1FFF).any()
        assert float((big.double() + small.double() - x.double()).abs().max()) <= 2 ** -22 * float(
            x.abs().max())
        assert FT.tf32_operands(w, transpose) is rows
    w.mul_(2.0)
    assert torch.equal(FT.tf32_operands(w, False)[:96], FH.tf32_round(w))


# ---------------------------------------------------------------------------
# The plain versions against the JAX package, and the CPU wrappers
# ---------------------------------------------------------------------------

def test_trunk_plain_f32_matches_jax_kernel():
    """trunk_fwd_plain then trunk_uchain_plain (out, u) in f32 against
    JAX's hand_trunk_sdf_u with TrunkMeta(dtype='f32') in interpret mode at
    test_fused_fine.py's META: within 1e-5 of the range."""
    dims = dict(emb_width=30, d_hidden=16, n_layers=5, skip=2, d_out=17)
    tm, jm = FT.TrunkMeta(**dims, dtype="f32"), JF.TrunkMeta(**dims, dtype="f32")
    rng = np.random.default_rng(0)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for s in FT._dims(tm)]
    bs = [(rng.normal(size=s[1]) * 0.05).astype(np.float32) for s in FT._dims(tm)]
    e = rng.normal(size=(40, 30)).astype(np.float32)
    want = JF.hand_trunk_sdf_u(jnp.asarray(e), tuple(map(jnp.asarray, ws)),
                               tuple(map(jnp.asarray, bs)), jm, 32, True)
    pack = FT.pack_trunk_weights([t(w) for w in ws], [t(b) for b in bs], tm)
    eb = FT._e_block(tm, t(e))
    _, ss, z = FT.trunk_fwd_plain(eb, 40, pack.ws, pack.bs, tm)
    u, _, _ = FT.trunk_uchain_plain(ss, pack.ws, tm)
    for got, w in ((z[:, :17], want[0]), (u[:, :30], want[1])):
        err = np.abs(got.numpy() - np.asarray(w))
        assert err.max() <= 1e-5 * float(np.abs(np.asarray(w)).max())


def test_cpu_wrappers_write_plain_rows_and_count_nothing():
    tm = FT.TrunkMeta(90, 64, 5, 2, 17, "f32")
    pack = _pack(tm, 5)
    e = FT._e_block(tm, torch.rand((50, 90)) * 2 - 1)
    n, nan = tm.n_layers, float("nan")
    ss = torch.full((n - 1, 60, tm.Hp), nan)
    acts = [torch.zeros((60, tm.Hp)) for _ in range(n - 1)]
    z, u = torch.zeros((60, 17)), torch.zeros((60, tm.Ep))
    ts = [torch.zeros((60, tm.Hp)) for _ in range(n - 1)]
    cs = [None] + [torch.zeros((60, tm.Hp)) for _ in range(n - 2)]
    before = (FT.TRUNK_FWD_F32.launches, FT.TRUNK_UCHAIN_F32.launches, FT.TRUNK_FWD.launches)
    FT.trunk_fwd(e, 50, pack.ws, pack.bs, tm, ss=ss, acts=acts, z=z)
    FT.trunk_uchain(50, pack.ws, None, tm, ss, u=u, ts=ts, cs=cs)
    assert (FT.TRUNK_FWD_F32.launches, FT.TRUNK_UCHAIN_F32.launches,
            FT.TRUNK_FWD.launches) == before
    p_acts, p_ss, p_z = FT.trunk_fwd_plain(e, 50, pack.ws, pack.bs, tm)
    p_u, p_ts, p_cs = FT.trunk_uchain_plain(p_ss, pack.ws, tm)
    assert torch.equal(z[:50], p_z[:, :17]) and torch.equal(u[:50], p_u)
    assert all(torch.equal(ss[l, :50], p_ss[l]) for l in range(n - 1))
    assert all(torch.equal(acts[l][:50], p_acts[l]) for l in range(n - 1))
    assert torch.equal(ts[1][:50], p_ts[1]) and torch.equal(cs[2][:50], p_cs[2])
    for bad in (e.to(torch.bfloat16), e):
        with pytest.raises(ValueError):       # bf16 e; an sdf column of an f32 trunk
            FT.trunk_fwd(bad, 50, pack.ws, pack.bs, tm, sdf=torch.zeros(60))
