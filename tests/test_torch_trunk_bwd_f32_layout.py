"""The f32 hand trunk's backward in two launches (csrc/trunk_bwd_f32.cu:
hand_trunk_ut_f32_kernel, the u-chain transposed upward, and
hand_trunk_dz_f32_kernel, the forward transposed downward, 3xTF32 on
wgmma): their layout arithmetic (honerf_torch/ops/wgmma_layout.py, the
tb32_* helpers and TB32_* names) held against the source, a model of
their barriers, a model of their phases, boxes and sums against the
port's plain versions, and the plain versions against the JAX package's
`_trunk_bwd_block` (CPU).

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  Here:
  * the source's TB32_* constants are the helper's; both kernels launch
    with the forward's shared memory (the tile and a 4-slot ring), within
    the 232,448 bytes a block may use;
  * the flagship's phase tables: the upward chain's 8 layers (44, 8, 8, 8,
    52, 8, 8, 8 K steps, du_b's boxes at layer 0, du_s's at the skip),
    the downward chain's 8 layers (10 K steps over the top cotangent's
    boxes, 8 each after), de's 6 pieces (5 of 256 columns, one of 128),
    their skip parts before the skip's chain layer and their layer-0
    parts at the end, and the producer's boxes;
  * A's boxes cover du (layer 0, the skip) and the top cotangent once a
    tile, at the tile's rows;
  * `ring_schedule` with pairs ends on both tables under random
    interleavings and finds a planted deadlock (a ring of one slot);
  * the tile map stores every row once at M = 1 to 65,613, and de's
    pieces every column once;
  * `tb32_model`, the kernels' tables in f64 on the tf32 split (fresh sums
    a step), equals trunk_ut_plain / trunk_dz_plain in f32 within 1e-5 of
    each output's range;
  * trunk_ut_plain + trunk_dz_plain in f32 (de, and with want_dw every dW
    and db formed from their kept rows) agree with JAX's `_trunk_bwd_block`
    at a small f32 TrunkMeta within 1e-5 of the range, and so do the
    port's f32 K6 (hand_trunk_sdf_u_bwd) and the trunk backward inside its
    f32 K3 (hand_fine_color_bwd), both on the CPU;
  * on the CPU the wrappers write their plain versions' rows and count no
    launch, and refuse a bf16 trunk.
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

CSRC = Path(WL.__file__).resolve().parent / "csrc"
SOURCE = CSRC / "trunk_bwd_f32.cu"
FLAG = FT.TrunkMeta(emb_width=1386, d_hidden=256, n_layers=9, skip=4, d_out=257, dtype="f32")
IN_COLS = [1408, 256, 256, 256, 1664, 256, 256, 256, 256]

torch.set_num_threads(1)


def _constants(path: Path, env: dict) -> dict:
    for decl in re.findall(r"^constexpr int (\w+ =[^;]+);", path.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_source_constants_are_the_helpers():
    shared = _constants(CSRC / "tf32.cuh", {})
    env = _constants(SOURCE, dict(shared))
    mine = {k for k in env if k not in shared}
    assert mine == set(WL.TB32_CONSTANTS)
    for name in WL.TB32_CONSTANTS:
        assert env[name] == getattr(WL, name), name


def test_shared_memory_fits_one_block():
    """Both kernels launch with the forward's layout (the 64 KB tile, four
    40 KB slots: A's 8 KB box and 256 B rows x 32 k) under the 232,448
    bytes, every operand on the swizzle's 1024-byte period."""
    src = SOURCE.read_text()
    assert "kernel<<<grid, wg::THREADS, TF32_SMEM_BYTES, stream>>>(p);" in src
    assert "t32_smem_ready((const void*)kernel, TF32_SMEM_BYTES, smem_set)" in src
    for name in ("hand_trunk_ut_f32_kernel", "hand_trunk_dz_f32_kernel"):
        assert f"tb32_launch({name}, p, stream, smem_set)" in src
    parts = WL.tf32_smem_bytes()
    assert sum(parts.values()) == WL.TF32_SMEM_BYTES == 230464 <= WL.SMEM_LIMIT
    for off in (WL.TF32_ACT_BYTES, WL.TF32_A_BYTES, WL.TF32_STAGE_BYTES):
        assert off % 1024 == 0


def test_phase_tables_of_the_flagship():
    """Upward: one phase a layer below the last, K steps of 32 (layer 0
    over du_b's 44 boxes, the skip 8 over the tile then 44 over du_s's from
    B's k 256), two slots a K step, the box in the small one, B's small
    rows from Hp.  Downward: the top's 10 K steps over the top cotangent's
    boxes, the chain layers' 8 over the tile; de in 6 pieces (5 of 256
    columns, one of 128), the skip's parts (W_skip's rows from 256 + n0)
    just before the skip's chain layer, layer 0's (W_0's rows from n0)
    after layer 1."""
    up = WL.tb32_ut_phases(1408, 256, IN_COLS[:8], 4)
    assert [p["act_steps"] + p["box_steps"] for p in up] == [44, 8, 8, 8, 52, 8, 8, 8]
    assert [(p["box"], p["box_k0"]) for p in up if p["box_steps"]] == [(0, 0), (1, 256)]
    loads = WL.tb32_loads(up, 3, [256] * 8)
    assert loads[0][0] == ((0, 0, 192), [(0, 0, 256 + 64 * j) for j in range(4)])
    assert loads[0][1] == (None, [(0, 0, 64 * j) for j in range(4)])
    assert loads[4][15] == (None, [(4, 224, 64 * j) for j in range(4)])          # the tile
    assert loads[4][16] == ((1, 0, 192), [(4, 256, 256 + 64 * j) for j in range(4)])
    assert len(loads[4]) == 2 * 52 and len(loads[7]) == 16
    down = WL.tb32_dz_phases(9, 4, 256, 1408, 320)
    assert len(down) == 8 + 12 <= WL.TB32_MAX_PHASES
    assert [p["act_steps"] + p["box_steps"] for p in down] == [10] + [8] * 19
    assert [(p["kind"], p["layer"]) for p in down] == (
        [(WL.TB32_CHAIN, l) for l in (8, 7, 6, 5)] + [(WL.TB32_SKIP, 4)] * 6
        + [(WL.TB32_CHAIN, l) for l in (4, 3, 2, 1)] + [(WL.TB32_ZERO, 0)] * 6)
    assert [(p["row0"], p["width"]) for p in down[4:10]] == (
        [(256 + 256 * i, 256) for i in range(5)] + [(256 + 1280, 128)])
    assert [(p["row0"], p["width"]) for p in down[14:]] == (
        [(256 * i, 256) for i in range(5)] + [(1280, 128)])
    dl = WL.tb32_loads(down, 2, IN_COLS)
    assert dl[0][0] == ((0, 0, 128), [(8, 0, 256 + 64 * j) for j in range(4)])   # the top's
    assert dl[0][19] == (None, [(8, 288, 64 * j) for j in range(4)])             # last big
    assert dl[4][0] == (None, [(4, 0, 1664 + 256 + 64 * j) for j in range(4)])
    assert dl[-1][1] == (None, [(0, 0, 1280), (0, 0, 1344)])
    for bad in (dict(Hp=192), dict(Ep=1400), dict(Op=300)):
        with pytest.raises(ValueError):
            WL.tb32_dz_phases(9, 4, bad.get("Hp", 256), bad.get("Ep", 1408), bad.get("Op", 320))
    with pytest.raises(ValueError):
        WL.tb32_ut_phases(1408, 256, IN_COLS[:4] + [1600] + IN_COLS[5:8], 4)


@pytest.mark.parametrize("tile", [0, 5])
def test_boxes_cover_a_once_a_tile(tile):
    """Each box step's A box lands in its K step's small slot (never the big
    one), at the tile's first row: du_b's boxes over Ep once at layer 0,
    du_s's once at the skip, the top cotangent's over Op once at the top
    layer; no other phase loads one."""
    up = WL.tb32_ut_phases(1408, 256, IN_COLS[:8], 4)
    down = WL.tb32_dz_phases(9, 4, 256, 1408, 320)
    for phases, rows, want in ((up, [256] * 8, {0: (0, 1408), 4: (1, 1408)}),
                               (down, IN_COLS, {0: (0, 320)})):
        for q, slots in enumerate(WL.tb32_loads(phases, tile, rows)):
            boxes = [a for a, _ in slots if a is not None]
            assert all(a is None for a, _ in slots[1::2])
            if q not in want:
                assert not boxes
                continue
            box, width = want[q]
            assert sorted(b[1] for b in boxes) == list(range(0, width, 32))
            assert {(b[0], b[2]) for b in boxes} == {(box, 64 * tile)}


SLOTS = {"up": [88, 16, 16, 16, 104, 16, 16, 16], "down": [20] + [16] * 19}


@pytest.mark.parametrize("name", list(SLOTS))
def test_ring_schedule_ends(name):
    """Four slots, 1-3 tiles a block, in turn and under random
    interleavings: no deadlock."""
    stages = WL.TF32_STAGES
    for tiles in (1, 2, 3):
        for seed in (None, 0, 1, 2, 3):
            assert WL.ring_schedule(SLOTS[name], tiles, stages, seed=seed, pairs=True) > 0


def test_ring_schedule_finds_a_planted_deadlock():
    with pytest.raises(RuntimeError, match="deadlock"):
        WL.ring_schedule(SLOTS["down"], 1, 1, pairs=True)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 1001, 65613])
def test_tile_map_stores_every_row_once(M):
    """One persistent block an SM, each walking its tiles of 64; each
    consumer stores rows r and r + 8 of a tile masked to M (every point
    once), and de's pieces (both consumers, nw columns each from n0) every
    column of Ep once."""
    blocks = WL.tf32_tile_rows(M)
    assert len(blocks) == min(132, -(-M // WL.TF32_TILE))
    stored = np.zeros(M, np.int64)
    for tiles in blocks.values():
        for tile in tiles:
            for thread in range(0, 128, 4):
                for i in (0, 2):
                    row = tile * WL.TF32_TILE + WL.tf32_acc_cell(thread, i, 128)[0]
                    if row < M:
                        stored[row] += 1
    assert (stored == 1).all()
    cells = np.zeros((WL.TF32_TILE, 1408), np.int64)
    for ph in WL.tb32_dz_phases(9, 4, 256, 1408, 320):
        if ph["kind"] == WL.TB32_ZERO:
            nw = ph["width"] // 2
            for thread in range(256):
                for i in range(nw // 2):
                    row, col = WL.tf32_acc_cell(thread, i, nw)
                    cells[row, ph["row0"] + col] += 1
    assert (cells == 1).all()


# ---------------------------------------------------------------------------
# The kernels' tables and sums against the plain versions
# ---------------------------------------------------------------------------

def _prod3(x: torch.Tensor, b_small: torch.Tensor, b_big: torch.Tensor) -> torch.Tensor:
    """One K step's three products in f64: x split, B's rows (N, 32) from
    the small and the big slot."""
    xb, xs = (p.double() for p in FH.split_tf32(x))
    return xb @ b_small.double().T + xs @ b_big.double().T + xb @ b_big.double().T


def _box(op, boxes):
    return torch.cat([op[b[-1]:b[-1] + 64, b[-2]:b[-2] + 32] for b in boxes], 0)


def tb32_model(du, top, m, ws, ss, cs, c_last, tm):
    """(ds, dms, de, dzs) from the two kernels' tables: each phase's K steps
    from tb32_loads, B's rows from fused_fine.tf32_operands at the boxes'
    (k, row), A from its boxes (du_b, du_s; the top cotangent) or the tile,
    the chain in place in the one tile, de's pieces as de = f32(sum /
    sqrt2), then de + sum; sums in f64, the epilogues in f32 as the plain
    versions."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    C = [None] + [c[:m] for c in cs[1:n - 1]] + [c_last]

    def run(phases, ops, boxes, small_rows, epilogue):
        tile = torch.zeros((m, Hp))
        for ph, slots in zip(phases, WL.tb32_loads(phases, 0, small_rows)):
            acc = torch.zeros((m, ph["width"]), dtype=torch.float64)
            for k in range(0, len(slots), 2):
                (a, small), (_, big) = slots[k], slots[k + 1]
                x = tile[:, 16 * k:16 * k + 32] if a is None else boxes[a[0]][:, a[1]:a[1] + 32]
                acc += _prod3(x, _box(ops[ph["layer"]], small), _box(ops[ph["layer"]], big))
            new = epilogue(ph, acc.float())
            if new is not None:
                tile = new

    ds, dms = [], [None]

    def up(ph, dt):
        l = ph["layer"]
        ds.append(dt * C[l + 1])
        dms.append((dt * ss[l][:m]) * (FT.INV_SQRT2 if l + 1 == tm.skip else 1.0))
        return dms[-1]

    run(WL.tb32_ut_phases(Ep, Hp, [w.shape[0] for w in ws[:n - 1]], tm.skip),
        [FT.tf32_operands(w, True) for w in ws[:n - 1]],
        [du[:m], du[:m] * FT.INV_SQRT2], [Hp] * (n - 1), up)
    de = torch.zeros((m, Ep))
    dzs = [None] * (n - 1)

    def down(ph, acc):
        l = ph["layer"]
        if ph["kind"] == WL.TB32_CHAIN:
            s = ss[l - 1][:m]
            da = acc * (FT.INV_SQRT2 if l == tm.skip else 1.0)
            dzs[l - 1] = da * s + ds[l - 1] * (FT.BETA * s * (1.0 - s))
            return dzs[l - 1]
        if ph["kind"] == WL.TB32_SKIP:
            n0 = ph["row0"] - Hp
            de[:, n0:n0 + ph["width"]] = acc * FT.INV_SQRT2
        else:
            de[:, ph["row0"]:ph["row0"] + ph["width"]] += acc
        return None

    run(WL.tb32_dz_phases(n, tm.skip, Hp, Ep, tm.Op), [FT.tf32_operands(w, False) for w in ws],
        [top[:m]], [w.shape[0] for w in ws], down)
    return ds, dms, de, dzs


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


def _chain_inputs(tm, pack, m, seed=4):
    """The forward's sigmoid rows and the u-chain's c rows at m seeded
    points (the plain versions), and seeded cotangents du (Ep) and top (Op)."""
    g = torch.Generator().manual_seed(seed)
    e = FT._e_block(tm, torch.rand((m, tm.emb_width), generator=g) * 2 - 1)
    _, ss, _ = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm, last=False)
    _, _, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    du = FT._e_block(tm, torch.randn((m, tm.emb_width), generator=g))
    top = torch.nn.functional.pad(torch.randn((m, tm.d_out), generator=g), (0, tm.Op - tm.d_out))
    n = tm.n_layers
    return ss, [None] + cs[1:n - 1], pack.ws[n - 1][:, 0].contiguous(), du, top


@pytest.mark.parametrize("tm,m", [(FLAG, 130), (FT.TrunkMeta(90, 64, 5, 2, 17, "f32"), 70),
                                  (FT.TrunkMeta(200, 128, 6, 3, 65, "f32"), 64)],
                         ids=["flagship", "small", "narrow"])
def test_model_equals_plain(tm, m):
    pack = _pack(tm, 3)
    ss, cs, c_last, du, top = _chain_inputs(tm, pack, m)
    ds, dms, de, dzs = tb32_model(du, top, m, pack.ws, ss, cs, c_last, tm)
    p_ds, p_dms = FT.trunk_ut_plain(du, du * FT.INV_SQRT2, m, pack.ws, ss, cs + [c_last], tm,
                                    keep=True)
    p_de, p_dzs = FT.trunk_dz_plain(top, m, pack.ws, ss, p_ds, tm, keep=True)
    assert float(de.abs().max()) > 0
    _close(de, p_de)
    for l in range(tm.n_layers - 1):
        _close(ds[l], p_ds[l])
        _close(dms[l + 1], p_dms[l + 1])
        _close(dzs[l], p_dzs[l])


# ---------------------------------------------------------------------------
# The plain versions against the JAX package, and the CPU wrappers
# ---------------------------------------------------------------------------

DIMS = dict(emb_width=30, d_hidden=16, n_layers=5, skip=2, d_out=17)


def _jax_unpad(dws, dbs, jm):
    """JAX's padded dW / db (rows [Hp | Ep] at the skip, Hp a multiple of
    128) -> the unpadded (in, out) gradients."""
    H, E, Hp = jm.d_hidden, jm.emb_width, -(-jm.d_hidden // 128) * 128
    out_w, out_b = [], []
    for l, (dw, db, (d_in, d_out)) in enumerate(zip(dws, dbs, JF._dims(jm))):
        dw = np.asarray(dw)
        if l == jm.skip:
            dw = np.concatenate([dw[:H], dw[Hp:Hp + E]], 0)
        out_w.append(dw[:d_in, :d_out])
        out_b.append(np.asarray(db).reshape(-1)[:d_out])
    return out_w, out_b


def _jax_block(jm, ws, bs, e, dout, du, want_dw):
    """JAX's _trunk_bwd_block on one block of unpadded numpy inputs (its
    own padding, the forward recomputed): de (B, E) and the unpadded dW /
    db."""
    wps, bps = JF._pad_weights(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), jm)
    Ep, Op = -(-jm.emb_width // 128) * 128, -(-jm.d_out // 128) * 128
    pad = lambda x, w: jnp.pad(jnp.asarray(x), ((0, 0), (0, w - x.shape[1])))  # noqa: E731
    de, dws, dbs = JF._trunk_bwd_block(jm, pad(e, Ep), pad(dout, Op), pad(du, Ep), wps, bps,
                                       None, want_dw)
    de = np.asarray(de)[:, :jm.emb_width]
    return (de, None, None) if not want_dw else (de, *_jax_unpad(dws, dbs, jm))


def _assert_jax_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()), 1e-6)


@pytest.mark.parametrize("want_dw", [True, False], ids=["dw", "frozen"])
def test_plain_chains_match_jax_block(want_dw):
    """trunk_ut_plain then trunk_dz_plain in f32 at DIMS (E 30, H 16, 5
    layers, skip 2, d_out 17) on seeded numpy inputs, de and (want_dw)
    every dW_l = dm_l^T t_l + in_l^T dz_l and db_l = sum dz_l formed from
    their kept rows, against JAX's _trunk_bwd_block (f32, its own padding,
    the forward recomputed) within 1e-5 of each output's range: both sum
    the same f32 products in another order."""
    tm, jm = FT.TrunkMeta(**DIMS, dtype="f32"), JF.TrunkMeta(**DIMS, dtype="f32")
    rng = np.random.default_rng(0)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for s in FT._dims(tm)]
    bs = [(rng.normal(size=s[1]) * 0.05).astype(np.float32) for s in FT._dims(tm)]
    B, n = 40, tm.n_layers
    e, dout, du = (rng.normal(size=(B, w)).astype(np.float32) for w in (30, 17, 30))
    pack = FT.pack_trunk_weights([t(w) for w in ws], [t(b) for b in bs], tm)
    eb = FT._e_block(tm, t(e))
    _, _, ss, ins, ts, cs = FT._kernel_fwd_body(tm, eb, pack.ws, pack.bs, residuals=True)
    du_p = torch.nn.functional.pad(t(du), (0, tm.Ep - 30))
    top = torch.nn.functional.pad(t(dout), (0, tm.Op - 17))
    ds, dms = FT.trunk_ut_plain(du_p, du_p * FT.INV_SQRT2, B, pack.ws, ss, cs, tm, keep=want_dw)
    de, dzs = FT.trunk_dz_plain(top, B, pack.ws, ss, ds, tm, keep=want_dw)
    want = _jax_block(jm, ws, bs, e, dout, du, want_dw)
    _assert_jax_close(de[:, :30], want[0])
    if not want_dw:
        return
    dws, dbs = [], []
    for l in range(n):
        dm = du_p if l == 0 else (torch.cat([dms[l], du_p * FT.INV_SQRT2], 1) if l == tm.skip
                                  else dms[l])
        dws.append(dm.T @ ts[l] + ins[l].T @ dzs[l])
        dbs.append(dzs[l].sum(0))
    got_w, got_b = FT.unpad_trunk_grads(dws, dbs, tm, FT._dims(tm))
    for a, b in zip(got_w + got_b, want[1] + want[2]):
        _assert_jax_close(a, b)


@pytest.mark.parametrize("want_dw", [True, False], ids=["dw", "frozen"])
def test_k6_f32_matches_jax_block(want_dw):
    """The port's f32 K6 on the CPU (hand_trunk_sdf_u_bwd: the forward
    recomputed, then _trunk_bwd_block on the two plain chains) against
    JAX's _trunk_bwd_block at the same inputs, within 1e-5 of the range."""
    tm, jm = FT.TrunkMeta(**DIMS, dtype="f32"), JF.TrunkMeta(**DIMS, dtype="f32")
    rng = np.random.default_rng(1)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for s in FT._dims(tm)]
    bs = [(rng.normal(size=s[1]) * 0.05).astype(np.float32) for s in FT._dims(tm)]
    e, dout, du = (rng.normal(size=(40, w)).astype(np.float32) for w in (30, 17, 30))
    pack = FT.pack_trunk_weights([t(w) for w in ws], [t(b) for b in bs], tm)
    got = FT.hand_trunk_sdf_u_bwd(t(e), pack, t(dout), t(du), want_dw)
    want = _jax_block(jm, ws, bs, e, dout, du, want_dw)
    _assert_jax_close(got[0], want[0])
    if want_dw:
        got_w, got_b = FT.unpad_trunk_grads(got[1], got[2], tm, FT._dims(tm))
        for a, b in zip(got_w + got_b, want[1] + want[2]):
            _assert_jax_close(a, b)
    else:
        assert got[1] is None and got[2] is None


def test_k3_f32_trunk_backward_matches_jax_block():
    """The trunk backward inside the port's f32 K3 on the CPU
    (hand_fine_color_bwd with an f32 pack, its block's _trunk_bwd_block
    recorded at the cotangents the color net and the reverse chain hand
    it) against JAX's _trunk_bwd_block on the same unpadded e, dout, du and
    weights, within 1e-5 of the range."""
    from honerf_torch.models.fields import pack_fine_color
    from honerf_torch.ops import fused_fine_full as FF
    from test_torch_parity import SMALL, configs, points_near
    from torch_fit_common import hand_nets, hand_pose_np

    _, _, tcfg, tccfg = configs(SMALL, "f32")
    _, tp = hand_nets(SMALL)
    pack = pack_fine_color(tp, tcfg, tccfg)
    tm = pack.meta.trunk_meta
    bt, tpose, joints = hand_pose_np()
    rotT, off, cut = FH.pack_hand_pose(t(bt), t(tpose))
    pts = t(points_near(joints, 24, seed=6))
    rng = np.random.default_rng(3)
    cts = [t(rng.normal(size=s).astype(np.float32)) for s in ((24,), (24, 3), (24, 3))]
    seen, block = [], FT._trunk_bwd_block

    def rec(tm_, dout, du, ws, fwd, want_dw=True):
        out = block(tm_, dout, du, ws, fwd, want_dw)
        seen.append((dout, du, fwd[1][0], out))
        return out

    FT._trunk_bwd_block = rec
    try:
        FF.hand_fine_color_bwd(pts, rotT, off, cut, pack, *cts)
    finally:
        FT._trunk_bwd_block = block
    assert seen
    H, E, Hp, n = tm.d_hidden, tm.emb_width, tm.Hp, tm.n_layers
    jm = JF.TrunkMeta(E, H, n, tm.skip, tm.d_out, "f32")
    ws, bs = [], []
    for l, (w, b, (d_in, d_out)) in enumerate(zip(pack.ws, pack.bs, FT._dims(tm))):
        if l == tm.skip:
            w = torch.cat([w[:H], w[Hp:Hp + E]], 0)
        ws.append(w[:d_in, :d_out].numpy())
        bs.append(b[:d_out].numpy())
    for dout, du, e, (de, dws, dbs) in seen:
        want = _jax_block(jm, ws, bs, e[:, :E].numpy(), dout[:, :tm.d_out].numpy(),
                          du[:, :E].numpy(), True)
        _assert_jax_close(de[:, :E], want[0])
        got_w, got_b = FT.unpad_trunk_grads(dws, dbs, tm, FT._dims(tm))
        for a, b in zip(got_w + got_b, want[1] + want[2]):
            _assert_jax_close(a, b)


def test_cpu_wrappers_write_plain_rows_and_count_nothing():
    tm = FT.TrunkMeta(90, 64, 5, 2, 17, "f32")
    pack = _pack(tm, 5)
    m, C, n, nan = 50, 60, tm.n_layers, float("nan")
    ss_l, cs, c_last, du, top = _chain_inputs(tm, pack, C)
    ss = torch.stack(ss_l)
    du_s = du * FT.INV_SQRT2
    ds = torch.full((n - 1, C, tm.Hp), nan)
    de = torch.full((C, tm.Ep), nan)
    dms = [None] + [torch.full((C, tm.Hp), nan) for _ in range(n - 1)]
    dzs = [torch.full((C, tm.Hp), nan) for _ in range(n - 1)]
    before = (FT.TRUNK_UT_F32.launches, FT.TRUNK_DZ_F32.launches, FH.GEMM_F32.launches)
    FT.trunk_ut(m, pack.ws, tm, du, du_s, ss, cs, c_last, ds, dms)
    FT.trunk_dz(m, pack.ws, tm, top, ss, ds, de, dzs)
    assert (FT.TRUNK_UT_F32.launches, FT.TRUNK_DZ_F32.launches, FH.GEMM_F32.launches) == before
    rows = [None] + [c[:m] for c in cs[1:]] + [c_last]
    p_ds, p_dms = FT.trunk_ut_plain(du, du_s, m, pack.ws, ss, rows, tm, keep=True)
    p_de, p_dzs = FT.trunk_dz_plain(top, m, pack.ws, ss, ds, tm, keep=True)
    assert torch.equal(de[:m], p_de) and torch.isnan(de[m:]).all()
    for l in range(n - 1):
        assert torch.equal(ds[l, :m], p_ds[l]) and torch.equal(dms[l + 1][:m], p_dms[l + 1])
        assert torch.equal(dzs[l][:m], p_dzs[l])
    for bad in (tm._replace(dtype="bf16"), tm._replace(d_hidden=192)):
        with pytest.raises(ValueError):
            FT.trunk_ut(m, pack.ws, bad, du, du_s, ss, cs, c_last, ds)
        with pytest.raises(ValueError):
            FT.trunk_dz(m, pack.ws, bad, top, ss, ds, de)
