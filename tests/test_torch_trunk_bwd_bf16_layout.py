"""The bf16 hand trunk's backward in two launches (csrc/trunk_bwd.cu:
hand_trunk_ut_kernel, the u-chain transposed upward, and
hand_trunk_dz_kernel, the forward transposed downward, bf16 wgmma on the
bf16 trunk's tile and ring): their layout arithmetic
(honerf_torch/ops/wgmma_layout.py, the tb16_* helpers and TB16_* names)
held against the source, a model of their barriers, a model of their
phases, boxes and sums against the port's plain versions, and the plain
versions against the JAX package's `_trunk_bwd_block` (CPU).

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions and the split launches' bits there).  Here:
  * the source's TB16_* constants are the helper's, the bf16 trunk's tile
    and ring; both kernels launch within the 232,448 bytes a block may
    use;
  * the flagship's phase tables: the upward chain's 8 layers (22, 4, 4, 4,
    26, 4, 4, 4 K steps of 64, du_b's boxes at layer 0, du_s's at the skip
    from B's k-row 256), the downward chain's top (5 K steps over the top
    cotangent's boxes) and chain layers (4 each), de's 6 pieces (5 of 256
    columns, one of 128), their skip parts just before the skip's chain
    layer and their layer-0 parts at the end;
  * every (layer, K step, output column) of both chains is loaded once and
    the boxes cover du_b, du_s and the top cotangent once a tile;
  * each chain phase's epilogue rows (the sigmoid and the c or ds rows)
    stream through the ring after its K steps, every column once;
  * `ring_schedule` ends on both tables (K steps and epilogue steps)
    under random interleavings and finds a planted deadlock (a ring of
    one stage);
  * the tile map stores every point once at M = 1 to 65,613, and de's
    pieces every column once;
  * `tb16_model`, the kernels' tables in f64 on the bf16 operands (the
    tile rounded to bf16 as the epilogues store it), equals trunk_ut_plain
    / trunk_dz_plain in bf16 under the bf16 rule (median 1e-4, max 1e-2 of
    each output's range);
  * trunk_ut_plain + trunk_dz_plain in bf16 (de, and with want_dw every dW
    and db formed from their kept rows) agree with JAX's `_trunk_bwd_block`
    at a small bf16 TrunkMeta under the bf16 rule, and so does the port's
    bf16 K6 (hand_trunk_sdf_u_bwd) on the CPU; ds feeds both;
  * on the CPU the wrappers write their plain versions' rows (the bf16 dz
    rows the f32 ones rounded) and count no launch, and refuse f32 weights
    under a bf16 trunk.
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
SOURCE = CSRC / "trunk_bwd.cu"
FLAG = FT.TrunkMeta(emb_width=1386, d_hidden=256, n_layers=9, skip=4, d_out=257, dtype="bf16")
SMALL = FT.TrunkMeta(emb_width=90, d_hidden=64, n_layers=5, skip=2, d_out=17, dtype="bf16")
IN_COLS = [1408, 256, 256, 256, 1664, 256, 256, 256, 256]
BF16 = torch.bfloat16

torch.set_num_threads(1)


def _constants(path: Path) -> dict:
    env = {}
    for decl in re.findall(r"^constexpr int (\w+ =[^;]+);", path.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_source_constants_are_the_helpers():
    env = _constants(SOURCE)
    assert set(env) == set(WL.TB16_CONSTANTS)
    for name in WL.TB16_CONSTANTS:
        assert env[name] == getattr(WL, name), name
    kinds = re.search(r"enum TB16Kind \{([^}]*)\}", SOURCE.read_text()).group(1)
    assert [k.split("=")[0].strip() for k in kinds.split(",")] == [
        "TB16_UT", "TB16_CHAIN", "TB16_DE"]
    assert (WL.TB16_UT, WL.TB16_CHAIN, WL.TB16_DE) == (0, 1, 2)
    # the bf16 trunk's tile and ring
    assert (WL.TB16_TILE, WL.TB16_ACT_BYTES, WL.TB16_STAGE_BYTES, WL.TB16_STAGES) == (
        WL.TF_TILE, WL.TF_ACT_BYTES, WL.TF_STAGE_BYTES, WL.TF_STAGES)


def test_shared_memory_fits_one_block():
    """The upward kernel: the 64 KB bf16 tile and three 48 KB stages (an A
    box of 64 columns x 128 rows and 64 k-rows of 256 B columns); the
    downward: two tiles (dz_skip kept in the second) and three 32 KB
    stages (B alone; an epilogue step's two f32 row boxes fit one).  Both
    under the 232,448 bytes, every operand on the swizzle's 1024-byte
    period."""
    src = SOURCE.read_text()
    assert "kernel<<<grid, wg::THREADS, smem, stream>>>(p);" in src
    assert "tb16_launch(hand_trunk_ut_kernel, p, TB16_SMEM_BYTES, stream, smem_set)" in src
    assert "tb16_launch(hand_trunk_dz_kernel, p, DZ16_SMEM_BYTES, stream, smem_set)" in src
    assert sum(WL.tb16_smem_bytes().values()) == WL.TB16_SMEM_BYTES == 214064 <= WL.SMEM_LIMIT
    assert (sum(WL.tb16_smem_bytes(down=True).values()) == WL.DZ16_SMEM_BYTES == 230448
            <= WL.SMEM_LIMIT)
    assert 2 * WL.TB16_ROWS_BYTES == WL.DZ16_STAGE_BYTES <= WL.TB16_STAGE_BYTES
    for off in (WL.TB16_ACT_BYTES, WL.TB16_A_BYTES, WL.TB16_STAGE_BYTES, WL.TB16_CHUNK_BYTES,
                WL.DZ16_STAGE_BYTES, WL.TB16_ROWS_BYTES):
        assert off % 1024 == 0
    assert (WL.TB16_A_BYTES // 2) % 1024 == 0 and (WL.TB16_CHUNK_BYTES // 2) % 1024 == 0


def test_phase_tables_of_the_flagship():
    """Upward: one phase a layer below the last, layer 0 over du_b's 22
    boxes, the middle layers 4 K steps over the tile, the skip 4 over the
    tile then du_s's 22 from B's k-row 256; four B boxes (256 columns) a K
    step.  Downward: the top's 5 K steps over the top cotangent's boxes,
    the chain layers' 4 over the tile; de in 6 pieces (5 of 256 columns,
    one of 128), the skip's parts (wts[skip]'s columns from 256 + n0) just
    before the skip's chain layer, layer 0's (wts[0]'s from n0) after
    layer 1."""
    up = WL.tb16_ut_phases(1408, 256, IN_COLS[:8], 4)
    assert [(p["act_steps"], p["box_steps0"], p["box_steps1"]) for p in up] == (
        [(0, 22, 0)] + [(4, 0, 0)] * 3 + [(4, 0, 22)] + [(4, 0, 0)] * 3)
    assert {(p["boxes"], p["kind"], p["n0"]) for p in up} == {(4, WL.TB16_UT, 0)}
    loads = WL.tb16_loads(up, 3)
    assert loads[0][0] == ((0, 0, 384), [(0, 64 * j, 0) for j in range(4)])
    assert loads[0][21] == ((0, 1344, 384), [(0, 64 * j, 1344) for j in range(4)])
    assert loads[4][3] == (None, [(4, 64 * j, 192) for j in range(4)])            # the tile
    assert loads[4][4] == ((1, 0, 384), [(4, 64 * j, 256) for j in range(4)])     # du_s's first
    assert loads[4][25] == ((1, 1344, 384), [(4, 64 * j, 1600) for j in range(4)])
    down = WL.tb16_dz_phases(9, 4, 256, 1408, 320)
    assert len(down) == 8 + 11 <= WL.TB16_MAX_PHASES
    assert [(p["act_steps"], p["box_steps0"]) for p in down] == [(5, 0)] + [(4, 0)] * 18
    assert [(p["kind"], p["layer"], p["src"], p["dst"]) for p in down[:8]] == [
        (WL.TB16_CHAIN, l, int(l == 4), int(l == 5)) for l in range(8, 0, -1)]
    assert [(p["kind"], p["layer"], p["src"], p["n0"], p["n1"], p["boxes"]) for p in down[8:]] == [
        (WL.TB16_DE, 4, 1, 256 + 128 * i, 128 * i, 2) for i in range(11)]
    dl = WL.tb16_loads(down, 2)
    assert dl[0][0] == (None, [(8, 64 * j, 0) for j in range(4)])                 # the top's
    assert dl[0][4] == (None, [(8, 64 * j, 256) for j in range(4)])
    assert dl[8][0] == (None, [(4, 256, 0), (4, 320, 0), (0, 0, 0), (0, 64, 0)])
    assert dl[-1][3] == (None, [(4, 1536, 192), (4, 1600, 192), (0, 1280, 192), (0, 1344, 192)])
    assert WL.tb16_pieces(448) == [(0, 128), (128, 128), (256, 128), (384, 64)]
    for bad in (dict(Hp=192), dict(Ep=1400), dict(Op=300), dict(Op=576)):
        with pytest.raises(ValueError):
            WL.tb16_dz_phases(9, 4, bad.get("Hp", 256), bad.get("Ep", 1408), bad.get("Op", 320))
    with pytest.raises(ValueError):
        WL.tb16_ut_phases(1408, 256, IN_COLS[:4] + [1600] + IN_COLS[5:8], 4)


def _in_out(tm):
    """(in_cols, out_cols) of each padded layer (the pack's ws)."""
    ins = [tm.Ep if l == 0 else (tm.Hp + tm.Ep if l == tm.skip else tm.Hp)
           for l in range(tm.n_layers)]
    outs = [tm.Op if l + 1 == tm.n_layers else tm.Hp for l in range(tm.n_layers)]
    return ins, outs


@pytest.mark.parametrize("tm", [FLAG, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("tile", [0, 5])
def test_phases_cover_every_product_once(tm, tile):
    """Every (layer, K step of 64, output column) of both chains is loaded
    once (B = W_l upward over its in_cols k-rows, W_l^T downward over its
    out_cols: the skip's columns past Hp and layer 0's by de's pieces),
    except the upward chain's last layer, which it does not run; A's boxes
    cover du_b (layer 0) and du_s (the skip) over Ep once, each at the K
    step whose B rows it meets, at the tile's first row; no other phase
    loads one (the top cotangent reaches the tiles by the consumers'
    prologue)."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    ins, outs = _in_out(tm)
    up = WL.tb16_ut_phases(Ep, Hp, ins[:n - 1], tm.skip)
    down = WL.tb16_dz_phases(n, tm.skip, Hp, Ep, tm.Op)
    for phases, K, N, layers, want in (
            (up, ins, outs, range(n - 1), {0: [(0, c, c) for c in range(0, Ep, 64)],
                                           tm.skip: [(1, c, Hp + c) for c in range(0, Ep, 64)]}),
            (down, outs, ins, range(n), {})):
        seen = {l: np.zeros((K[l] // 64, N[l]), np.int64) for l in layers}
        boxes = {}
        for ph, steps in zip(phases, WL.tb16_loads(phases, tile)):
            for a, bs in steps:
                if a is not None:
                    boxes.setdefault(ph["layer"], []).append((a, bs[0][2]))
                for layer, col, krow in bs:
                    assert layer in (ph["layer"], 0) and krow % 64 == 0 and col % 64 == 0
                    seen[layer][krow // 64, col:col + 64] += 1
        for s in seen.values():
            assert (s == 1).all()
        assert set(boxes) == set(want)
        for layer, got in boxes.items():
            assert [(a[0], a[1], kr) for a, kr in got] == want[layer]
            assert {a[2] for a, _ in got} == {WL.TB16_TILE * tile}


@pytest.mark.parametrize("tm", [FLAG, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("tile", [0, 3])
def test_epilogue_rows_stream_through_the_ring(tm, tile):
    """After each chain phase's K steps the producer streams the rows its
    epilogue reads, Hp / 32 steps of a 32-column box of each (the sigmoid
    plane l and the c plane of c_{l+1} upward, the last layer's c_last read
    directly; the sigmoid and ds planes l - 1 downward), every column once
    at the tile's rows; de's pieces stream none."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    ins, _ = _in_out(tm)
    cols = list(range(0, Hp, WL.TB16_EPI_COLS))
    up = WL.tb16_ut_phases(Ep, Hp, ins[:n - 1], tm.skip)
    for l, steps in enumerate(WL.tb16_epi_loads(up, tile, Hp)):
        assert [s for s, _ in steps] == [(l, c, WL.TB16_TILE * tile) for c in cols]
        assert [x for _, x in steps] == ([(l, c, WL.TB16_TILE * tile) for c in cols]
                                         if l + 2 < n else [None] * len(cols))
    down = WL.tb16_dz_phases(n, tm.skip, Hp, Ep, tm.Op)
    for ph, steps in zip(down, WL.tb16_epi_loads(down, tile, Hp)):
        if ph["kind"] != WL.TB16_CHAIN:
            assert steps == []
            continue
        plane = ph["layer"] - 1
        assert steps == [((plane, c, WL.TB16_TILE * tile), (plane, c, WL.TB16_TILE * tile))
                         for c in cols]
    assert 2 * WL.TB16_ROWS_BYTES <= WL.TB16_STAGE_BYTES   # both boxes fit a stage


STEPS = {"up": [30, 12, 12, 12, 34, 12, 12, 12], "down": [13] + [12] * 7 + [4] * 11}


@pytest.mark.parametrize("name", list(STEPS))
def test_ring_schedule_ends(name):
    """Three stages, 1-3 tiles a block, each phase's K steps then its
    epilogue steps, in turn and under random interleavings: no deadlock;
    a ring of one stage deadlocks."""
    phases = (WL.tb16_ut_phases(1408, 256, IN_COLS[:8], 4) if name == "up"
              else WL.tb16_dz_phases(9, 4, 256, 1408, 320))
    assert WL.tb16_ring_steps(phases, 256) == STEPS[name]
    for tiles in (1, 2, 3):
        for seed in (None, 0, 1, 2):
            assert WL.ring_schedule(STEPS[name], tiles, WL.TB16_STAGES, seed=seed) > 0
    with pytest.raises(RuntimeError, match="deadlock"):
        WL.ring_schedule(STEPS[name], 1, 1)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 1001, 65613])
def test_tile_map_stores_every_row_once(M):
    """One persistent block an SM walks tiles of 128 points; consumer thread
    rows ra and ra + 8 of a tile store a point only below M (every point
    once, none past it), and de's pieces (R = 2 * width columns a consumer
    thread's accumulator: columns n0 + 8 j + 2 t + q) every column of Ep
    once a row."""
    count = np.zeros(-(-M // 128) * 128, np.int64)
    blocks = WL.tf_tile_rows(M)
    assert len(blocks) == min(132, -(-M // 128))
    for tiles in blocks.values():
        for tile in tiles:
            for thread in range(0, 256, 4):
                for g in WL.tf_thread_rows(tile, thread):
                    count[g] += g < M
    assert (count[:M] == 1).all() and not count[M:].any()
    cols = np.zeros(1408, np.int64)
    for ph in WL.tb16_dz_phases(9, 4, 256, 1408, 320):
        if ph["kind"] == WL.TB16_DE:
            for j in range(8 * ph["boxes"]):
                for t4 in range(4):
                    for q in range(2):
                        cols[ph["n1"] + 8 * j + 2 * t4 + q] += 1
    assert (cols == 1).all()


# ---------------------------------------------------------------------------
# The kernels' tables and sums against the plain versions
# ---------------------------------------------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).double()


def _run(phases, ops, boxes, tiles, epilogue):
    """Each phase's K steps from tb16_loads: A from its box or its tile
    (tiles: the two tiles side by side, 256 columns each; bf16 values), B's
    64 k-rows x the phase's columns from the layer's operand; a piece of de
    also the second sum over tile 0 and its second B; f64 sums; then
    epilogue(phase, sums)."""
    for ph, steps in zip(phases, WL.tb16_loads(phases, 0)):
        w = 64 * ph["boxes"]
        acc = [torch.zeros((tiles.shape[0], w), dtype=torch.float64) for _ in range(2)]
        for k, (a, bs) in enumerate(steps):
            if a is None:
                x = tiles[:, 256 * ph["src"] + 64 * k:][:, :64]
            else:
                x = boxes[a[0]][:, a[1]:a[1] + 64]
            for part, (src, bb) in enumerate(((x, bs[:ph["boxes"]]), (tiles[:, 64 * k:][:, :64],
                                                                      bs[ph["boxes"]:]))):
                if bb:
                    b = torch.cat([ops[layer][kr:kr + 64, col:col + 64] for layer, col, kr in bb],
                                  1)
                    acc[part] = acc[part] + src @ b
        epilogue(ph, acc)


def tb16_model(du_b, du_s, top, m, ws, ss, cs, c_last, tm):
    """(ds, dms, de, dzs) from the two kernels' tables on m points: B = the
    pack's ws upward and their transposes (the pack's wts) downward at the
    boxes' (column, k-row), A from du_b / du_s (bf16) or a tile; the top
    cotangent in the tiles as the prologue copies it; the chains in place,
    dz_skip into tile 1, each rounded to bf16 as the epilogues store it;
    de's pieces as f32(skip part / sqrt2) + layer 0's."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    C = [None] + [c[:m].double() for c in cs[1:n - 1]] + [c_last.double()]
    S = [s[:m].double() for s in ss]
    tiles = torch.zeros((m, 512), dtype=torch.float64)
    ds, dms = [None] * (n - 1), [None] * n

    def up(ph, acc):
        l, dt = ph["layer"], acc[0]
        ds[l] = dt * C[l + 1]
        dms[l + 1] = dt * S[l] * (FT.INV_SQRT2 if l + 1 == tm.skip else 1.0)
        tiles[:, :Hp] = _bf(dms[l + 1])

    ins, _ = _in_out(tm)
    _run(WL.tb16_ut_phases(Ep, Hp, ins[:n - 1], tm.skip), [w.double() for w in ws],
         [_bf(du_b[:m]), _bf(du_s[:m])], tiles, up)
    tiles = torch.zeros((m, 512), dtype=torch.float64)
    top_ = _bf(top[:m])
    for k in range(0, tm.Op, 64):   # chunks 0-3 in tile 0, the rest in tile 1
        tiles[:, k:k + 64] = top_[:, k:k + 64]
    de = torch.zeros((m, Ep), dtype=torch.float64)
    dzs = [None] * (n - 1)

    def down(ph, acc):
        l = ph["layer"]
        if ph["kind"] == WL.TB16_CHAIN:
            s = S[l - 1]
            da = acc[0] * (FT.INV_SQRT2 if l == tm.skip else 1.0)
            dzs[l - 1] = da * s + ds[l - 1] * (FT.BETA * s * (1.0 - s))
            tiles[:, 256 * ph["dst"]:][:, :Hp] = _bf(dzs[l - 1])
        else:
            de[:, ph["n1"]:ph["n1"] + acc[0].shape[1]] = acc[0] * FT.INV_SQRT2 + acc[1]

    _run(WL.tb16_dz_phases(n, tm.skip, Hp, Ep, tm.Op), [w.double().T for w in ws], [], tiles,
         down)
    return ds, dms, de, dzs


def _pack(tm, seed):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32))
          for s in FT._dims(tm)]
    bs = [torch.from_numpy((rng.normal(size=s[1]) * 0.05).astype(np.float32))
          for s in FT._dims(tm)]
    return FT.pack_trunk_weights(ws, bs, tm)


def _chain_inputs(tm, pack, m, seed=4):
    """The forward's sigmoid rows and the u-chain's c rows at m seeded
    points (the plain versions in bf16), and seeded cotangents: du_b =
    bf16(du), du_s = bf16(du / sqrt2) (Ep columns), the top (Op, bf16)."""
    g = torch.Generator().manual_seed(seed)
    e = FT._e_block(tm, torch.rand((m, tm.emb_width), generator=g) * 2 - 1)
    _, ss, _ = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm, last=False)
    _, _, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    du = torch.nn.functional.pad(torch.randn((m, tm.emb_width), generator=g),
                                 (0, tm.Ep - tm.emb_width))
    top = torch.nn.functional.pad(torch.randn((m, tm.d_out), generator=g),
                                  (0, tm.Op - tm.d_out)).to(BF16)
    n = tm.n_layers
    return (ss, [None] + cs[1:n - 1], pack.ws[n - 1][:, 0].float().contiguous(), du.to(BF16),
            (du * FT.INV_SQRT2).to(BF16), top)


def _bf16_rule(got, want, median=True):
    """The bf16 rule: median <= 1e-4 and max <= 1e-2 of the range."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)
    assert not median or float(np.median(err)) <= 1e-4, float(np.median(err))
    assert float(err.max()) <= 1e-2, float(err.max())


@pytest.mark.parametrize("tm,m", [(FLAG, 1), (FLAG, 63), (FLAG, 64), (FLAG, 65), (FLAG, 130),
                                  (SMALL, 70)])
def test_model_equals_plain(tm, m):
    pack = _pack(tm, 3)
    ss, cs, c_last, du_b, du_s, top = _chain_inputs(tm, pack, m)
    ds, dms, de, dzs = tb16_model(du_b, du_s, top, m, pack.ws, ss, cs, c_last, tm)
    p_ds, p_dms = FT.trunk_ut_plain(du_b, du_s, m, pack.ws, ss, cs + [c_last], tm, keep=True)
    p_de, p_dzs = FT.trunk_dz_plain(top, m, pack.ws, ss, p_ds, tm, keep=True)
    assert float(p_de.abs().max()) > 0
    _bf16_rule(de, p_de, median=m > 1)
    for l in range(tm.n_layers - 1):
        _bf16_rule(ds[l], p_ds[l], median=m > 1)
        _bf16_rule(dms[l + 1], p_dms[l + 1], median=m > 1)
        _bf16_rule(dzs[l], p_dzs[l], median=m > 1)


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
        dw = np.asarray(dw, np.float32)
        if l == jm.skip:
            dw = np.concatenate([dw[:H], dw[Hp:Hp + E]], 0)
        out_w.append(dw[:d_in, :d_out])
        out_b.append(np.asarray(db, np.float32).reshape(-1)[:d_out])
    return out_w, out_b


def _jax_block(jm, ws, bs, e, dout, du, want_dw):
    """JAX's _trunk_bwd_block on one block of unpadded numpy inputs (its
    own padding, e in bf16 as its op hands it to the kernel, the forward
    recomputed): de (B, E) and the unpadded dW / db."""
    wps, bps = JF._pad_weights(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), jm)
    Ep, Op = -(-jm.emb_width // 128) * 128, -(-jm.d_out // 128) * 128
    pad = lambda x, w: jnp.pad(jnp.asarray(x), ((0, 0), (0, w - x.shape[1])))  # noqa: E731
    de, dws, dbs = JF._trunk_bwd_block(jm, pad(e, Ep).astype(JF._cast(jm)), pad(dout, Op),
                                       pad(du, Ep), wps, bps, None, want_dw)
    de = np.asarray(de, np.float32)[:, :jm.emb_width]
    return (de, None, None) if not want_dw else (de, *_jax_unpad(dws, dbs, jm))


def _weights(seed):
    tm = FT.TrunkMeta(**DIMS, dtype="bf16")
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for s in FT._dims(tm)]
    bs = [(rng.normal(size=s[1]) * 0.05).astype(np.float32) for s in FT._dims(tm)]
    e, dout, du = (rng.normal(size=(40, w)).astype(np.float32) for w in (30, 17, 30))
    return tm, JF.TrunkMeta(**DIMS, dtype="bf16"), ws, bs, e, dout, du


@pytest.mark.parametrize("want_dw", [True, False], ids=["dw", "frozen"])
def test_plain_chains_match_jax_block(want_dw):
    """trunk_ut_plain then trunk_dz_plain in bf16 at DIMS (E 30, H 16, 5
    layers, skip 2, d_out 17) on seeded numpy inputs, de and (want_dw)
    every dW_l = dm_l^T t_l + in_l^T dz_l and db_l = sum dz_l formed from
    their kept rows (operands rounded to bf16, as the TN products read
    them), against JAX's _trunk_bwd_block (bf16, its own padding, the
    forward recomputed) under the bf16 rule: both round the same operands
    to bf16 and sum in f32 in another order."""
    tm, jm, ws, bs, e, dout, du = _weights(0)
    B, n = 40, tm.n_layers
    pack = FT.pack_trunk_weights([t(w) for w in ws], [t(b) for b in bs], tm)
    eb = FT._e_block(tm, t(e))
    _, _, ss, ins, ts, cs = FT._kernel_fwd_body(tm, eb, pack.ws, pack.bs, residuals=True)
    du_p = torch.nn.functional.pad(t(du), (0, tm.Ep - 30))
    top = torch.nn.functional.pad(t(dout), (0, tm.Op - 17))
    ds, dms = FT.trunk_ut_plain(du_p, du_p * FT.INV_SQRT2, B, pack.ws, ss, cs, tm, keep=want_dw)
    de, dzs = FT.trunk_dz_plain(top, B, pack.ws, ss, ds, tm, keep=want_dw)
    want = _jax_block(jm, ws, bs, e, dout, du, want_dw)
    _bf16_rule(de[:, :30], want[0])
    if not want_dw:
        return
    dws, dbs = [], []
    for l in range(n):
        dm = du_p if l == 0 else (torch.cat([dms[l], du_p * FT.INV_SQRT2], 1) if l == tm.skip
                                  else dms[l])
        dws.append(FT._mm_tn(tm, dm, ts[l]) + FT._mm_tn(tm, ins[l], dzs[l]))
        dbs.append(dzs[l].sum(0))
    got_w, got_b = FT.unpad_trunk_grads(dws, dbs, tm, FT._dims(tm))
    for a, b in zip(got_w + got_b, want[1] + want[2]):
        _bf16_rule(a, b)


@pytest.mark.parametrize("want_dw", [True, False], ids=["dw", "frozen"])
def test_k6_bf16_matches_jax_block(want_dw):
    """The port's bf16 K6 on the CPU (hand_trunk_sdf_u_bwd: the forward
    recomputed, then _trunk_bwd_block on the two plain chains) against
    JAX's _trunk_bwd_block at the same inputs under the bf16 rule."""
    tm, jm, ws, bs, e, dout, du = _weights(1)
    pack = FT.pack_trunk_weights([t(w) for w in ws], [t(b) for b in bs], tm)
    got = FT.hand_trunk_sdf_u_bwd(t(e), pack, t(dout), t(du), want_dw)
    want = _jax_block(jm, ws, bs, e, dout, du, want_dw)
    _bf16_rule(got[0], want[0])
    if want_dw:
        got_w, got_b = FT.unpad_trunk_grads(got[1], got[2], tm, FT._dims(tm))
        for a, b in zip(got_w + got_b, want[1] + want[2]):
            _bf16_rule(a, b)
    else:
        assert got[1] is None and got[2] is None


def test_cpu_wrappers_write_plain_rows_and_count_nothing():
    tm = SMALL
    pack = _pack(tm, 5)
    m, C, n, nan = 50, 60, tm.n_layers, float("nan")
    ss_l, cs, c_last, du_b, du_s, top = _chain_inputs(tm, pack, C)
    ss = torch.stack(ss_l)
    ds = torch.full((n - 1, C, tm.Hp), nan)
    de = torch.full((C, tm.Ep), nan)
    dms = [None] + [torch.full((C, tm.Hp), nan, dtype=BF16) for _ in range(n - 1)]
    dzs = [torch.full((C, tm.Hp), nan) for _ in range(n - 1)]
    dzbs = [torch.full((C, tm.Hp), nan, dtype=BF16) for _ in range(n - 1)]
    kerns = (FT.TRUNK_UT, FT.TRUNK_DZ, FT.TRUNK_UT_F32, FT.TRUNK_DZ_F32, FH.GEMM)
    before = [k.launches for k in kerns]
    FT.trunk_ut(m, pack.ws, tm, du_b, du_s, ss, cs, c_last, ds, dms)
    FT.trunk_dz(m, pack.ws, tm, top, ss, ds, de, dzs, wts=pack.wts, dzbs=dzbs)
    assert [k.launches for k in kerns] == before
    rows = [None] + [c[:m] for c in cs[1:]] + [c_last]
    p_ds, p_dms = FT.trunk_ut_plain(du_b, du_s, m, pack.ws, ss, rows, tm, keep=True)
    p_de, p_dzs = FT.trunk_dz_plain(top, m, pack.ws, ss, ds, tm, keep=True)
    assert torch.equal(de[:m], p_de) and torch.isnan(de[m:]).all()
    for l in range(n - 1):
        assert torch.equal(ds[l, :m], p_ds[l]) and torch.isnan(ds[l, m:]).all()
        assert torch.equal(dms[l + 1][:m], p_dms[l + 1].to(BF16))
        assert torch.equal(dzs[l][:m], p_dzs[l])
        assert torch.equal(dzbs[l][:m], p_dzs[l].to(BF16))
    f32 = [w.float() for w in pack.ws]
    for bad in (dict(ws=f32), dict(tm=tm._replace(d_hidden=192))):
        a = dict(ws=pack.ws, tm=tm) | bad
        with pytest.raises(ValueError):
            FT.trunk_ut(m, a["ws"], a["tm"], du_b, du_s, ss, cs, c_last, ds)
        with pytest.raises(ValueError):
            FT.trunk_dz(m, a["ws"], a["tm"], top, ss, ds, de)
    with pytest.raises(ValueError):   # the f32 dz rows without their bf16 ones
        FT.trunk_dz(m, pack.ws, tm, top, ss, ds, de, dzs)
