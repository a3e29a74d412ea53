"""An f32 pass's weight gradients in one launch (csrc/trunk_dw_f32.cu:
trunk_dw_f32_kernel, 3xTF32 on wgmma, the trunk's dW / db and K3's color
net's): its layout arithmetic and work list (honerf_torch/ops/
wgmma_layout.py, the tdw32_* helpers and TDW32_* names) held against the
source, a model of its items against the port's plain version, and the
plain version against the JAX package (CPU).

The kernel runs only on the card (tests/test_torch_cuda.py holds it
against trunk_dw_plain there).  Here:
  * the source's TDW32_* constants are the helper's, and its shared memory
    fits one block;
  * the work list covers every (product, dW row, dW column, point) of a
    pass exactly once at M = 1 to 65,613, at the flagship (with and
    without the color net) and a small meta, each consumer's rows from the
    source that holds them;
  * the transposed split puts every (k, n) of a K step at one swizzled
    byte, which a K-major TF32 wgmma reads back as Y^T (tf32_b_read), and
    the consumers' threads split every cell of a step once;
  * a tile's partials are consecutive and summed in split order, whatever
    order its items run in;
  * `tdw32_model`, the items in f64 on the tf32 split (a fresh sum a K
    step, each partial and the tile's sum in f32), equals trunk_dw_plain
    in f32 within 1e-5 of each output's range;
  * trunk_dw_plain's dW and db at a small f32 TrunkMeta against JAX's
    `_trunk_bwd_block` and, with color, its color gradients against JAX's
    `_color_bwd_block`, within 1e-5 of the range; the port's f32 K6 on the
    CPU against both;
  * on the CPU trunk_dw writes the plain version's gradients and counts no
    launch, and it refuses a bf16 trunk.
"""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine as JF
from honerf_tpu.ops import fused_fine_full as JFF
from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import wgmma_layout as WL

CSRC = Path(WL.__file__).resolve().parent / "csrc"
SOURCE = CSRC / "trunk_dw_f32.cu"
FLAG = FT.TrunkMeta(emb_width=1386, d_hidden=256, n_layers=9, skip=4, d_out=257, dtype="f32")
SMALL = FT.TrunkMeta(90, 64, 5, 2, 17, "f32")
# the flagship color net: input [e | feat | grad-PE] 1408 + 256 + 128, 5 layers
FLAG_COLOR = dict(cx2=384, widths=(256, 256, 256, 256, 64))
SMALL_COLOR = dict(cx2=128, widths=(64, 64, 64))

torch.set_num_threads(1)


def _constants(path: Path, env: dict) -> dict:
    for decl in re.findall(r"^constexpr int (\w+ =[^;]+);", path.read_text(), flags=re.M):
        name, expr = (" ".join(x.split()) for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_source_constants_are_the_helpers():
    shared = _constants(CSRC / "tf32.cuh", {})
    env = _constants(SOURCE, dict(shared))
    mine = {k for k in env if k not in shared}
    assert mine == set(WL.TDW32_CONSTANTS)
    for name in WL.TDW32_CONSTANTS:
        assert env[name] == getattr(WL, name), name
    src = SOURCE.read_text()
    assert "TDW32_NONE = 0, TDW32_MMA = 1, TDW32_SUM = 2" in src
    assert (WL.TDW32_NONE, WL.TDW32_MMA, WL.TDW32_SUM) == (0, 1, 2)


def test_shared_memory_fits_one_block():
    """A 3-slot ring of 32 KB (X's four boxes, Y's four), two 32 KB
    transposed splits, the 64 KB second-level sum, db's 1 KB and the
    barriers, within 232,448 bytes; the slots, the splits and the sum on the
    swizzle's 1024-byte period."""
    src = SOURCE.read_text()
    assert "trunk_dw_f32_kernel<<<grid, wg::THREADS, TDW32_SMEM_BYTES, stream>>>(p);" in src
    parts = WL.tdw32_smem_bytes()
    assert sum(parts.values()) == WL.TDW32_SMEM_BYTES == 231488 <= WL.SMEM_LIMIT
    for off in (WL.TDW32_BOX_BYTES, WL.TDW32_X_BYTES, WL.TDW32_STAGE_BYTES, WL.TDW32_RING_BYTES,
                WL.TDW32_B_BYTES, WL.TDW32_SPLIT_BYTES, WL.TDW32_BUF_BYTES, WL.TDW32_ACC_BYTES):
        assert off % 1024 == 0


# ---------------------------------------------------------------------------
# The work list
# ---------------------------------------------------------------------------

def _rows(tm, m, color=None, seed=0, C=None):
    """Seeded rows of a pass (dw_rows' keys; each list the planes of one
    tensor of C >= m rows) and, with color (FLAG_COLOR / SMALL_COLOR), the
    color rows; the padded f32 gradients to fill."""
    g = torch.Generator().manual_seed(seed)
    C = C or m
    n, Hp, Ep, Op = tm.n_layers, tm.Hp, tm.Ep, tm.Op
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    du = r(C, Ep)
    rows = dict(du_b=du, du_s=du * FT.INV_SQRT2, e=r(C, Ep), dms=[None] + list(r(n - 1, C, Hp)),
                dzs=list(r(n - 1, C, Hp)), acts=list(r(n - 1, C, Hp)), ts=list(r(n - 1, C, Hp)),
                top=r(C, Op), onehot=None)
    shapes = [(Hp + Ep if l == tm.skip else (Ep if l == 0 else Hp), Op if l == n - 1 else Hp)
              for l in range(n)]
    dws = [torch.zeros(s) for s in shapes]
    dbs = [torch.zeros(s[1]) for s in shapes]
    crows = None
    if color is not None:
        w = color["widths"]
        cw = w[0]
        crows = FT.dw_color_rows(r(C, color["cx2"]), list(r(len(w) - 1, C, cw)),
                                 list(r(len(w), C, cw)),
                                 [torch.zeros((Ep + color["cx2"] if l == 0 else cw, o))
                                  for l, o in enumerate(w)], [torch.zeros(o) for o in w])
    return rows, dws, dbs, crows


def _outs(tm, color=None):
    rows, _, _, crows = _rows(tm, 64, color)
    return FT._dw_sources(64, tm, rows, crows)[1]


CASES = {"flagship": (FLAG, FLAG_COLOR), "flagship-nocolor": (FLAG, None),
         "small": (SMALL, SMALL_COLOR)}


@pytest.mark.parametrize("M", [1, 63, 64, 65, 1001, 28288, 65613])
@pytest.mark.parametrize("case", list(CASES))
def test_work_list_covers_every_cell_once(case, M):
    """Every output's rows in tiles of 128 and columns in 128s and a 64;
    each tile's items cover the points [0, M) once, in ranges of whole K
    steps; both products a tile (the u-chain's a SUM only on column 0's
    tiles), each consumer's 64 rows from the source segment that holds
    them; the db on a tile of the first rows."""
    tm, color = CASES[case]
    outs = _outs(tm, color)
    items = WL.tdw32_plan(outs, M)
    cover = [np.zeros((o.K, o.N), dtype=np.int64) for o in outs]
    spans: dict = {}
    for it in items:
        o = outs[it["out"]]
        if it["split"] == 0:
            cover[it["out"]][it["r0"]:it["r0"] + it["rows"], it["c0"]:it["c0"] + it["nb"]] += 1
        spans.setdefault(it["tile"], []).append((it["p0"], it["np"], it["split"], it["splits"]))
        assert it["p0"] % WL.TDW32_BK == 0 and it["np"] > 0
        assert it["db"] == int(it["r0"] == 0)
        for pr, prod in enumerate(o.prods):
            want = prod.kind if (prod.kind != WL.TDW32_SUM or it["c0"] == 0) else WL.TDW32_NONE
            assert it["kind"][pr] == want
            for c in (0, 1):
                row = it["r0"] + 64 * c
                x = it["x"][pr][c]
                if not want or row >= o.K:
                    assert x == -1
                    continue
                seg = next(s for s in prod.segs if s.row0 <= row < s.row0 + s.rows)
                assert x == seg.map + 16 * seg.layer + 2048 * seg.scale + 4096 * (
                    seg.col0 + row - seg.row0)
    for cv in cover:
        assert (cv == 1).all()
    for tile, sp in spans.items():
        sp.sort(key=lambda s: s[2])
        assert [s[2] for s in sp] == list(range(sp[0][3]))
        end = 0
        for p0, np_, _, _ in sp:
            assert p0 == end
            end += np_
        assert end == M
    firsts = sorted((it["first"] + it["split"]) for it in items)
    assert firsts == list(range(len(items)))


def test_plan_fills_the_waves():
    """At an f32 pass's 28,288 points the static order's busiest block
    holds at most 1.15x the mean work of 132 (the items fill whole waves),
    with or without the color net."""
    for color in (FLAG_COLOR, None):
        items = WL.tdw32_plan(_outs(FLAG, color), 28288)
        span = WL.tdw32_makespan(items, 132)
        mean = sum(WL._cdiv(it["np"], 32) * it["cost"] + WL._TDW32_ITEM_COST + 0.25 * it["splits"]
                   for it in items) / 132
        assert span <= 1.15 * mean


def test_item_ints_are_the_struct():
    """The kernel's TDW32Item, field by field."""
    src = SOURCE.read_text()
    body = src[src.index("struct TDW32Item {"):src.index("static_assert(sizeof(TDW32Item)")]
    fields = re.findall(r"int ([^;]+);", body)
    names = []
    for f in fields:
        for name in f.split(","):
            name = name.strip()
            m = re.match(r"(\w+)((?:\[\d+\])*)", name)
            dims = [int(d) for d in re.findall(r"\[(\d+)\]", m.group(2))]
            names += [m.group(1)] * int(np.prod(dims) if dims else 1)
    assert len(names) == WL.TDW32_ITEM_INTS
    it = dict(out=1, tile=2, split=3, splits=4, first=5, r0=6, c0=7, nb=8, rows=9, p0=10, np=11,
              db=12, kind=[13, 14], x=[[15, 16], [17, 18]], y=[19, 20])
    ints = WL.tdw32_item_ints([it])
    want = {k: v for k, v in it.items()}
    flat = []
    for name in names:
        flat.append(name)
    assert ints[:12] == [want[k] for k in flat[:12]]
    assert flat[12:] == ["kind"] * 2 + ["x"] * 4 + ["y"] * 2 + ["pad"] * 4
    assert ints[12:20] == [13, 14, 15, 16, 17, 18, 19, 20] and ints[20:] == [0] * 4


# ---------------------------------------------------------------------------
# The transposed split of B and the A fragments
# ---------------------------------------------------------------------------

def test_transposed_split_is_what_wgmma_reads():
    """Each (n, k) of a K step at its own byte of a 16 KB half, and a
    K-major TF32 wgmma's read of element (n, k % 8) through k8 step k / 8's
    descriptor (start + 32 (k / 8), SBO 1024) is that byte: B = Y^T."""
    base = 3 * 1024
    seen = set()
    for n in range(WL.TDW32_NB):
        for k in range(WL.TDW32_BK):
            off = WL.tdw32_b_offset(n, k)
            assert 0 <= off < WL.TDW32_B_BYTES and off % 4 == 0
            seen.add(off)
            desc = WL.smem_desc(base + 32 * (k // 8), WL.K_MAJOR_LBO, WL.SBO)
            assert WL.tf32_b_read(desc, n, k % 8) == base + off
    assert len(seen) == WL.TDW32_NB * WL.TDW32_BK


@pytest.mark.parametrize("nb", [128, 64])
def test_split_cells_cover_the_step_once(nb):
    """The 256 consumer threads split every (point, column) of a K step's
    Y once, in quads of 4 points a 16-byte store; a warp's threads read 32
    neighbouring columns of one box row (one swizzled 128-byte row) at each
    load, and each 8 neighbouring threads' 16-byte stores fall in distinct
    16-byte chunks of B's rows."""
    cells = [c for tau in range(256) for c in WL.tdw32_split_cells(tau, nb)]
    assert sorted(cells) == [(p, n) for p in range(32) for n in range(nb)]
    for warp in range(8):
        for i in range(len(WL.tdw32_split_cells(0, nb))):
            cell = [WL.tdw32_split_cells(tau, nb)[i] for tau in range(32 * warp, 32 * warp + 32)]
            assert len({p for p, _ in cell}) == 1
            offs = sorted(WL.tdw32_box(p, n % 32) for p, n in cell)
            assert len(set(offs)) == 32 and offs[-1] - offs[0] < 128
            if i % 4 == 0:
                for g in range(4):
                    chunks = {(WL.tdw32_b_offset(n, p) % 128) // 16 for p, n in cell[8 * g:8 * g + 8]}
                    assert len(chunks) == 8


def test_a_cells_are_the_fragments():
    """A consumer thread's X cells are the TF32 A fragment's (tf32_frag_cell
    with its 64 rows as dW rows and its k as the step's points)."""
    for thread in range(128):
        got = WL.tdw32_a_cells(thread)
        want = []
        for kk in range(4):
            for q in range(4):
                row, k = WL.tf32_frag_cell(thread, kk, q)
                want.append((k, row))
        assert got == want


# ---------------------------------------------------------------------------
# A model of the items against the plain version
# ---------------------------------------------------------------------------

def _sources(m, tm, rows, crows):
    """The maps' planes as (planes, m, cols) f32 tensors, in _dw_sources'
    order."""
    n = tm.n_layers
    src = [rows["du_b"][None], rows["du_s"][None], rows["e"][None],
           torch.stack(rows["dms"][1:n]), torch.stack(rows["acts"][:n - 1]),
           torch.stack(rows["ts"][:n - 1]), torch.stack(rows["dzs"][:n - 1]), rows["top"][None]]
    if crows is not None:
        src += [crows["cx2"][None], torch.stack(crows["cacts"]), torch.stack(crows["cdz"])]
    return [s[:, :m].float() for s in src]


def _cols(src, x, p0, np_):
    mp, layer, col = x & 15, (x >> 4) & 127, x >> 12
    v = src[mp][layer, p0:p0 + np_]
    v = torch.nn.functional.pad(v, (0, max(0, col + 64 - v.shape[1])))[:, col:col + 64]
    return v * FT.INV_SQRT2 if (x >> 11) & 1 else v


def tdw32_model(m, tm, rows, dws, dbs, acc, crows=None, order_seed=None):
    """The kernel's items in f64 on the tf32 split: each K step's three
    products (big.small, small.big, big.big) into a fresh f64 sum rounded
    to f32 and added to the running f32 sum, which joins a second-level f32
    sum every TDW32_FLUSH steps and at the end (a SUM's column sums added
    first); db's sums; the tile's partials summed in split order (in
    the order its items ran, order_seed shuffling them) and written
    out = (acc ? out : 0) + that."""
    _, outs = FT._dw_sources(m, tm, rows, crows)
    items = WL.tdw32_plan(outs, m)
    src = _sources(m, tm, rows, crows)
    dw = list(dws) + (list(crows["dcws"]) if crows else [])
    db = list(dbs) + (list(crows["dcbs"]) if crows else [])
    parts = {}
    order = list(range(len(items)))
    if order_seed is not None:
        random.Random(order_seed).shuffle(order)
    for i in order:
        it = items[i]
        nb, p0, np_ = it["nb"], it["p0"], it["np"]
        part = torch.zeros((128, nb))
        dbs_ = torch.zeros(nb, dtype=torch.float64)
        for c in (0, 1):
            run = torch.zeros((64, nb))
            rowsum = None
            held = flushes = 0
            for pr in (0, 1):
                kind, x = it["kind"][pr], it["x"][pr][c]
                if kind == WL.TDW32_MMA:
                    ym, yl = it["y"][pr] & 15, it["y"][pr] >> 4
                    y = src[ym][yl, p0:p0 + np_, it["c0"]:it["c0"] + nb]
                    if pr == 1 and it["db"] and c == 0:
                        dbs_ += y.double().sum(0)
                    yb, ys = (t.double() for t in FH.split_tf32(y))
                if not kind or x < 0:
                    continue
                xv = _cols(src, x, p0, np_)
                if kind == WL.TDW32_SUM:
                    rowsum = xv.double().sum(0).float()
                    continue
                xb, xs = (t.double() for t in FH.split_tf32(xv))
                for k in range(0, np_, 32):
                    s = slice(k, k + 32)
                    fresh = xb[s].T @ ys[s] + xs[s].T @ yb[s] + xb[s].T @ yb[s]
                    run += fresh.float()
                    held += 1
                    if held == WL.TDW32_FLUSH:
                        part[64 * c:64 * c + 64] = run if not flushes else (
                            part[64 * c:64 * c + 64] + run)
                        run, held, flushes = torch.zeros_like(run), 0, flushes + 1
            if rowsum is not None:
                run[:, 0] += rowsum
            if held or not flushes or rowsum is not None:
                part[64 * c:64 * c + 64] = run if not flushes else part[64 * c:64 * c + 64] + run
        parts[(it["tile"], it["split"])] = (part, dbs_.float())
    for it in items:
        if it["split"] != it["splits"] - 1:
            continue
        tot, tdb = None, None
        for sp in range(it["splits"]):
            r, d = parts[(it["tile"], sp)]
            tot = r.clone() if tot is None else tot + r
            tdb = d.clone() if tdb is None else tdb + d
        o, r0, c0, nb, rows_ = it["out"], it["r0"], it["c0"], it["nb"], it["rows"]
        cell = dw[o][r0:r0 + rows_, c0:c0 + nb]
        cell.copy_((cell if acc else 0) + tot[:rows_])
        if it["db"]:
            db[o][c0:c0 + nb] = (db[o][c0:c0 + nb] if acc else 0) + tdb


def _close(got, want, tol=1e-5):
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("case,m", [("flagship", 130), ("small", 70), ("flagship-nocolor", 33)])
def test_model_equals_plain(case, m):
    """tdw32_model at m points (rows past m NaN in planes of m + 9 rows)
    equals trunk_dw_plain in f32 within 1e-5 of each output's range, added
    onto a previous pass's gradients (acc)."""
    tm, color = CASES[case]
    rows, dws, dbs, crows = _rows(tm, m, color, C=m + 9)
    for v in list(rows.values()) + (list(crows.values())[:3] if crows else []):
        for x in (v if isinstance(v, list) else [v]):
            if x is not None:
                x[m:] = float("nan")
    g = torch.Generator().manual_seed(9)
    init = [torch.randn(t.shape, generator=g) for t in dws + dbs]
    model = [x.clone() for x in init]
    plain = [x.clone() for x in init]
    n = tm.n_layers
    mc = dict(crows, dcws=[torch.zeros_like(w) for w in crows["dcws"]],
              dcbs=[torch.zeros_like(b) for b in crows["dcbs"]]) if crows else None
    pc = dict(crows, dcws=[torch.zeros_like(w) for w in crows["dcws"]],
              dcbs=[torch.zeros_like(b) for b in crows["dcbs"]]) if crows else None
    tdw32_model(m, tm, rows, model[:n], model[n:], 1, mc)
    FT.trunk_dw_plain(m, tm, rows, plain[:n], plain[n:], 1, pc)
    for a, b in zip(model, plain):
        assert torch.isfinite(a).all()
        _close(a, b)
    if crows:
        for a, b in zip(mc["dcws"] + mc["dcbs"], pc["dcws"] + pc["dcbs"]):
            assert float(b.abs().max()) > 0
            _close(a, b)


def test_tile_sums_in_split_order_whatever_order_items_run():
    """The model's gradients have the same bits when its items run in
    another order: a tile's partials are summed in split order, by
    whichever item runs last."""
    m = 3000
    rows, dws, dbs, _ = _rows(SMALL, m)
    items = WL.tdw32_plan(_outs(SMALL), m)
    assert max(it["splits"] for it in items) > 1
    got = []
    for seed in (None, 1, 2):
        w, b = [torch.zeros_like(x) for x in dws], [torch.zeros_like(x) for x in dbs]
        tdw32_model(m, SMALL, rows, w, b, 0, order_seed=seed)
        got.append(w + b)
    for other in got[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got[0], other))


# ---------------------------------------------------------------------------
# The plain version against the JAX package, and the CPU wrapper
# ---------------------------------------------------------------------------

DIMS = dict(emb_width=30, d_hidden=16, n_layers=5, skip=2, d_out=17)


def _jax_unpad(dws, dbs, jm):
    H, E, Hp = jm.d_hidden, jm.emb_width, -(-jm.d_hidden // 128) * 128
    out_w, out_b = [], []
    for l, (dw, db, (d_in, d_out)) in enumerate(zip(dws, dbs, JF._dims(jm))):
        dw = np.asarray(dw)
        if l == jm.skip:
            dw = np.concatenate([dw[:H], dw[Hp:Hp + E]], 0)
        out_w.append(dw[:d_in, :d_out])
        out_b.append(np.asarray(db).reshape(-1)[:d_out])
    return out_w, out_b


def _assert_jax_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()), 1e-6)


def _trunk_case(seed=0, B=40):
    """Seeded unpadded numpy weights and inputs at DIMS, the port's pack,
    its plain chains' rows (dw_rows' keys) at B points."""
    tm = FT.TrunkMeta(**DIMS, dtype="f32")
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for s in FT._dims(tm)]
    bs = [(rng.normal(size=s[1]) * 0.05).astype(np.float32) for s in FT._dims(tm)]
    e, dout, du = (rng.normal(size=(B, w)).astype(np.float32) for w in (30, 17, 30))
    pack = FT.pack_trunk_weights([torch.from_numpy(w) for w in ws],
                                 [torch.from_numpy(b) for b in bs], tm)
    eb = FT._e_block(tm, torch.from_numpy(e))
    acts, ss, _ = FT.trunk_fwd_plain(eb, B, pack.ws, pack.bs, tm)
    _, ts, cs = FT.trunk_uchain_plain(ss, pack.ws, tm)
    du_p = torch.nn.functional.pad(torch.from_numpy(du), (0, tm.Ep - 30))
    top = torch.nn.functional.pad(torch.from_numpy(dout), (0, tm.Op - 17))
    ds, dms = FT.trunk_ut_plain(du_p, du_p * FT.INV_SQRT2, B, pack.ws, ss, cs, tm, keep=True)
    _, dzs = FT.trunk_dz_plain(top, B, pack.ws, ss, ds, tm, keep=True)
    rows = dict(du_b=du_p, du_s=du_p * FT.INV_SQRT2, e=eb, dms=dms, dzs=dzs[:-1], acts=acts,
                ts=ts, top=top, onehot=None)
    return tm, pack, ws, bs, (e, dout, du), rows


def test_plain_matches_jax_trunk_block():
    """trunk_dw_plain's dW and db (on the plain chains' kept rows) at DIMS
    (E 30, H 16, 5 layers, skip 2, d_out 17) against JAX's _trunk_bwd_block
    (f32, its own padding, the forward recomputed) on the same seeded numpy
    inputs, within 1e-5 of each output's range."""
    tm, pack, ws, bs, (e, dout, du), rows = _trunk_case()
    jm = JF.TrunkMeta(**DIMS, dtype="f32")
    wps, bps = JF._pad_weights(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), jm)
    Ep, Op = -(-30 // 128) * 128, -(-17 // 128) * 128
    pad = lambda x, w: jnp.pad(jnp.asarray(x), ((0, 0), (0, w - x.shape[1])))  # noqa: E731
    _, jdw, jdb = JF._trunk_bwd_block(jm, pad(e, Ep), pad(dout, Op), pad(du, Ep), wps, bps,
                                      None, True)
    want_w, want_b = _jax_unpad(jdw, jdb, jm)
    dws = [torch.zeros(w.shape) for w in pack.ws]
    dbs = [torch.zeros(b.shape) for b in pack.bs]
    FT.trunk_dw_plain(40, tm, rows, dws, dbs, 0)
    got_w, got_b = FT.unpad_trunk_grads(dws, dbs, tm, FT._dims(tm))
    for a, b in zip(got_w + got_b, want_w + want_b):
        _assert_jax_close(a, b)


def test_plain_color_matches_jax_color_block():
    """With color rows (the input [e | cx2], each layer's kept activation
    and dz row, formed here in f32 as the color net's transpose does), the
    color gradients of trunk_dw_plain against JAX's _color_bwd_block on the
    same x, weights and dcolor, within 1e-5 of the range."""
    tm, _, _, _, _, rows = _trunk_case(seed=2)
    B, Ep, widths = 40, tm.Ep, (32, 32, 64)
    rng = np.random.default_rng(4)
    cx2 = rng.normal(size=(B, 64)).astype(np.float32)
    x = np.concatenate([rows["e"].numpy(), cx2], 1)
    dims = [x.shape[1]] + list(widths)
    cws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
           for a, b in zip(dims[:-1], dims[1:])]
    cbs = [(rng.normal(size=b) * 0.1).astype(np.float32) for b in widths]
    dcolor = rng.normal(size=(B, widths[-1])).astype(np.float32)
    dcolor[:, 3:] = 0.0
    jmeta = JFF.FineMeta(v_multires=1, r_multires=1, d_hidden=16, n_layers=5, skip=2, d_out=17,
                         dtype="f32", c_layers=3)
    _, jdcw, jdcb = JFF._color_bwd_block(jmeta, jnp.asarray(x), [jnp.asarray(w) for w in cws],
                                         [jnp.asarray(b)[None] for b in cbs],
                                         jnp.asarray(dcolor))
    # the port's rows: the forward's activations, then each layer's dz
    a = torch.from_numpy(x)
    acts, zs = [], []
    for l, (w, b) in enumerate(zip(cws, cbs)):
        z = a @ torch.from_numpy(w) + torch.from_numpy(b)
        zs.append(z)
        if l < len(cws) - 1:
            a = torch.relu(z)
            acts.append(a)
    sig = torch.sigmoid(zs[-1])
    dz = sig * (1.0 - sig) * torch.from_numpy(dcolor)
    cdz = [None] * len(cws)
    for l in range(len(cws) - 1, -1, -1):
        cdz[l] = torch.nn.functional.pad(dz, (0, 64 - dz.shape[1]))
        if l:
            dz = torch.where(zs[l - 1] > 0, dz @ torch.from_numpy(cws[l]).T, 0.0)
    acts = [torch.nn.functional.pad(t, (0, 64 - t.shape[1])) for t in acts]
    crows = FT.dw_color_rows(torch.from_numpy(cx2), acts, cdz,
                             [torch.zeros((d if l == 0 else 64, w))
                              for l, (d, w) in enumerate(zip(dims, widths))],
                             [torch.zeros(w) for w in widths])
    dws = [torch.zeros(w.shape) for w in _trunk_case(seed=2)[1].ws]
    dbs = [torch.zeros(w.shape[1]) for w in dws]
    FT.trunk_dw_plain(B, tm, rows, dws, dbs, 0, crows)
    for l, (d, w) in enumerate(zip(dims, widths)):
        _assert_jax_close(crows["dcws"][l][:d, :w], jdcw[l])
        _assert_jax_close(crows["dcbs"][l][:w], np.asarray(jdcb[l]).reshape(-1))


def test_k6_f32_on_the_cpu_matches_plain_and_jax():
    """The port's f32 K6 on the CPU (hand_trunk_sdf_u_bwd) gives the
    weight gradients trunk_dw_plain forms from the same pass's rows and
    JAX's _trunk_bwd_block, within 1e-5 of the range."""
    tm, pack, ws, bs, (e, dout, du), rows = _trunk_case(seed=1)
    _, dws, dbs = FT.hand_trunk_sdf_u_bwd(torch.from_numpy(e), pack, torch.from_numpy(dout),
                                          torch.from_numpy(du), True)
    pw = [torch.zeros(w.shape) for w in pack.ws]
    pb = [torch.zeros(b.shape) for b in pack.bs]
    FT.trunk_dw_plain(40, tm, rows, pw, pb, 0)
    for a, b in zip(list(dws) + list(dbs), pw + pb):
        _close(a, b)
    jm = JF.TrunkMeta(**DIMS, dtype="f32")
    wps, bps = JF._pad_weights(tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), jm)
    pad = lambda x, w: jnp.pad(jnp.asarray(x), ((0, 0), (0, w - x.shape[1])))  # noqa: E731
    _, jdw, jdb = JF._trunk_bwd_block(jm, pad(e, 128), pad(dout, 128), pad(du, 128), wps, bps,
                                      None, True)
    want_w, want_b = _jax_unpad(jdw, jdb, jm)
    got_w, got_b = FT.unpad_trunk_grads(dws, dbs, tm, FT._dims(tm))
    for a, b in zip(got_w + got_b, want_w + want_b):
        _assert_jax_close(a, b)


def test_cpu_wrapper_writes_plain_and_counts_nothing():
    """On CPU rows trunk_dw is trunk_dw_plain bit for bit (with acc, and
    with the color rows) and counts no launch of any dW kernel."""
    rows, dws, dbs, crows = _rows(SMALL, 70, SMALL_COLOR, seed=3)
    ref = [x.clone() + 1 for x in dws + dbs]
    got = [x.clone() + 1 for x in dws + dbs]
    n = SMALL.n_layers
    pc = dict(crows, dcws=[x.clone() for x in crows["dcws"]],
              dcbs=[x.clone() for x in crows["dcbs"]])
    kerns = (FT.TRUNK_DW_F32, FH.GEMM_TN_F32, FH.GEMM_TN, FT.COLSUM)
    before = [k.launches for k in kerns]
    FT.trunk_dw(70, SMALL, rows, got[:n], got[n:], 1, None, crows)
    assert [k.launches for k in kerns] == before
    FT.trunk_dw_plain(70, SMALL, rows, ref[:n], ref[n:], 1, pc)
    for a, b in zip(got + crows["dcws"] + crows["dcbs"], ref + pc["dcws"] + pc["dcbs"]):
        assert torch.equal(a, b)


def test_wrapper_refuses_a_bf16_trunk_and_rows_not_in_planes():
    rows, dws, dbs, _ = _rows(SMALL, 70)
    with pytest.raises(ValueError):
        FT.trunk_dw(70, SMALL._replace(dtype="bf16"), rows, dws, dbs, 0)
    with pytest.raises(ValueError):
        FT.trunk_dw_plain(70, SMALL._replace(dtype="bf16"), rows, dws, dbs, 0)
    apart = dict(rows, dzs=[x.clone() for x in rows["dzs"]])
    with pytest.raises(ValueError, match="planes of one tensor"):
        FT._dw_sources(70, SMALL, apart, None)
    assert len(FT._dw_sources(70, SMALL, rows, None)[0]) == 8
