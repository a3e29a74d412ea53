"""The f32 color net in two launches (csrc/color_fused_f32.cu:
color_fwd_f32_kernel, its forward, and color_bwd_f32_kernel, its
transpose, 3xTF32 on wgmma): their layout arithmetic (honerf_torch/ops/
wgmma_layout.py, the cf32_* helpers and CF32_* names) held against the
source, a model of their barriers, a model of their phases, boxes and sums
against the port's plain versions, and the plain versions against the JAX
package's `_color_fwd_block` / `_color_bwd_block` (CPU).

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  Here:
  * the source's CF32_* constants are the helper's; both kernels launch
    with the f32 trunk forward's shared memory (the tile and a 4-slot
    ring), within the 232,448 bytes a block may use;
  * the phase tables cover every (layer, K step, column) of the forward
    and of the transpose exactly once, at the flagship and a small meta:
    layer 0's two K ranges (e's boxes, then cx2's, B's k running on),
    the transpose's top layer over the seed's 64 columns, dx's pieces;
  * `ring_schedule` with pairs ends on both tables and finds a planted
    deadlock;
  * `cf32_model`, the tables in f64 on the tf32 split (a fresh sum a K
    step, the running sum in f32), equals color_fwd_plain /
    color_bwd_plain within 1e-5 of each output's range at M = 1, 63,
    64, 65 and 130;
  * the plain versions (color, dx and every dz row) against JAX's
    `_color_fwd_block` / `_color_bwd_block` (res_stash: the sigmoid read
    back, the masks from the kept activations) at a small f32 FineMeta
    within 1e-5 of the range;
  * on the CPU the wrappers write their plain versions' rows, count no
    launch, and refuse a bf16 pack.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honerf_tpu.ops import fused_fine_full as JFF
from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import fused_hand as FH
from honerf_torch.ops import wgmma_layout as WL

CSRC = Path(WL.__file__).resolve().parent / "csrc"
SOURCE = CSRC / "color_fused_f32.cu"
FLAG = FF.FineMeta(10, 7, 256, 9, 4, 257, "f32")
SMALL = FF.FineMeta(2, 1, 16, 5, 2, 17, "f32", c_hidden=16)

torch.set_num_threads(1)


def _constants(path: Path, env: dict) -> dict:
    for decl in re.findall(r"^constexpr int (\w+ =[^;]+);", path.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def _dims(meta):
    """(rows, cols) of each padded color layer (kernel layout)."""
    rows = [d[0] for d in meta.color_dims]
    cols = [d[1] if l + 1 < meta.c_layers else 64 for l, d in enumerate(meta.color_dims)]
    return rows, [-(-c // 64) * 64 for c in cols]


def test_source_constants_are_the_helpers():
    shared = _constants(CSRC / "tf32.cuh", {})
    env = _constants(SOURCE, dict(shared))
    mine = {k for k in env if k not in shared}
    assert mine == set(WL.CF32_CONSTANTS)
    for name in WL.CF32_CONSTANTS:
        assert env[name] == getattr(WL, name), name
    kinds = re.search(r"enum CF32Kind \{([^}]*)\}", SOURCE.read_text()).group(1)
    assert [k.split("=")[0].strip() for k in kinds.split(",")] == [
        "CF32_RELU", "CF32_SIGMOID", "CF32_MASK", "CF32_DX"]
    assert (WL.CF32_RELU, WL.CF32_SIGMOID, WL.CF32_MASK, WL.CF32_DX) == (0, 1, 2, 3)


def test_shared_memory_fits_one_block():
    """Both kernels launch with the f32 trunk forward's layout (the 64 KB
    tile, four 40 KB slots: A's 8 KB box and 256 B rows x 32 k) under the
    232,448 bytes, every operand on the swizzle's 1024-byte period."""
    src = SOURCE.read_text()
    assert "kernel<<<grid, wg::THREADS, CF32_SMEM_BYTES, stream>>>(p);" in src
    for name in ("color_fwd_f32_kernel", "color_bwd_f32_kernel"):
        assert f"cf32_launch({name}, p, stream, smem_set)" in src
    parts = WL.cf32_smem_bytes()
    assert sum(parts.values()) == WL.CF32_SMEM_BYTES == 230464 <= WL.SMEM_LIMIT
    for off in (WL.TF32_ACT_BYTES, WL.TF32_A_BYTES, WL.TF32_STAGE_BYTES):
        assert off % 1024 == 0


def test_phase_tables_of_the_flagship():
    """Forward: layer 0 over e's 44 boxes then cx2's 12 (B's k 0..1791),
    three 256-wide relu layers of 8 K steps, the 64-wide sigmoid layer.
    Transpose: the top layer's 2 K steps over the seed, three masked
    layers of 8, dx in 7 pieces of 256."""
    rows, cols = _dims(FLAG)
    assert rows == [1792, 256, 256, 256, 256] and cols == [256, 256, 256, 256, 64]
    fwd = WL.cf32_fwd_phases(1408, 384, rows, cols)
    assert [(p["act_steps"], p["box_steps0"], p["box_steps1"]) for p in fwd] == (
        [(0, 44, 12)] + [(8, 0, 0)] * 4)
    assert [(p["width"], p["kind"]) for p in fwd] == (
        [(256, WL.CF32_RELU)] * 4 + [(64, WL.CF32_SIGMOID)])
    loads = WL.cf32_loads(fwd, 3, cols)
    assert loads[0][0] == ((0, 0, 192), [(0, 0, 256 + 64 * j) for j in range(4)])
    assert loads[0][87] == (None, [(0, 1376, 64 * j) for j in range(4)])        # e's last big
    assert loads[0][88] == ((1, 0, 192), [(0, 1408, 256 + 64 * j) for j in range(4)])
    assert loads[4][0] == (None, [(4, 0, 64)]) and loads[4][15] == (None, [(4, 224, 0)])
    bwd = WL.cf32_bwd_phases(rows, cols)
    assert len(bwd) == 4 + 7 <= WL.CF32_MAX_PHASES
    assert [(p["layer"], p["act_steps"], p["kind"]) for p in bwd] == (
        [(4, 2, WL.CF32_MASK), (3, 8, WL.CF32_MASK), (2, 8, WL.CF32_MASK),
         (1, 8, WL.CF32_MASK)] + [(0, 8, WL.CF32_DX)] * 7)
    assert [(p["row0"], p["width"]) for p in bwd[4:]] == [(256 * i, 256) for i in range(7)]
    bl = WL.cf32_loads(bwd, 2, rows)
    assert bl[0][0] == (None, [(4, 0, 256 + 64 * j) for j in range(4)])
    assert bl[-1][1] == (None, [(0, 0, 1536 + 64 * j) for j in range(4)])
    for bad in (dict(Ep=1400), dict(X=100), dict(width=192)):
        with pytest.raises(ValueError):
            WL.cf32_fwd_phases(bad.get("Ep", 1408), bad.get("X", 384), rows,
                               [bad.get("width", 256)] * 4 + [64])
    with pytest.raises(ValueError):
        WL.cf32_bwd_phases([1792, 256, 128, 256, 256], cols)


@pytest.mark.parametrize("meta", [FLAG, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("tile", [0, 5])
def test_phases_cover_every_product_once(meta, tile):
    """Every (layer, K step of 32, output column) of the forward and of the
    transpose is loaded once in each slot (B's small rows from
    small_rows[l] + n, its big rows from n), and layer 0's boxes cover e's
    Ep then cx2's columns once, each at the K step whose B rows it meets,
    at the tile's first row; no other phase loads a box."""
    rows, cols = _dims(meta)
    Ep, X = meta.trunk_meta.Ep, meta.Fp + meta.Gp
    for phases, K, N, small in (
            (WL.cf32_fwd_phases(Ep, X, rows, cols), rows, cols, cols),
            (WL.cf32_bwd_phases(rows, cols), cols, rows, rows)):
        seen = [np.zeros((2, K[l] // 32, N[l]), np.int64) for l in range(meta.c_layers)]
        for ph, slots in zip(phases, WL.cf32_loads(phases, tile, small)):
            boxes = []
            for i, (a, bs) in enumerate(slots):
                if a is not None:
                    assert i % 2 == 0
                    boxes.append((a, bs[0][1]))
                for layer, k, row in bs:
                    assert layer == ph["layer"] and k % 32 == 0
                    n0 = row - (small[layer] if i % 2 == 0 else 0)
                    seen[layer][i % 2, k // 32, n0:n0 + 64] += 1
            if ph["layer"] == 0 and ph["kind"] == WL.CF32_RELU:
                assert [(a[0], a[1], kb) for a, kb in boxes] == (
                    [(0, c, c) for c in range(0, Ep, 32)]
                    + [(1, c, Ep + c) for c in range(0, X, 32)])
                assert {a[2] for a, _ in boxes} == {64 * tile}
            else:
                assert not boxes
        for s in seen:
            assert (s == 1).all()


SLOTS = {"fwd": [112, 16, 16, 16, 16], "bwd": [4, 16, 16, 16] + [16] * 7}


@pytest.mark.parametrize("name", list(SLOTS))
def test_ring_schedule_ends(name):
    """Four slots, 1-3 tiles a block, in turn and under random
    interleavings: no deadlock; a ring of one slot deadlocks."""
    for tiles in (1, 2, 3):
        for seed in (None, 0, 1, 2):
            assert WL.ring_schedule(SLOTS[name], tiles, WL.TF32_STAGES, seed=seed,
                                    pairs=True) > 0
    with pytest.raises(RuntimeError, match="deadlock"):
        WL.ring_schedule(SLOTS[name], 1, 1, pairs=True)


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


def _run(phases, small_rows, ops, boxes, tile, epilogue):
    """Each phase's K steps from cf32_loads: A from its box or the tile,
    B's rows from the layer's [big; small] operand; a fresh f64 sum a K
    step added to the running f32 sum; then epilogue(phase, sum)."""
    for ph, slots in zip(phases, WL.cf32_loads(phases, 0, small_rows)):
        run = torch.zeros((tile.shape[0], ph["width"]))
        op = ops[ph["layer"]]
        for k in range(0, len(slots), 2):
            (a, small), (_, big) = slots[k], slots[k + 1]
            x = tile[:, 16 * k:16 * k + 32] if a is None else boxes[a[0]][:, a[1]:a[1] + 32]
            run = run + _prod3(x, _box(op, small), _box(op, big)).float()
        epilogue(ph, run)


def cf32_model(e, cx2, m, cws, cbs, meta, s, dcolor, cacts):
    """The two kernels' tables on m points: the forward's (color, relu rows)
    from [e | cx2], and the transpose's (dx, dz rows) from the sigmoid s,
    dcolor and the relu rows cacts; B's rows from fused_fine.tf32_operands
    at the boxes' (k, row)."""
    from honerf_torch.ops import fused_fine as FT

    rows, cols = [w.shape[0] for w in cws], [w.shape[1] for w in cws]
    n, Ep, X = meta.c_layers, meta.trunk_meta.Ep, cx2.shape[1]
    tile = torch.zeros((m, 256))
    acts, color = [None] * (n - 1), []

    def fwd(ph, acc):
        l, w = ph["layer"], ph["width"]
        z = acc + cbs[l][:w]
        if ph["kind"] == WL.CF32_SIGMOID:
            color.append(1.0 / (1.0 + torch.exp(-z[:, :3])))
        else:
            acts[l] = tile[:, :w] = torch.relu(z)

    _run(WL.cf32_fwd_phases(Ep, X, rows, cols), cols,
         [FT.tf32_operands(w, True) for w in cws], [e[:m, :Ep], cx2[:m]], tile, fwd)
    top = cols[-1]
    tile = torch.zeros((m, 256))
    seed = s * (1.0 - s) * dcolor
    tile[:, :3] = seed
    dzs = [None] * n
    dzs[n - 1] = tile[:, :top].clone()
    dx = torch.zeros((m, rows[0]))

    def bwd(ph, acc):
        l, w = ph["layer"], ph["width"]
        if ph["kind"] == WL.CF32_MASK:
            tile[:, :w] = dzs[l - 1] = torch.where(cacts[l - 1][:m] > 0.0, acc, 0.0)
        else:
            dx[:, ph["row0"]:ph["row0"] + w] = acc

    _run(WL.cf32_bwd_phases(rows, cols), rows, [FT.tf32_operands(w, False) for w in cws], [],
         tile, bwd)
    return color[0], acts, dx, dzs


def _color_case(meta, m, seed):
    """Kernel-layout f32 color weights (the last layer's 3 real columns),
    seeded [e | cx2] rows and dcolor."""
    rng = np.random.default_rng(seed)
    rows, cols = _dims(meta)
    cws, cbs = [], []
    for l, (a, b) in enumerate(zip(rows, cols)):
        w = rng.normal(size=(a, b)) / np.sqrt(a)
        bias = rng.normal(size=b) * 0.1
        if l + 1 == meta.c_layers:
            w[:, 3:] = 0.0
            bias[3:] = 0.0
        cws.append(torch.from_numpy(w.astype(np.float32)))
        cbs.append(torch.from_numpy(bias.astype(np.float32)))
    Ep, X = meta.trunk_meta.Ep, meta.Fp + meta.Gp
    e = torch.from_numpy(rng.normal(size=(m, Ep)).astype(np.float32))
    cx2 = torch.from_numpy(rng.normal(size=(m, X)).astype(np.float32))
    dcolor = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    return cws, cbs, e, cx2, dcolor


def _close(got, want, tol=1e-5):
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("m", [1, 63, 64, 65, 130])
def test_model_equals_plain(m):
    cws, cbs, e, cx2, dcolor = _color_case(FLAG, m, seed=m)
    color, acts = FF.color_fwd_plain(e, cx2, m, cws, cbs, FLAG)
    packed = torch.zeros((m, 8))
    packed[:, 4:7] = color
    dx, dzs = FF.color_bwd_plain(m, cws, FLAG, packed, dcolor, acts)
    g_color, g_acts, g_dx, g_dzs = cf32_model(e, cx2, m, cws, cbs, FLAG, color, dcolor, acts)
    _close(g_color, color)
    for a, b in zip(g_acts, acts):
        _close(a, b)
    assert float(dx.abs().max()) > 0
    _close(g_dx, dx)
    for a, b in zip(g_dzs, dzs):
        _close(a[:, :b.shape[1]], b)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package, and the CPU wrappers
# ---------------------------------------------------------------------------

def _jmeta(meta):
    return JFF.FineMeta(v_multires=meta.v_multires, r_multires=meta.r_multires,
                        d_hidden=meta.d_hidden, n_layers=meta.n_layers, skip=meta.skip,
                        d_out=meta.d_out, dtype="f32", with_color=True, c_hidden=meta.c_hidden,
                        c_layers=meta.c_layers, grad_L=meta.grad_L)


def _assert_jax_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()), 1e-6)


def test_plain_color_matches_jax_blocks():
    """color_fwd_plain's color and relu rows, then color_bwd_plain's
    dx at the sigmoid it read back and the kept rows, against JAX's
    _color_fwd_block and _color_bwd_block (res_stash) on the same
    kernel-layout x, weights and dcolor at SMALL (color input 448, 16-wide
    hidden layers padded to 64); each dz row against JAX's dcb at single
    points (a point's dcb is its dz row)."""
    B = 24
    cws, cbs, e, cx2, dcolor = _color_case(SMALL, B, seed=7)
    jm = _jmeta(SMALL)
    x = torch.cat([e, cx2], 1).numpy()
    jw = [jnp.asarray(w.numpy()) for w in cws]
    jb = [jnp.asarray(b.numpy())[None] for b in cbs]
    j_color, _zs, j_acts = JFF._color_fwd_block(jm, jnp.asarray(x), jw, jb, with_residuals=True)
    color, acts = FF.color_fwd_plain(e, cx2, B, cws, cbs, SMALL)
    _assert_jax_close(color, np.asarray(j_color)[:, :3])
    for a, ja in zip(acts, j_acts[1:]):
        _assert_jax_close(a, ja)
    packed = torch.zeros((B, 8))
    packed[:, 4:7] = color
    dx, dzs = FF.color_bwd_plain(B, cws, SMALL, packed, dcolor, acts)
    dcol = np.pad(dcolor.numpy(), ((0, 0), (0, 61)))
    sig8 = np.asarray(j_color)[:, :8]
    j_dx, _, _ = JFF._color_bwd_block(jm, jnp.asarray(x), jw, jb, jnp.asarray(dcol),
                                      want_dw=False, res_stash=(jnp.asarray(sig8), j_acts))
    _assert_jax_close(dx, j_dx)
    for i in (0, 5, 17):
        _, _, j_dcb = JFF._color_bwd_block(
            jm, jnp.asarray(x[i:i + 1]), jw, jb, jnp.asarray(dcol[i:i + 1]),
            res_stash=(jnp.asarray(sig8[i:i + 1]), [a[i:i + 1] for a in j_acts]))
        for dz, jdz in zip(dzs, j_dcb):
            _assert_jax_close(dz[i:i + 1], jdz)


def test_cpu_wrappers_write_plain_rows_and_count_nothing():
    from honerf_torch.ops import fused_fine as FT

    m, C, nan = 50, 60, float("nan")
    cws, cbs, e, cx2, dcolor = _color_case(SMALL, C, seed=9)
    n, H = SMALL.c_layers, cws[0].shape[1]
    packed = torch.full((C, 8), nan)
    cacts = FT.planes(n - 1, C, H, "cpu", torch.float32)
    for a in cacts:
        a.fill_(nan)
    counters = (FF.COLOR_FWD_F32, FF.COLOR_BWD_F32, FF.COLOR_DZ, FH.GEMM_F32)
    before = [k.launches for k in counters]
    FF.color_fwd_f32(e, cx2, m, cws, cbs, SMALL, packed, cacts)
    color, acts = FF.color_fwd_plain(e, cx2, m, cws, cbs, SMALL)
    assert torch.equal(packed[:m, 4:7], color) and torch.isnan(packed[m:]).all()
    assert torch.isnan(packed[:, :4]).all() and torch.isnan(packed[:, 7]).all()
    for a, want in zip(cacts, acts):
        assert torch.equal(a[:m], want) and torch.isnan(a[m:]).all()
    dx = torch.full((C, SMALL.color_in), nan)
    cdz = FT.planes(n, C, H, "cpu", torch.float32)
    for z in cdz:
        z.fill_(nan)
    FF.color_bwd_f32(m, cws, SMALL, packed, dcolor, cacts, dx, cdz)
    p_dx, p_dzs = FF.color_bwd_plain(m, cws, SMALL, packed, dcolor, cacts)
    assert torch.equal(dx[:m], p_dx) and torch.isnan(dx[m:]).all()
    for z, want in zip(cdz, p_dzs):
        assert torch.equal(z[:m, :want.shape[1]], want) and torch.isnan(z[m:]).all()
    assert [k.launches for k in counters] == before
    bf16 = [w.bfloat16() for w in cws]
    for meta, ws in ((SMALL._replace(dtype="bf16"), cws), (SMALL, bf16)):
        with pytest.raises(ValueError):
            FF.color_fwd_f32(e, cx2, m, ws, cbs, meta, packed)
        with pytest.raises(ValueError):
            FF.color_bwd_f32(m, ws, meta, packed, dcolor, cacts, dx)
