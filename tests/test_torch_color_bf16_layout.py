"""The bf16 color net in two launches (csrc/color_fused.cu:
color_fwd_kernel, its forward, and color_bwd_kernel, its transpose, bf16
wgmma on a TMA ring): their layout arithmetic (honerf_torch/ops/
wgmma_layout.py, the cf16_* helpers and CF16_* names) held against the
source, a model of their barriers and tile map, and a model of their
phases, boxes and sums against the port's plain versions (CPU; the plain
versions against JAX: tests/test_torch_color_bf16.py).

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions and the split launches there).  Here:
  * the source's CF16_* constants are the helper's; both kernels launch
    with the bf16 trunk's shared memory (the 64 KB tile and a 3-stage
    ring), within the 232,448 bytes a block may use;
  * the phase tables cover every (layer, K step, column) of the forward
    and of the transpose exactly once, at the flagship and a small meta:
    layer 0's two box maps (e's boxes, then cx2's, B's k-row running on),
    the transpose's top layer over the seed's 64 columns, dx's pieces;
  * the tile map stores every point below M once and none past it at M =
    1, 127, 128, 129 and 65,613;
  * `ring_schedule` ends on both tables and finds a planted deadlock;
  * `cf16_model`, the tables in f64 on the bf16 operands (the epilogues'
    bf16 roundings where the kernels round), equals color_fwd_plain /
    color_bwd_plain under the bf16 rule (median <= 1e-4, max <= 1e-2 of
    each output's range: an f64 sum and an f32 one can round an
    activation to neighbouring bf16 values) at M = 1, 63, 64, 65, 130.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from honerf_torch.ops import fused_fine_full as FF
from honerf_torch.ops import wgmma_layout as WL

CSRC = Path(WL.__file__).resolve().parent / "csrc"
SOURCE = CSRC / "color_fused.cu"
FLAG = FF.FineMeta(10, 7, 256, 9, 4, 257, "bf16")
SMALL = FF.FineMeta(2, 1, 16, 5, 2, 17, "bf16", c_hidden=64, c_layers=3)
BF16 = torch.bfloat16

torch.set_num_threads(1)


def _constants(path: Path) -> dict:
    env = {}
    for decl in re.findall(r"^constexpr int (\w+ =[^;]+);", path.read_text(), flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def _dims(meta):
    """(rows, cols) of each padded color layer (kernel layout)."""
    rows = [d[0] for d in meta.color_dims]
    cols = [-(-d[1] // 64) * 64 for d in meta.color_dims]
    return rows, cols


def test_source_constants_are_the_helpers():
    env = _constants(SOURCE)
    assert set(env) == set(WL.CF16_CONSTANTS)
    for name in WL.CF16_CONSTANTS:
        assert env[name] == getattr(WL, name), name
    kinds = re.search(r"enum CF16Kind \{([^}]*)\}", SOURCE.read_text()).group(1)
    assert [k.split("=")[0].strip() for k in kinds.split(",")] == [
        "CF16_RELU", "CF16_SIGMOID", "CF16_MASK", "CF16_DX"]
    assert (WL.CF16_RELU, WL.CF16_SIGMOID, WL.CF16_MASK, WL.CF16_DX) == (0, 1, 2, 3)
    # the bf16 trunk's tile and ring
    assert (WL.CF16_TILE, WL.CF16_ACT_BYTES, WL.CF16_STAGE_BYTES, WL.CF16_STAGES) == (
        WL.TF_TILE, WL.TF_ACT_BYTES, WL.TF_STAGE_BYTES, WL.TF_STAGES)


def test_shared_memory_fits_one_block():
    """Both kernels launch with one layout (the 64 KB bf16 tile, three 48
    KB stages: an A box of 64 columns x 128 rows and 64 k-rows of 256 B
    columns) under the 232,448 bytes, every operand on the swizzle's
    1024-byte period."""
    src = SOURCE.read_text()
    assert "kernel<<<grid, wg::THREADS, CF16_SMEM_BYTES, stream>>>(p);" in src
    for name in ("color_fwd_kernel", "color_bwd_kernel"):
        assert f"cf16_launch({name}, p, stream, smem_set)" in src
    parts = WL.cf16_smem_bytes()
    assert sum(parts.values()) == WL.CF16_SMEM_BYTES == 214064 <= WL.SMEM_LIMIT
    for off in (WL.CF16_ACT_BYTES, WL.CF16_A_BYTES, WL.CF16_STAGE_BYTES, WL.CF16_CHUNK_BYTES):
        assert off % 1024 == 0
    # a consumer's half of a box or a tile chunk starts on the period too
    assert (WL.CF16_A_BYTES // 2) % 1024 == 0 and (WL.CF16_CHUNK_BYTES // 2) % 1024 == 0


def test_phase_tables_of_the_flagship():
    """Forward: layer 0 over e's 22 boxes then cx2's 6 (B's k-rows 0..1791),
    three 256-wide relu layers of 4 K steps, the 64-wide sigmoid layer on
    one B box.  Transpose: the top layer's one K step over the seed, three
    masked layers of 4, dx in 7 pieces of 256."""
    rows, cols = _dims(FLAG)
    assert rows == [1792, 256, 256, 256, 256] and cols == [256, 256, 256, 256, 64]
    fwd = WL.cf16_fwd_phases(1408, 384, rows, cols)
    assert [(p["act_steps"], p["box_steps0"], p["box_steps1"]) for p in fwd] == (
        [(0, 22, 6)] + [(4, 0, 0)] * 4)
    assert [(p["boxes"], p["kind"]) for p in fwd] == (
        [(4, WL.CF16_RELU)] * 4 + [(1, WL.CF16_SIGMOID)])
    loads = WL.cf16_loads(fwd, 3)
    assert loads[0][0] == ((0, 0, 384), [(0, 64 * j, 0) for j in range(4)])
    assert loads[0][21] == ((0, 1344, 384), [(0, 64 * j, 1344) for j in range(4)])  # e's last
    assert loads[0][22] == ((1, 0, 384), [(0, 64 * j, 1408) for j in range(4)])     # cx2's first
    assert loads[0][27] == ((1, 320, 384), [(0, 64 * j, 1728) for j in range(4)])
    assert loads[4] == [(None, [(4, 0, 64 * k)]) for k in range(4)]
    bwd = WL.cf16_bwd_phases(rows, cols)
    assert len(bwd) == 4 + 7 <= WL.CF16_MAX_PHASES
    assert [(p["layer"], p["act_steps"], p["kind"]) for p in bwd] == (
        [(4, 1, WL.CF16_MASK), (3, 4, WL.CF16_MASK), (2, 4, WL.CF16_MASK),
         (1, 4, WL.CF16_MASK)] + [(0, 4, WL.CF16_DX)] * 7)
    assert [(p["n0"], p["boxes"]) for p in bwd[4:]] == [(256 * i, 4) for i in range(7)]
    bl = WL.cf16_loads(bwd, 2)
    assert bl[0] == [(None, [(4, 64 * j, 0) for j in range(4)])]
    assert bl[-1][3] == (None, [(0, 1536 + 64 * j, 192) for j in range(4)])
    assert WL.cf16_pieces(448) == [(0, 256), (256, 128), (384, 64)]
    for bad in (dict(Ep=1400), dict(X=100), dict(width=320), dict(width=96), dict(last=128)):
        with pytest.raises(ValueError):
            WL.cf16_fwd_phases(bad.get("Ep", 1408), bad.get("X", 384), rows,
                               [bad.get("width", 256)] * 4 + [bad.get("last", 64)])
    with pytest.raises(ValueError):
        WL.cf16_bwd_phases([1792, 256, 128, 256, 256], cols)
    with pytest.raises(ValueError):
        WL.cf16_bwd_phases(rows, [256, 256, 256, 256, 128])


@pytest.mark.parametrize("meta", [FLAG, SMALL], ids=["flagship", "small"])
@pytest.mark.parametrize("tile", [0, 5])
def test_phases_cover_every_product_once(meta, tile):
    """Every (layer, K step of 64, output column) of the forward and of the
    transpose is loaded once (B = W_l in the forward, W_l^T in the
    transpose, the pack's cws / cwts), and layer 0's boxes cover e's Ep
    then cx2's columns once, each at the K step whose B rows it meets, at
    the tile's first row; no other phase loads a box."""
    rows, cols = _dims(meta)
    Ep, X = meta.trunk_meta.Ep, meta.Fp + meta.Gp
    for phases, K, N in ((WL.cf16_fwd_phases(Ep, X, rows, cols), rows, cols),
                         (WL.cf16_bwd_phases(rows, cols), cols, rows)):
        seen = [np.zeros((K[l] // 64, N[l]), np.int64) for l in range(meta.c_layers)]
        for ph, steps in zip(phases, WL.cf16_loads(phases, tile)):
            boxes = []
            for a, bs in steps:
                if a is not None:
                    boxes.append((a, bs[0][2]))
                for layer, col, krow in bs:
                    assert layer == ph["layer"] and krow % 64 == 0 and col % 64 == 0
                    seen[layer][krow // 64, col:col + 64] += 1
            if ph["layer"] == 0 and ph["kind"] == WL.CF16_RELU:
                assert [(a[0], a[1], kr) for a, kr in boxes] == (
                    [(0, c, c) for c in range(0, Ep, 64)]
                    + [(1, c, Ep + c) for c in range(0, X, 64)])
                assert {a[2] for a, _ in boxes} == {WL.CF16_TILE * tile}
            else:
                assert not boxes
        for s in seen:
            assert (s == 1).all()


@pytest.mark.parametrize("M", [1, 127, 128, 129, 65613])
def test_tile_map_stores_each_point_once(M):
    """One persistent block an SM walks tiles of 128 points; consumer thread
    rows ra and ra + 8 of a tile (the accumulator's rows) store a point
    only below M: every point below M once, none past it."""
    count = np.zeros(-(-M // 128) * 128, np.int64)
    blocks = WL.tf_tile_rows(M)
    assert len(blocks) == min(132, -(-M // 128))
    for tiles in blocks.values():
        for tile in tiles:
            for thread in range(256):
                for g in WL.tf_thread_rows(tile, thread):
                    count[g] += 1
    assert (count == 4).all()   # the 4 lanes of a quad hold a row's columns
    stored = np.zeros_like(count)
    for tiles in blocks.values():
        for tile in tiles:
            for thread in range(0, 256, 4):
                for g in WL.tf_thread_rows(tile, thread):
                    stored[g] += g < M
    assert (stored[:M] == 1).all() and not stored[M:].any()


STEPS = {"fwd": [28, 4, 4, 4, 4], "bwd": [1, 4, 4, 4] + [4] * 7}


@pytest.mark.parametrize("name", list(STEPS))
def test_ring_schedule_ends(name):
    """Three stages, 1-3 tiles a block, in turn and under random
    interleavings: no deadlock; a ring of one stage deadlocks."""
    for tiles in (1, 2, 3):
        for seed in (None, 0, 1, 2):
            assert WL.ring_schedule(STEPS[name], tiles, WL.CF16_STAGES, seed=seed) > 0
    with pytest.raises(RuntimeError, match="deadlock"):
        WL.ring_schedule(STEPS[name], 1, 1)


# ---------------------------------------------------------------------------
# The kernels' tables and sums against the plain versions
# ---------------------------------------------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).double()


def _run(phases, ops, boxes, tile, epilogue):
    """Each phase's K steps from cf16_loads: A from its box or the tile
    (bf16 values), B's 64 k-rows x the phase's columns from the layer's
    operand; an f64 sum; then epilogue(phase, sum)."""
    for ph, steps in zip(phases, WL.cf16_loads(phases, 0)):
        acc = torch.zeros((tile.shape[0], 64 * ph["boxes"]), dtype=torch.float64)
        op = ops[ph["layer"]]
        for k, (a, bs) in enumerate(steps):
            x = tile[:, 64 * k:64 * k + 64] if a is None else boxes[a[0]][:, a[1]:a[1] + 64]
            b = torch.cat([op[kr:kr + 64, col:col + 64] for _, col, kr in bs], 1)
            acc = acc + x @ b
        epilogue(ph, acc)


def cf16_model(e, cx2, m, cws, cbs, meta, packed, dcolor, cacts):
    """The two kernels' tables on m points: the forward's (color, relu rows)
    from [e | cx2], and the transpose's (dx, dz rows) from the sigmoid in
    packed, dcolor and the relu rows cacts; B = cws[l] (forward) and its
    transpose (the pack's cwts) at the boxes' (column, k-row)."""
    rows, cols = [w.shape[0] for w in cws], [w.shape[1] for w in cws]
    n, Ep, X = meta.c_layers, meta.trunk_meta.Ep, cx2.shape[1]
    tile = torch.zeros((m, 256), dtype=torch.float64)
    acts, color = [None] * (n - 1), []

    def fwd(ph, acc):
        l = ph["layer"]
        z = acc + cbs[l].double()
        if ph["kind"] == WL.CF16_SIGMOID:
            color.append(torch.sigmoid(z[:, :3]))
        else:
            acts[l] = tile[:, :z.shape[1]] = _bf(torch.relu(z))

    _run(WL.cf16_fwd_phases(Ep, X, rows, cols), [w.double() for w in cws],
         [_bf(e[:m, :Ep]), _bf(cx2[:m])], tile, fwd)
    tile = torch.zeros((m, 256), dtype=torch.float64)
    s = packed[:m, 4:7]
    dz = torch.nn.functional.pad(s * (1.0 - s) * dcolor[:m], (0, cols[-1] - 3))
    dzs = [None] * n
    dzs[n - 1] = dz.double()
    tile[:, :cols[-1]] = _bf(dz)
    dx = torch.zeros((m, rows[0]), dtype=torch.float64)

    def bwd(ph, acc):
        l = ph["layer"]
        if ph["kind"] == WL.CF16_MASK:
            dzs[l - 1] = torch.where(cacts[l - 1][:m] > 0, acc, 0.0)
            tile[:, :acc.shape[1]] = _bf(dzs[l - 1])
        else:
            dx[:, ph["n0"]:ph["n0"] + acc.shape[1]] = acc

    _run(WL.cf16_bwd_phases(rows, cols), [w.double().T for w in cws], [], tile, bwd)
    return color[0], acts, dx, dzs


def _color_case(meta, m, seed):
    """Kernel-layout bf16 color weights (the last layer's 3 real columns),
    f32 biases, seeded bf16 [e | cx2] rows and f32 dcolor."""
    rng = np.random.default_rng(seed)
    rows, cols = _dims(meta)
    cws, cbs = [], []
    for l, (a, b) in enumerate(zip(rows, cols)):
        w = rng.normal(size=(a, b)) / np.sqrt(a)
        bias = rng.normal(size=b) * 0.1
        if l + 1 == meta.c_layers:
            w[:, 3:] = 0.0
            bias[3:] = 0.0
        cws.append(torch.from_numpy(w.astype(np.float32)).to(BF16))
        cbs.append(torch.from_numpy(bias.astype(np.float32)))
    Ep, X = meta.trunk_meta.Ep, meta.Fp + meta.Gp
    e = torch.from_numpy(rng.normal(size=(m, Ep)).astype(np.float32)).to(BF16)
    cx2 = torch.from_numpy(rng.normal(size=(m, X)).astype(np.float32)).to(BF16)
    dcolor = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    return cws, cbs, e, cx2, dcolor


def _bf16_rule(got, want):
    """The bf16 rule: median <= 1e-4 and max <= 1e-2 of the range."""
    err = (got.double() - want.double()).abs() / max(float(want.double().abs().max()), 1e-30)
    assert float(err.median()) <= 1e-4 and float(err.max()) <= 1e-2, (
        float(err.median()), float(err.max()))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 130])
def test_model_equals_plain(m):
    cws, cbs, e, cx2, dcolor = _color_case(FLAG, m, seed=m)
    color, acts = FF.color_fwd_plain(e, cx2, m, cws, cbs, FLAG)
    assert all(a.dtype == BF16 for a in acts)
    packed = torch.zeros((m, 8))
    packed[:, 4:7] = color
    dx, dzs = FF.color_bwd_plain(m, cws, FLAG, packed, dcolor, acts)
    g_color, g_acts, g_dx, g_dzs = cf16_model(e, cx2, m, cws, cbs, FLAG, packed, dcolor, acts)
    _bf16_rule(g_color, color)
    for a, b in zip(g_acts, acts):
        _bf16_rule(a, b)
    assert float(dx.abs().max()) > 0
    _bf16_rule(g_dx, dx)
    for a, b in zip(g_dzs, dzs):
        _bf16_rule(a[:, :b.shape[1]], b)
