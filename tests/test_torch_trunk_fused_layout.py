"""The bf16 hand trunk in two launches (csrc/trunk_fused.cu:
hand_trunk_fwd_kernel, hand_uchain_kernel): their layout arithmetic
(honerf_torch/ops/wgmma_layout.py, the TF_* / UC_* names) held against the
source and against wgmma's operand layout, a model of their barriers, a
model of their arithmetic order held against the port's plain versions,
and the plain versions against the JAX package's kernels (CPU).

The kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there).  Here:
  * the source's TF_* / UC_* constants are the helper's; each block's
    shared memory fits in the 232,448 bytes a block may use;
  * every element the epilogues write into a tile (and the seed's 16-byte
    writes) lands where the next phase's A descriptor makes wgmma read it;
    e's box and the weights' boxes land where the descriptors read them
    (the u pieces' two m64n128k16 operands included);
  * the tile map stores every row of a ragged M once;
  * `ring_schedule`, the producer and the two consumers with the ring's
    barriers, ends on the flagship's phases (22- and 26-step e layers, the
    u-chain's 4-step phases) under random interleavings, in lockstep (the
    kernels') and with K4's turns at the tensor cores, which deadlock with
    the turn handed over only after a phase's last step;
  * `fused_model`, the kernels' order (tiles of 128 points, each phase's K
    steps from the producer's table, the pre-skip scale in the epilogue,
    e's boxes scaled at the skip, the seed, the chain into two t tiles, u
    as the skip's part then layer 0's) equals trunk_fwd_plain and
    trunk_uchain_plain bit for bit where every sum is exact in f32 (each
    weight column and each weight row holds at most two powers of two);
  * the plain versions agree with the JAX package's FusedHandSDF and
    hand_trunk_sdf_u in interpret mode (K1: atol 2e-3 / rtol 1e-3, held
    in test_torch_fused_hand.py beside the ladder's plain version, whose
    bits it has here; the trunk: the bf16 rule of
    test_torch_trunk_sdf_u.py, median 1e-4 and max 1e-2 of the range);
  * on the CPU the wrappers write their plain versions' rows and count no
    launch; an f32 trunk is refused.
"""

import math
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
from test_torch_parity import WIDE_EMB, t

SOURCE = Path(WL.__file__).resolve().parent / "csrc" / "trunk_fused.cu"
FLAG = FT.TrunkMeta(emb_width=1386, d_hidden=256, n_layers=9, skip=4, d_out=257)

torch.set_num_threads(1)


def test_source_constants_are_the_helpers():
    env = {}
    for decl in re.findall(r"^constexpr int ((?:TF|UC)_\w+ = [^;]+);", SOURCE.read_text(),
                           flags=re.M):
        name, expr = (x.strip() for x in decl.split("="))
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    assert set(env) == set(WL.TF_CONSTANTS)
    for name in WL.TF_CONSTANTS:
        assert env[name] == getattr(WL, name), name


def test_shared_memory_fits_one_block():
    """The forward: the 64 KB activation tile and three 48 KB stages (e's
    16 KB box, 32 KB of weights: four of wgmma.cuh's B boxes); the
    u-chain: two 64 KB t tiles and three 32 KB stages.  Both under the
    232,448 bytes, every operand on the swizzle's 1024-byte period."""
    for parts, total in ((WL.tf_smem_bytes(), WL.TF_SMEM_BYTES),
                         (WL.uc_smem_bytes(), WL.UC_SMEM_BYTES)):
        assert sum(parts.values()) == total <= WL.SMEM_LIMIT == 232448
    assert WL.TF_SMEM_BYTES == 214064 and WL.UC_SMEM_BYTES == 230448
    assert WL.TF_A_BYTES == WL.A_BYTES and WL.TF_B_BYTES == 4 * WL.B_CHUNK_BYTES
    for off in (WL.TF_CHUNK_BYTES // 2, WL.TF_ACT_BYTES, WL.TF_A_BYTES, WL.TF_STAGE_BYTES,
                WL.UC_STAGE_BYTES // 2, WL.UC_STAGE_BYTES):
        assert off % 1024 == 0
    assert WL.THREADS == 384 and WL.TF_TILE == 2 * 64


def _a_read(base, row, col):
    """The byte wgmma reads tile element (row, col) from through the A
    descriptor of the consumer that owns the row (K-major)."""
    c, chunk, kk = row // 64, col // 64, (col % 64) // 16
    a = base + chunk * WL.TF_CHUNK_BYTES + c * WL.TF_CHUNK_BYTES // 2
    desc = WL.smem_desc(a + kk * WL.K_MAJOR_K16, WL.K_MAJOR_LBO, WL.SBO)
    return WL.wgmma_offset(desc, row % 64, col % 16, k_major=True)


def test_tile_writes_land_where_wgmma_reads():
    """Every (row, column) of a tile, one to one: the epilogues' bf16 pair
    stores (k4_store_offset's address, plus 2 for the odd column; the
    accumulator cell from k4_acc_cell), and the seed's 16-byte stores of
    8 columns at tf_offset(row, 8 v)."""
    base = 0x3000 & ~1023
    seen = set()
    for thread in range(256):
        for i in range(128):
            row, col = WL.k4_acc_cell(thread, i)
            j, q = divmod(i, 4)
            addr = base + WL.k4_store_offset(thread, j, q >> 1) + 2 * (q & 1)
            assert addr == base + WL.tf_offset(row, col) == _a_read(base, row, col)
            seen.add((row, col))
    assert len(seen) == WL.TF_TILE * WL.TF_WIDTH
    for row in range(WL.TF_TILE):
        for v in range(WL.TF_WIDTH // 8):
            start = base + WL.tf_offset(row, 8 * v)
            assert start % 16 == 0
            assert {_a_read(base, row, 8 * v + i) for i in range(8)} == set(
                range(start, start + 16, 2))


def _b_read(b, n, k, lbo=WL.MN_MAJOR_LBO):
    """The byte wgmma reads B element (n, k) of a 64-deep stage from (k16
    step k // 16 through its MN-major descriptor)."""
    desc = WL.smem_desc(b + (k // 16) * WL.MN_MAJOR_K16, lbo, WL.SBO)
    return WL.wgmma_offset(desc, n, k % 16, k_major=False)


def test_stage_boxes_land_where_wgmma_reads():
    """A forward stage: e's 64 x 128 box at its base, read by consumer c
    through its half; the weights' boxes from A_BYTES on, read as one
    256-wide B.  A u-chain piece's stage: the skip's two boxes from 0 and
    layer 0's from 16 KB, each read as one 128-wide B."""
    sb = 0x8000
    for r in range(128):
        for col in range(64):
            c, kk = r // 64, col // 16
            desc = WL.smem_desc(sb + c * WL.TF_A_BYTES // 2 + kk * WL.K_MAJOR_K16,
                                WL.K_MAJOR_LBO, WL.SBO)
            assert WL.wgmma_offset(desc, r % 64, col % 16, True) == sb + WL.tma_box_offset(r, col)
    for n in range(WL.TF_WIDTH):
        for k in range(64):
            box = sb + WL.TF_A_BYTES + (n // 64) * WL.B_CHUNK_BYTES + WL.tma_box_offset(k, n % 64)
            assert _b_read(sb + WL.TF_A_BYTES, n, k) == box
    loads = WL.uc_loads(WL.uc_phases(9, 4, 256, 1408, True), 256, 4)
    piece = loads[7][2]    # the first piece's third K step
    assert [(o, l, col, row) for o, l, col, row in piece] == [
        (0, 4, 256, 128), (8192, 4, 320, 128), (16384, 0, 0, 128), (24576, 0, 64, 128)]
    for half in (0, WL.UC_STAGE_BYTES // 2):
        for n in range(WL.UC_PIECE):
            for k in range(64):
                box = sb + half + (n // 64) * WL.B_CHUNK_BYTES + WL.tma_box_offset(k, n % 64)
                assert _b_read(sb + half, n, k) == box


def test_phase_tables_of_the_flagship():
    """K steps a phase: layer 0 22 over e's boxes, the skip 4 over the
    tile then 22 over e's boxes from weight row 256 (scaled), 4 for every
    other layer; the last layer as z's two pieces (256 + 64 on
    m64n64k16), K1's sdf column, or nothing (the recompute).  The
    u-chain: 7 chain layers (the skip writes t tile 1, tile 0 keeps the
    skip's t), then 11 pieces of u."""
    rows = [1408, 256, 256, 256, 1664, 256, 256, 256, 256]
    cols = [256] * 8 + [320]
    z = WL.tf_phases(1408, 256, rows, cols, 4, n_store=257)
    assert [p["act_steps"] + p["e_steps"] for p in z] == [22, 4, 4, 4, 26, 4, 4, 4, 4, 4]
    assert [(p["n0"], p["boxes"], p["narrow"]) for p in z[-2:]] == [(0, 4, 0), (256, 1, 1)]
    assert [p["prescale"] for p in z].index(1) == 3 and z[4]["scale_e"] == 1
    first_e = WL.tf_loads(z, 5)[4][4]
    assert first_e == ((0, 640), [(4, 64 * j, 256) for j in range(4)])
    k1 = WL.tf_phases(1408, 256, rows, [256] * 8 + [64], 4, sdf=True)
    assert k1[-1]["kind"] == WL.TF_SDF and len(k1) == 9
    assert len(WL.tf_phases(1408, 256, rows, cols, 4)) == 8
    uc = WL.uc_phases(9, 4, 256, 1408, True)
    assert [(p["layer"], p["src"], p["dst"]) for p in uc[:7]] == [
        (7, 0, 0), (6, 0, 0), (5, 0, 0), (4, 0, 1), (3, 1, 1), (2, 1, 1), (1, 1, 1)]
    assert [p["n0"] for p in uc[7:]] == list(range(0, 1408, 128)) and len(uc) == 18
    assert all(p["dst"] == 0 for p in WL.uc_phases(9, 4, 256, 1408, False))
    with pytest.raises(ValueError):   # rows that do not chain
        WL.tf_phases(1408, 256, [1408, 256, 320], [256, 256, 64], 1, sdf=True)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 1001, 65613])
def test_tile_map_stores_every_row_once(M):
    """One persistent block an SM (at most 132, none idle), each walking
    its tiles; per column the 256 consumer threads' two rows of each tile,
    masked to M, store every point once."""
    blocks = WL.tf_tile_rows(M)
    assert len(blocks) == min(132, -(-M // WL.TF_TILE)) and all(blocks.values())
    stored = np.zeros(M, np.int64)
    for tiles in blocks.values():
        for tile in tiles:
            for thread in range(0, 256, 4):      # the lanes of one column pair (t = 0)
                for row in WL.tf_thread_rows(tile, thread):
                    if row < M:
                        stored[row] += 1
    assert (stored == 1).all()


PHASES = {"trunk z": [22, 4, 4, 4, 26, 4, 4, 4, 4, 4], "K1": [22, 4, 4, 4, 26, 4, 4, 4, 4],
          "recompute": [22, 4, 4, 4, 26, 4, 4, 4], "u-chain": [4] * 18, "u-chain keep": [4] * 7}


@pytest.mark.parametrize("turns", [False, True], ids=["lockstep", "turns"])
@pytest.mark.parametrize("name", list(PHASES))
def test_ring_schedule_ends(name, turns):
    """Three stages, 1-3 tiles a block, in turn and under random
    interleavings, in lockstep (the kernels' schedule) and with
    obj_sdf_fused_kernel's turns (measured slower when the fused kernels
    were first built with them): no deadlock, no barrier arrived at twice
    before its sync, none left over."""
    stages = WL.TF_STAGES if "u-chain" not in name else WL.UC_STAGES
    for tiles in (1, 2, 3):
        for seed in (None, 0, 1, 2, 3):
            assert WL.ring_schedule(PHASES[name], tiles, stages, turns, seed=seed) > 0


def test_ring_schedule_finds_the_deadlock_of_a_late_turn():
    """With turns, a consumer that handed the turn over only after a
    phase's last step would wait on layer 0's fourth stage for the other
    consumer, which waits for the turn."""
    with pytest.raises(RuntimeError, match="deadlock"):
        WL.ring_schedule([22, 4], 1, WL.TF_STAGES, True, early_hand_off=False)
    assert WL.ring_schedule([3, 3], 2, WL.TF_STAGES, True, early_hand_off=False) > 0
    # the fused kernels run in lockstep: no consumer syncs a named barrier
    # of the other (bar.sync 1 + c, 128 threads, is each consumer's own)
    assert "bar.sync %0, 256" not in SOURCE.read_text()


# ---------------------------------------------------------------------------
# The kernels' order
# ---------------------------------------------------------------------------

def _bf(x):
    return x.to(torch.bfloat16).float()


def fused_model(e, m, ws, bs, tm):
    """(acts, ss, z, u, ts, cs) in the two kernels' order (f32 sums; bf16
    values held in f32): every tile's K steps from the producer's tables
    (tf_loads, uc_loads), the elementwise functions on whole layers as the
    plain versions lay them out."""
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    W = [w.float() for w in ws]
    E = e[:m].float()
    rows, cols = [w.shape[0] for w in ws], [w.shape[1] for w in ws]
    act = torch.zeros((m, Hp))
    acts, ss = [], []
    z = torch.zeros((m, cols[-1]))
    for ph in WL.tf_phases(Ep, Hp, rows, cols, tm.skip, n_store=cols[-1]):
        width = 64 * ph["boxes"]
        acc = torch.zeros((m, width))
        for tile in range(-(-m // WL.TF_TILE)):
            r = slice(tile * WL.TF_TILE, min(m, (tile + 1) * WL.TF_TILE))
            for k, (a, bx) in enumerate(WL.tf_loads([ph], tile)[0]):
                if a is None:
                    x = act[r, 64 * k:64 * k + 64]
                else:
                    x = E[r, a[0]:a[0] + 64]
                    if ph["scale_e"]:
                        x = _bf(x * FT.INV_SQRT2_BF16)
                wk = torch.cat([W[l][row:row + 64, c0:c0 + 64] for l, c0, row in bx], dim=1)
                acc[r] = acc[r] + x @ wk
        y = acc + bs[ph["layer"]][ph["n0"]:ph["n0"] + width]
        if ph["kind"] == WL.TF_HIDDEN:
            ss.append(torch.sigmoid(FT.BETA * y))
            v = _bf(FT._softplus_beta(y))
            acts.append(v)
            act = _bf(v * (FT.INV_SQRT2_BF16 if ph["prescale"] else 1.0))
        else:
            z[:, ph["n0"]:ph["n0"] + width] = y[:, :cols[-1] - ph["n0"]]
    tiles = [_bf(W[n - 1][:, 0] * ss[n - 2]), None]
    ts, cs = {n - 2: tiles[0]}, {}
    u = torch.zeros((m, Ep))
    phases = WL.uc_phases(n, tm.skip, Hp, Ep, True)
    for ph, loads in zip(phases, WL.uc_loads(phases, Hp, tm.skip)):
        WT = {l: W[l].T for l in (ph["layer"], tm.skip)}
        if ph["kind"] == "chain":
            l = ph["layer"]
            acc = torch.zeros((m, Hp))
            for k, boxes in enumerate(loads):
                wk = torch.cat([WT[l][row:row + 64, c0:c0 + 64] for _, _, c0, row in boxes], 1)
                acc = acc + tiles[ph["src"]][:, 64 * k:64 * k + 64] @ wk
            c = acc * (FT.INV_SQRT2 if l == tm.skip else 1.0)
            cs[l] = c
            tiles[ph["dst"]] = ts[l - 1] = _bf(c * ss[l - 1])
        else:
            w = 64 * ph["boxes"]
            acc_s, acc_0 = torch.zeros((m, w)), torch.zeros((m, w))
            for k, boxes in enumerate(loads):
                half = len(boxes) // 2
                ws_k = torch.cat([WT[tm.skip][row:row + 64, c0:c0 + 64]
                                  for _, _, c0, row in boxes[:half]], 1)
                w0_k = torch.cat([W[0].T[row:row + 64, c0:c0 + 64]
                                  for _, _, c0, row in boxes[half:]], 1)
                acc_s = acc_s + tiles[0][:, 64 * k:64 * k + 64] @ ws_k
                acc_0 = acc_0 + tiles[1][:, 64 * k:64 * k + 64] @ w0_k
            u[:, ph["n0"]:ph["n0"] + w] = acc_s * FT.INV_SQRT2 + acc_0
    return acts, ss, z, u, ts, cs


def _exact_pack(tm, seed):
    """Packed bf16 weights whose every column and every row holds at most
    two nonzero weights, each +-2^p (products of bf16 values exact in f32,
    and a sum of two rounds once whatever the order): layer 0's column j
    reads e's rows 2j and 2j + 1, a hidden layer's rows j and j + 1, the
    skip's one hidden row and one e row; small biases."""
    rng = np.random.default_rng(seed)
    H, E = tm.d_hidden, tm.emb_width
    ws, bs = [], []
    for l, (d_in, d_out) in enumerate(FT._dims(tm)):
        W = np.zeros((d_in, d_out), np.float32)
        for j in range(d_out):
            if l == 0:
                r = [2 * j % d_in, (2 * j + 1) % d_in]
            elif l == tm.skip:
                r = [j % H, H + j % E]
            else:
                r = [j % d_in, (j + 1) % d_in]
            W[r, j] = rng.choice([-1.0, 1.0], 2) * 2.0 ** rng.integers(-3, 2, 2)
        ws.append(torch.from_numpy(W))
        bs.append(torch.from_numpy((rng.normal(size=d_out) * 0.02).astype(np.float32)))
    return FT.pack_trunk_weights(ws, bs, tm)


@pytest.mark.parametrize("tm,m", [(FLAG, 300), (FLAG._replace(d_out=65), 129),
                                  (FT.TrunkMeta(90, 64, 5, 2, 17), 70)],
                         ids=["flagship", "narrow-out", "small"])
def test_model_equals_plain_bit_for_bit(tm, m):
    pack = _exact_pack(tm, 3)
    g = torch.Generator().manual_seed(4)
    e = FT._e_block(tm, torch.rand((m, tm.emb_width), generator=g) * 2 - 1)
    acts, ss, z, u, ts, cs = fused_model(e, m, pack.ws, pack.bs, tm)
    p_acts, p_ss, p_z = FT.trunk_fwd_plain(e, m, pack.ws, pack.bs, tm)
    p_u, p_ts, p_cs = FT.trunk_uchain_plain(p_ss, pack.ws, tm)
    assert float(u.abs().max()) > 0 and float(z.abs().max()) > 0
    same = lambda a, b: torch.equal(a.view(torch.int32), b.contiguous().view(torch.int32))  # noqa
    assert all(same(a, b) for a, b in zip(acts, p_acts)) and all(map(same, ss, p_ss))
    assert same(z, p_z) and same(u, p_u)
    for l in range(1, tm.n_layers - 1):
        assert same(cs[l], p_cs[l]) and same(ts[l - 1], _bf(p_ts[l - 1]))


# ---------------------------------------------------------------------------
# The plain versions against the JAX package, and the CPU wrappers
# ---------------------------------------------------------------------------

def test_k1_plain_is_the_ladder_plain_version():
    """trunk_fwd's sdf column on CPU tensors (trunk_fwd_plain) on
    embed_plain's e: fused_hand_sdf_plain's bits, on a perturbed narrow net
    with the full embedding.  Both are held against JAX's FusedHandSDF in
    interpret mode by test_torch_fused_hand.py::test_plain_matches_jax_kernel
    (one trace of the JAX kernel, ~5-25 s, shared)."""
    from honerf_torch.data.synthetic import canonical_hand_joints
    from honerf_torch.hand import bone_transforms_from_mano_joints
    from honerf_torch.models.fields import SDFConfig, init_sdf_params

    cfg = SDFConfig(kind="hand", trunk_dtype="bf16", **WIDE_EMB)
    gen = torch.Generator().manual_seed(0)
    params = init_sdf_params(gen, cfg, device="cpu")
    params["layers"] = [{k: v + 0.05 * v.abs().mean() * torch.randn(v.shape, generator=gen)
                         for k, v in layer.items()} for layer in params["layers"]]
    joints = torch.as_tensor(canonical_hand_joints(0.3))
    bt = bone_transforms_from_mano_joints(joints[None])[0]
    pts = joints[torch.randint(0, 21, (200,), generator=gen)] + 0.1 * torch.randn(
        (200, 3), generator=gen)
    ws, bs, meta = FH.pack_hand_sdf_weights(params, cfg)
    rotT, off, cut = FH.pack_hand_pose(bt, torch.as_tensor(canonical_hand_joints(0.0)))
    e = FH.embed_plain(pts, rotT, off, cut, meta.v_multires, meta.r_multires, meta.trunk.Ep)
    sdf = torch.empty(200)
    FT.trunk_fwd(e, 200, ws, bs, meta.trunk, sdf=sdf)
    want = FH.fused_hand_sdf_plain(pts, rotT, off, cut, ws, bs, meta)
    assert float(want.abs().max()) > 0 and torch.equal(sdf, want)


def test_trunk_plain_matches_jax_kernel():
    """trunk_fwd_plain then trunk_uchain_plain (out, u) against JAX's
    hand_trunk_sdf_u (bf16, interpret mode) at test_fused_fine.py's META."""
    dims = dict(emb_width=30, d_hidden=16, n_layers=5, skip=2, d_out=17)
    tm, jm = FT.TrunkMeta(**dims), JF.TrunkMeta(**dims, dtype="bf16")
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
        scale = float(np.abs(np.asarray(w)).max())
        assert np.median(err) <= 1e-4 * scale and err.max() <= 1e-2 * scale


def test_cpu_wrappers_write_plain_rows_and_count_nothing():
    tm = FT.TrunkMeta(90, 64, 5, 2, 17)
    pack = _exact_pack(tm, 5)
    e = FT._e_block(tm, torch.rand((50, 90)) * 2 - 1).to(torch.bfloat16)
    n = tm.n_layers
    ss = torch.full((n - 1, 60, tm.Hp), float("nan"))
    acts = [torch.zeros((60, tm.Hp), dtype=torch.bfloat16) for _ in range(n - 1)]
    z, u = torch.zeros((60, 17)), torch.zeros((60, tm.Ep))
    ts = [torch.zeros((60, tm.Hp), dtype=torch.bfloat16) for _ in range(n - 1)]
    cs = [None] + [torch.zeros((60, tm.Hp)) for _ in range(n - 2)]
    before = (FT.TRUNK_FWD.launches, FT.TRUNK_UCHAIN.launches)
    FT.trunk_fwd(e, 50, pack.ws, pack.bs, tm, ss=ss, acts=acts, z=z)
    FT.trunk_uchain(50, pack.ws, None, tm, ss, u=u, ts=ts, cs=cs)
    assert (FT.TRUNK_FWD.launches, FT.TRUNK_UCHAIN.launches) == before
    p_acts, p_ss, p_z = FT.trunk_fwd_plain(e, 50, pack.ws, pack.bs, tm)
    p_u, p_ts, p_cs = FT.trunk_uchain_plain(p_ss, pack.ws, tm)
    assert torch.equal(z[:50], p_z[:, :17]) and torch.equal(u[:50], p_u)
    assert all(torch.equal(ss[l, :50], p_ss[l]) for l in range(n - 1))
    assert all(torch.equal(acts[l][:50].float(), p_acts[l]) for l in range(n - 1))
    assert torch.equal(ts[1][:50], p_ts[1].to(torch.bfloat16)) and torch.equal(cs[2][:50],
                                                                                p_cs[2])
    assert bool(torch.isnan(ss[:, 50:]).all())
    with pytest.raises(ValueError):
        FT.trunk_fwd(e, 50, pack.ws, pack.bs, tm._replace(dtype="f32"), z=z)
    with pytest.raises(ValueError):
        FT.trunk_fwd(e, 50, pack.ws, pack.bs, tm, z=z, sdf=torch.zeros(60))
    assert math.isclose(FT.INV_SQRT2_BF16, 0.70703125)
