"""The layout arithmetic of the redesigned per-point kernels, on the host:
`hand_embed_kernel` (csrc/common.cuh: the hand embedding e in tiles of
points staged in shared memory, each stored by one bulk copy),
`colsum_partial_kernel` (csrc/trunk.cuh: db as a fixed-order column sum),
`uchain_seed_kernel` (csrc/trunk.cuh: the u-chain's seed, 8 columns a
thread) and `fine_bwd_rev_kernel` (csrc/fused_fine_bwd.cu: K3's reverse
chain transposed, tiles staged in shared memory like the embedding's).

The constants here are the headers' `EMB_*` and `CS_*`, under the same
names; tests/test_torch_perpoint_layout.py reads them from the headers and
holds the two equal, and holds the functions below against the kernels'
contracts:

  * `emb_points` / `emb_smem_bytes` / `emb_tiles` / `emb_grid`: a tile's
    points, the block's shared memory, the tiles and the persistent grid
    of one launch;
  * `emb_units`: which thread writes which columns of a tile (the v-part
    by (point, bone), the r-part by (point, bone, channel), the zero
    padding once per buffer) and `emb_bulk_bytes`, the span each tile's
    bulk copy stores;
  * `emb_tile_model`: the map run with the kernel's arithmetic (bone
    stages, one sin / cos per argument, the double-angle recurrence) in
    torch f32;
  * `colsum_split` / `colsum_row_owner`: the column sum's rows per block,
    its grid, and which block, step, accumulator and warp add a row; the
    order itself is `fused_fine.colsum_ordered_plain`;
  * `US_*`, `us_rows` / `us_grid` / `us_columns`: the seed's rows a block
    step, its persistent grid and which thread writes which columns;
    `check_us_operands`: what the seed refuses;
  * `BWR_*` (tests/test_torch_bwdrev_layout.py holds them to
    csrc/fused_fine_bwd.cu), `bwr_points` / `bwr_smem_bytes` /
    `bwr_tiles` / `bwr_grid`, `bwr_units` (which unit of which pass writes
    which columns of which sub-tile), `bwr_bulk_copies` and
    `bwr_tile_model` (the map with the kernel's arithmetic in torch f32);
    `check_bwr_operands`: what the kernel refuses;
  * `CP_*` (csrc/trunk.cuh: copy_cols_kernel), `copy_plan` (a row's
    scalar head, vector and load width from its two addresses) and
    `copy_columns` (which lane writes which columns of a row, as head,
    body vectors and tail);
  * `PK_*` (csrc/fused_trunk.cu: trunk_pack_e_kernel, the pack of K5 /
    K6's operand), `pack_vec` (a vector's columns: one 16-byte store),
    `pack_plan` (a row's load width and vectors), `pack_columns` (which
    lane writes which vector of a row, with its load pieces), `pack_grid` / `pack_rows` (the persistent grid and the
    rows each warp takes); `check_pack_operands`: what the kernel refuses;
  * `PS_*` (csrc/fused_fine_bwd.cu: pose_sum_kernel, K3's pose sums),
    `sm_count`, `pose_split` (the rows a block sums and the grid, from M
    and the SM count) and `pose_row_owner` (which block, step,
    accumulator and row lane add a row); the order itself is
    `fused_fine_full.pose_sum_ordered_plain`.

Nothing on the main path calls these but `colsum_split`,
`colsum_workspace`, `check_us_operands`, `check_bwr_operands`,
`check_pack_operands`, `sm_count` and `pose_split` (the wrappers' checks
and the pose sum's split); the CUDA side computes the same numbers
(`honerf_hand_embed_t`, `honerf_colsum`, `honerf_uchain_seed_t`,
`honerf_fine_bwd_rev_t`, `honerf_trunk_pack_e_t`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# csrc/common.cuh: hand_embed_kernel
EMB_THREADS = 512
EMB_BLOCKS_PER_SM = 2
EMB_POINTS_BF16 = 16
EMB_LDE_MAX = 1536
EMB_STAGE_FLOATS = 21 + 21 + 63
EMB_TILE_BYTES_MAX = EMB_POINTS_BF16 * EMB_LDE_MAX * 2
EMB_SMEM_MAX = 2 * EMB_TILE_BYTES_MAX + EMB_POINTS_BF16 * EMB_STAGE_FLOATS * 4
# csrc/trunk.cuh: colsum_partial_kernel
CS_THREADS = 256
CS_WARPS = CS_THREADS // 32
CS_COLS = 128
CS_ACC = 4
CS_ROW_STEP = CS_WARPS * CS_ACC
CS_BLOCKS = 264
CS_MAX_TILES = 64

# csrc/trunk.cuh: uchain_seed_kernel
US_THREADS = 256
US_BLOCKS_PER_SM = 8
US_VEC = 8
US_WIDTH_MAX = US_VEC * US_THREADS
# csrc/fused_fine_bwd.cu: fine_bwd_rev_kernel
BWR_THREADS = 256
BWR_BLOCKS_PER_SM = 3
BWR_POINTS_BF16 = 4
BWR_EP_MAX = 1536
BWR_OP_MAX = 384
BWR_L_MAX = 8
BWR_STAGE_FLOATS = 21 * 10 + 21 + 63 + 3
BWR_TILE_BYTES_MAX = BWR_POINTS_BF16 * (2 * BWR_EP_MAX * 2 + BWR_OP_MAX * (4 + 2))
BWR_SMEM_MAX = 2 * BWR_TILE_BYTES_MAX + BWR_POINTS_BF16 * BWR_STAGE_FLOATS * 4

CONSTANTS = ("EMB_THREADS", "EMB_BLOCKS_PER_SM", "EMB_POINTS_BF16", "EMB_LDE_MAX",
             "EMB_STAGE_FLOATS", "EMB_TILE_BYTES_MAX", "EMB_SMEM_MAX", "CS_THREADS", "CS_WARPS",
             "CS_COLS", "CS_ACC", "CS_ROW_STEP", "CS_BLOCKS", "CS_MAX_TILES")
US_CONSTANTS = ("US_THREADS", "US_BLOCKS_PER_SM", "US_VEC", "US_WIDTH_MAX")
BWR_CONSTANTS = ("BWR_THREADS", "BWR_BLOCKS_PER_SM", "BWR_POINTS_BF16", "BWR_EP_MAX",
                 "BWR_OP_MAX", "BWR_L_MAX", "BWR_STAGE_FLOATS", "BWR_TILE_BYTES_MAX",
                 "BWR_SMEM_MAX")
# csrc/trunk.cuh: copy_cols_kernel
CP_THREADS = 256
CP_WARPS = CP_THREADS // 32
CP_NARROW = 8
CP_UNROLL = 8
CP_CONSTANTS = ("CP_THREADS", "CP_WARPS", "CP_NARROW", "CP_UNROLL")
# csrc/fused_trunk.cu: trunk_pack_e_kernel
PK_THREADS = 256
PK_WARPS = PK_THREADS // 32
PK_VEC = 8
PK_BATCH = 1536
PK_CONSTANTS = ("PK_THREADS", "PK_WARPS", "PK_VEC", "PK_BATCH")
# csrc/fused_fine_bwd.cu: pose_sum_kernel
PS_THREADS = 256
PS_COLS = 256
PS_GROUPS = PS_COLS // 4
PS_LANES = PS_THREADS // PS_GROUPS
PS_ACC = 8
PS_ROW_STEP = PS_LANES * PS_ACC
PS_BLOCKS_PER_SM = 2
PS_CONSTANTS = ("PS_THREADS", "PS_COLS", "PS_GROUPS", "PS_LANES", "PS_ACC", "PS_ROW_STEP",
                "PS_BLOCKS_PER_SM")
SMEM_PER_SM = 233472     # an H100 SM's shared memory (228 KB)
SMEM_RESERVED = 1024     # what the card reserves of it for each resident block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# The embedding's tiles
# ---------------------------------------------------------------------------

def emb_width(vL: int, rL: int) -> int:
    """E, the embedding's columns: 21 (1 + 2 vL) + 63 (1 + 2 rL)."""
    return 21 * (1 + 2 * vL) + 63 * (1 + 2 * rL)


def emb_points(esize: int) -> int:
    """P, the points of a tile, for an element of esize bytes (bf16 2, f32 4)."""
    return EMB_POINTS_BF16 * 2 // esize


def emb_smem_bytes(lde: int, esize: int) -> int:
    """The block's dynamic shared memory: two tiles and the stage rows."""
    P = emb_points(esize)
    return 2 * P * lde * esize + P * EMB_STAGE_FLOATS * 4


def check_emb_operand(base: int, lde: int, esize: int, vL: int, rL: int) -> None:
    """Raise where honerf_hand_embed refuses e: a base not 16-byte aligned,
    rows not a multiple of 16 bytes apart, lde outside [E, EMB_LDE_MAX]."""
    if base % 16 or (lde * esize) % 16 or not emb_width(vL, rL) <= lde <= EMB_LDE_MAX:
        raise ValueError(f"e: the embedding kernel stores tiles by bulk copies: a 16-byte-aligned "
                         f"base and rows of a multiple of 16 bytes, {emb_width(vL, rL)} <= lde "
                         f"<= {EMB_LDE_MAX} (base {base:#x}, lde {lde}, {esize}-byte elements)")


def emb_tiles(M: int, esize: int) -> int:
    return _cdiv(M, emb_points(esize))


def emb_grid(M: int, esize: int, sms: int = 132) -> int:
    """Persistent blocks of one launch: EMB_BLOCKS_PER_SM a SM, at most one
    a tile."""
    return min(emb_tiles(M, esize), EMB_BLOCKS_PER_SM * sms)


def emb_block_tiles(M: int, esize: int, block: int, grid: int) -> List[int]:
    """The tiles block `block` takes, in order (tile, tile + grid, ...)."""
    return list(range(block, emb_tiles(M, esize), grid))


def emb_bulk_bytes(M: int, esize: int, lde: int, tile: int) -> Tuple[int, int]:
    """(byte offset into e, bytes) of tile `tile`'s bulk copy: its rows only."""
    P = emb_points(esize)
    rows = min(P, M - tile * P)
    return tile * P * lde * esize, rows * lde * esize


def emb_units(rows: int, vL: int, rL: int) -> List[Tuple[int, int, str, int, List[int]]]:
    """Each unit of a tile of `rows` points as (unit, point, part, index,
    columns written): the v-part of (point, bone j) for units < 21 rows,
    then the r-part of (point, channel k = 3 bone + c).  Thread t takes
    units t, t + EMB_THREADS, ..."""
    rb = 21 * (1 + 2 * vL)
    out = []
    nv = rows * 21
    for u in range(rows * 84):
        if u < nv:
            pt, j = divmod(u, 21)
            cols = [j] + [c for l in range(vL) for c in (21 + 21 * l + j, 21 + 21 * (vL + l) + j)]
            out.append((u, pt, "v", j, cols))
        else:
            pt, k = divmod(u - nv, 63)
            cols = [rb + k] + [c for l in range(rL)
                               for c in (rb + 63 + 63 * l + k, rb + 63 + 63 * (rL + l) + k)]
            out.append((u, pt, "r", k, cols))
    return out


def emb_pad_columns(P: int, lde: int, vL: int, rL: int) -> List[Tuple[int, int]]:
    """(buffer row, column) of the zero padding written once: rows of both
    buffers (2 P), columns [E, lde)."""
    E = emb_width(vL, rL)
    pad = lde - E
    return [(i // pad, E + i % pad) for i in range(2 * P * pad)] if pad else []


def emb_tile_model(pts: torch.Tensor, rotT: torch.Tensor, off: torch.Tensor,
                   cut: torch.Tensor, vL: int, rL: int, lde: int) -> torch.Tensor:
    """e (M, lde) in f32, filled unit by unit as the kernel's map says, with
    its arithmetic: the bone stages, one sin / cos per argument, the
    double-angle recurrence s2 = 2 s c, c2 = (c - s)(c + s)."""
    from honerf_torch.ops.fused_hand import _emb_stages

    M = pts.shape[0]
    st = _emb_stages(pts, rotT, off, cut)
    v, h, rr = st["v"], st["h"], st["rr"]
    e = torch.full((M, lde), float("nan"))
    e[:, emb_width(vL, rL):] = 0.0
    for _, pt, part, idx, cols in emb_units(1, vL, rL):
        x, g = (v[:, idx], h[:, idx]) if part == "v" else (rr[:, idx], h[:, idx // 3])
        vals = [x * g]
        s, c = torch.sin(x), torch.cos(x)
        for l in range(vL if part == "v" else rL):
            if l:
                s, c = 2.0 * s * c, (c - s) * (c + s)
            vals += [s * g, c * g]
        for col, val in zip(cols, vals):
            e[:, col] = val
    return e


# ---------------------------------------------------------------------------
# The column sum's split and order
# ---------------------------------------------------------------------------

def colsum_split(M: int, N: int) -> Dict[str, int]:
    """Rows per block (`split`, a multiple of CS_ROW_STEP), the blocks along
    the rows (S) and the column tiles (tiles) of one launch: ~CS_BLOCKS
    blocks in all."""
    if N % 4 or N > CS_COLS * CS_MAX_TILES:
        raise ValueError(f"the column sum takes N a multiple of 4, at most "
                         f"{CS_COLS * CS_MAX_TILES} (N {N})")
    tiles = _cdiv(N, CS_COLS)
    per_tile = max(1, _cdiv(CS_BLOCKS, tiles))
    split = _cdiv(_cdiv(max(M, 1), per_tile), CS_ROW_STEP) * CS_ROW_STEP
    return dict(split=split, S=_cdiv(M, split), tiles=tiles)


def colsum_workspace(M: int, N: int) -> int:
    """Floats of the f32 partials of one launch."""
    return colsum_split(M, N)["S"] * N


def colsum_row_owner(r: int, split: int) -> Tuple[int, int, int, int]:
    """(block s, step i, accumulator k, warp w) that adds row r:
    r = s split + CS_ROW_STEP i + CS_WARPS k + w."""
    s, rest = divmod(r, split)
    i, rest = divmod(rest, CS_ROW_STEP)
    k, w = divmod(rest, CS_WARPS)
    return s, i, k, w


# ---------------------------------------------------------------------------
# The u-chain's seed
# ---------------------------------------------------------------------------

def check_us_operands(s_base: int, t_base: int, width: int, ldt: int) -> None:
    """Raise where honerf_uchain_seed_f32 refuses: s or t off a 16-byte
    boundary, width or ldt not a multiple of US_VEC, width past
    US_WIDTH_MAX or ldt below it."""
    if (s_base % 16 or t_base % 16 or width <= 0 or width % US_VEC or width > US_WIDTH_MAX
            or ldt % US_VEC or ldt < width):
        raise ValueError(f"the u-chain seed moves 8 columns a thread in 16-byte loads and "
                         f"stores: 16-byte-aligned s and t, width and ldt multiples of {US_VEC}, "
                         f"width <= {US_WIDTH_MAX} <= ... (s {s_base:#x}, t {t_base:#x}, width "
                         f"{width}, ldt {ldt})")


def us_rows(width: int) -> int:
    """Rows a block covers a step: US_THREADS / (width / US_VEC)."""
    return US_THREADS // (width // US_VEC)


def us_grid(M: int, width: int, sms: int = 132) -> int:
    """Persistent blocks of one launch: US_BLOCKS_PER_SM a SM, at most one
    a block step of rows."""
    return min(_cdiv(M, us_rows(width)), US_BLOCKS_PER_SM * sms)


def us_columns(M: int, width: int, block: int, thread: int, grid: int) -> List[Tuple[int, int]]:
    """(row, first column) of each 8-column vector thread `thread` of block
    `block` writes: its row offset r and column vector c, rows block rows +
    r, (block + grid) rows + r, ... below M."""
    vecs = width // US_VEC
    rows = US_THREADS // vecs
    r, c = divmod(thread, vecs)
    if r >= rows:
        return []
    return [(m, c * US_VEC) for m in range(block * rows + r, M, grid * rows)]


# ---------------------------------------------------------------------------
# The reverse-chain transpose's tiles
# ---------------------------------------------------------------------------

def bwr_points(esize: int) -> int:
    """P, the points of a tile, for an element of esize bytes (bf16 2, f32 4)."""
    return BWR_POINTS_BF16 * 2 // esize


def bwr_tile_bytes(Ep: int, Op: int, esize: int) -> int:
    """One buffer: the du_b and du_s sub-tiles (P x Ep) and dzf, dzb (P x Op)."""
    return bwr_points(esize) * (2 * Ep * esize + Op * (4 + esize))


def bwr_smem_bytes(Ep: int, Op: int, esize: int) -> int:
    """The block's dynamic shared memory: two buffers and the stage rows
    (bone stages, cb, h cc, dg_total)."""
    return 2 * bwr_tile_bytes(Ep, Op, esize) + bwr_points(esize) * BWR_STAGE_FLOATS * 4


def bwr_subtile_offsets(Ep: int, Op: int, esize: int) -> Dict[str, Tuple[int, int]]:
    """(byte offset in a buffer, bytes of a row) of each sub-tile."""
    P = bwr_points(esize)
    return {"du_b": (0, Ep * esize), "du_s": (P * Ep * esize, Ep * esize),
            "dzf": (2 * P * Ep * esize, Op * 4), "dzb": (2 * P * Ep * esize + P * Op * 4, Op * esize)}


def check_bwr_operands(bases: Dict[str, int], lddu: int, lddz: int, esize: int, vL: int,
                       rL: int, Ep: int, Op: int, L: int) -> None:
    """Raise where honerf_fine_bwd_rev refuses: an output (du_b, du_s, dzf,
    dzb) off a 16-byte boundary, du rows or their stride not a multiple of
    16 bytes, Op or lddz not a multiple of 8, widths outside [E, BWR_EP_MAX]
    and (0, BWR_OP_MAX], strides below the widths, L past BWR_L_MAX."""
    E = emb_width(vL, rL)
    bad = [k for k, b in bases.items() if b % 16]
    if (bad or not E <= Ep <= BWR_EP_MAX or lddu < Ep or Ep * esize % 16 or lddu * esize % 16
            or not 0 < Op <= BWR_OP_MAX or Op % 8 or lddz < Op or lddz % 8
            or not 0 <= L <= BWR_L_MAX):
        raise ValueError(f"the reverse-chain transpose stores tiles by bulk copies: 16-byte-"
                         f"aligned outputs (misaligned: {bad}), rows and strides of multiples "
                         f"of 16 bytes, {E} <= Ep <= {BWR_EP_MAX} <= lddu, Op a multiple of 8 "
                         f"<= {BWR_OP_MAX} <= lddz, L <= {BWR_L_MAX} (Ep {Ep}, lddu {lddu}, Op "
                         f"{Op}, lddz {lddz}, L {L}, {esize}-byte elements)")


def bwr_tiles(M: int, esize: int) -> int:
    return _cdiv(M, bwr_points(esize))


def bwr_grid(M: int, esize: int, sms: int = 132) -> int:
    """Persistent blocks of one launch: BWR_BLOCKS_PER_SM a SM, at most one
    a tile."""
    return min(bwr_tiles(M, esize), BWR_BLOCKS_PER_SM * sms)


def bwr_units(rows: int, vL: int, rL: int, Op: int) -> List[Tuple[int, int, str, List[Tuple[str, int]]]]:
    """Each unit that writes a tile of `rows` points as (pass, point, kind,
    [(sub-tile, column) written]): pass 2's (point, bone) units (the
    v-part into du_b and du_s) and (point, 8 columns) units (dzf and dzb),
    then pass 3's (point, bone, channel) units (the r-part).  Thread t of a
    pass takes its units t, t + BWR_THREADS, ..."""
    rb = 21 * (1 + 2 * vL)
    out = []
    for u in range(rows * 21):
        pt, j = divmod(u, 21)
        cols = [j] + [c for l in range(vL) for c in (21 + 21 * l + j, 21 + 21 * (vL + l) + j)]
        out.append((2, pt, "v", [(a, c) for c in cols for a in ("du_b", "du_s")]))
    oc = Op // 8
    for w in range(rows * oc):
        pt, c8 = divmod(w, oc)
        out.append((2, pt, "dz", [(a, 8 * c8 + i) for i in range(8) for a in ("dzf", "dzb")]))
    for u in range(rows * 63):
        pt, k = divmod(u, 63)
        cols = [rb + k] + [c for l in range(rL)
                           for c in (rb + 63 + 63 * l + k, rb + 63 + 63 * (rL + l) + k)]
        out.append((3, pt, "r", [(a, c) for c in cols for a in ("du_b", "du_s")]))
    return out


def bwr_pad_columns(P: int, Ep: int, vL: int, rL: int) -> List[Tuple[int, int, str, int]]:
    """(buffer, point, sub-tile, column) of the zero padding written once:
    columns [E, Ep) of the du_b and du_s rows of both buffers."""
    E = emb_width(vL, rL)
    pad = Ep - E
    out = []
    for i in range(4 * P * pad):
        k, c = divmod(i, pad)
        b, kr = divmod(k, 2 * P)
        out.append((b, kr % P, "du_b" if kr < P else "du_s", E + c))
    return out


def bwr_bulk_copies(M: int, esize: int, Ep: int, lddu: int, Op: int, lddz: int,
                    tile: int) -> List[Tuple[str, int, int]]:
    """(output, byte offset, bytes) of tile `tile`'s bulk copies: one a
    sub-tile whose rows are dense in the output, else one a row."""
    P = bwr_points(esize)
    p0 = tile * P
    rows = min(P, M - p0)
    out = []
    for name, row, ld in (("du_b", Ep * esize, lddu * esize), ("du_s", Ep * esize, lddu * esize),
                          ("dzf", Op * 4, lddz * 4), ("dzb", Op * esize, lddz * esize)):
        if ld == row:
            out.append((name, p0 * ld, rows * row))
        else:
            out += [(name, (p0 + r) * ld, row) for r in range(rows)]
    return out


def bwr_tile_model(pts, rotT, off, cut, vL: int, rL: int, packed, dsdf, dg, dx, Ep: int, F: int,
                   Fp: int, L: int, Op: int):
    """(du (M, Ep), dgt (M, 3), dz (M, Op)) in f32, filled unit by unit as
    the kernel's map says, with its arithmetic: the grad-PE sum from
    dg + dgpe[j] in level order, the bone stages, the head of the
    transpose (cf = t rotT, cn, ca, cb, cc), one sin / cos per argument and
    the double-angle recurrence, v cb + h ca, s cb + f c h ca, ..."""
    from honerf_torch.ops.fused_hand import _emb_stages

    M = pts.shape[0]
    dgpe = dx[:, Ep + Fp:]
    g = packed[:, 1:4]
    t = dg[:, :3] + dgpe[:, :3]
    for l in range(L):
        f = float(2 ** l)
        t = t + f * (torch.cos(g * f) * dgpe[:, (1 + l) * 8:(1 + l) * 8 + 3]
                     - torch.sin(g * f) * dgpe[:, (1 + L + l) * 8:(1 + L + l) * 8 + 3])
    st = _emb_stages(pts, rotT, off, cut)
    q, v, sc, h, w3, rr = st["q"], st["v"], st["sc"], st["h"], st["w3"], st["rr"]
    cf = t[:, 0:1] * rotT[0, :63] + t[:, 1:2] * rotT[1, :63] + t[:, 2:3] * rotT[2, :63]
    cn = (2.0 * q * cf).reshape(M, 21, 3).sum(-1)
    ca = 0.5 * cn / v
    cb = -200.0 * sc * (1.0 - sc) * ca
    w3c = (w3 * w3 * w3)
    cc = -0.5 * q * w3c * torch.repeat_interleave(cn, 3, dim=-1) + w3 * cf
    hca, hc = h * ca, torch.repeat_interleave(h, 3, dim=-1) * cc
    cb3 = torch.repeat_interleave(cb, 3, dim=-1)
    du = torch.full((M, Ep), float("nan"))
    du[:, emb_width(vL, rL):] = 0.0
    dz = torch.full((M, Op), float("nan"))
    for _, _, kind, cols in bwr_units(1, vL, rL, Op):
        cols = [c for a, c in cols if a in ("du_b", "dzf")]
        if kind == "dz":
            for c in cols:
                dz[:, c] = dsdf.reshape(-1) if c == 0 else (dx[:, Ep + c - 1] if c <= F else 0.0)
            continue
        if kind == "v":
            j = cols[0]
            x, b, a, n = v[:, j], cb[:, j], hca[:, j], vL
        else:
            k = cols[0] - 21 * (1 + 2 * vL)
            x, b, a, n = rr[:, k], cb3[:, k], hc[:, k], rL
        vals = [x * b + a]
        s, c = torch.sin(x), torch.cos(x)
        for l in range(n):
            if l:
                s, c = 2.0 * s * c, (c - s) * (c + s)
            f = float(2 ** l)
            vals += [s * b + f * c * a, c * b - f * s * a]
        for col, val in zip(cols, vals):
            du[:, col] = val
    return du, t, dz


# ---------------------------------------------------------------------------
# The padded-row copy
# ---------------------------------------------------------------------------

def copy_plan(s_addr: int, d_addr: int, width: int, esize: int) -> Tuple[int, int, int]:
    """(V, h, load bytes) of a row (copy_cols_kernel's copy_plan): h < 4
    head columns up to the f32 destination's first 16-byte boundary, then
    vectors of V = 4 columns, each one 16-byte store, loaded from the
    source (esize-byte elements at s_addr) in pieces as wide as its
    alignment at column h allows (4 esize bytes down to esize); (1, 0,
    esize), all scalar, where no whole vector follows the head."""
    h = (16 - d_addr % 16) % 16 // 4
    if h + 4 > width:
        return 1, 0, esize
    sh = s_addr + esize * h
    lb = 4 * esize
    while lb > esize and sh % lb:
        lb //= 2
    return 4, h, lb


def copy_columns(s_addr: int, d_addr: int, width: int, esize: int) -> List[Tuple[str, int, List[int]]]:
    """(part, lane, columns) of every access of one row of `width` columns
    (a warp a row; rows of at most CP_NARROW columns: one thread, 'narrow'):
    the head's scalar columns, the body's vectors (vector i on lane i %
    32; 'scalar' where no vector fits) and the tail's scalar columns."""
    if width <= CP_NARROW:
        return [("narrow", 0, list(range(width)))]
    V, h, _ = copy_plan(s_addr, d_addr, width, esize)
    if V == 1:
        return [("scalar", c % 32, [c]) for c in range(width)]
    nb = (width - h) // V
    t0 = h + nb * V
    out = [("head", c, [c]) for c in range(h)]
    out += [("body", i % 32, list(range(h + i * V, h + (i + 1) * V))) for i in range(nb)]
    out += [("tail", c - t0, [c]) for c in range(t0, width)]
    return out


# ---------------------------------------------------------------------------
# The pack of e (K5 / K6's operand)
# ---------------------------------------------------------------------------

def pack_load_bytes(s_addr: int) -> int:
    """The widest load piece (bytes) a row of f32 starting at s_addr allows:
    16, 8 or 4 (trunk_pack_e_kernel's pack_load_bytes)."""
    return 16 if s_addr % 16 == 0 else (8 if s_addr % 8 == 0 else 4)


def pack_vec(esize: int) -> int:
    """The columns of a lane's vector, one 16-byte store: 8 bf16, 4 f32."""
    return 16 // esize


def pack_plan(s_addr: int, E: int, width: int, esize: int) -> Tuple[int, int, int]:
    """(load bytes, nfull, nv) of a row: its pieces' width, the vectors
    wholly below E (loaded in pieces) and the row's vectors, the one at
    nfull straddling E where E is not a multiple of the vector."""
    V = pack_vec(esize)
    return pack_load_bytes(s_addr), E // V, width // V


def pack_columns(s_addr: int, E: int, width: int, esize: int,
                 d_addr: int = 0) -> List[Tuple[str, int, List[int], List[Tuple[int, int]], int]]:
    """(kind, lane, columns, load pieces [(address, bytes)], store address)
    of every vector of one row (a warp a row, vector i on lane i % 32, a
    batch of PK_BATCH columns a warp in flight): 'full' vectors load their
    columns in pieces of the plan's width, 'straddle' (columns across E)
    loads its columns below E one by one and zeros the rest, 'pad' loads
    nothing; each stores its 16 bytes at d_addr + 16 i."""
    V = pack_vec(esize)
    lb, nfull, nv = pack_plan(s_addr, E, width, esize)
    out = []
    for v in range(nv):
        cols = list(range(V * v, V * (v + 1)))
        if v < nfull:
            a0 = s_addr + 4 * V * v
            kind, pieces = "full", [(a0 + b, lb) for b in range(0, 4 * V, lb)]
        elif V * v < E:
            kind, pieces = "straddle", [(s_addr + 4 * c, 4) for c in cols if c < E]
        else:
            kind, pieces = "pad", []
        out.append((kind, v % 32, cols, pieces, d_addr + 16 * v))
    return out


def check_pack_operands(out_base: int, ldo: int, esize: int, lde: int, E: int, width: int,
                        e_base: int = 0) -> None:
    """Raise where honerf_trunk_pack_e refuses: out off a 16-byte boundary,
    its rows not a multiple of 16 bytes apart, a width not a multiple of
    PK_VEC, ldo below the width, lde or the width below E, e off a 4-byte
    boundary."""
    if (out_base % 16 or ldo * esize % 16 or width % PK_VEC or ldo < width or lde < E
            or width < E or E < 0 or e_base % 4):
        raise ValueError(f"the pack of e stores 8 columns a lane in 16-byte stores: a "
                         f"16-byte-aligned out whose rows are a multiple of 16 bytes apart, a "
                         f"width a multiple of {PK_VEC} with E <= width <= ldo and lde >= E (out "
                         f"{out_base:#x}, ldo {ldo}, {esize}-byte elements, lde {lde}, E {E}, "
                         f"width {width}, e {e_base:#x})")


def pack_grid(M: int, resident: int, sms: int = 132) -> int:
    """Persistent blocks of one launch: as many as are resident (`resident`
    a SM, the occupancy the C entry point asks for), at most one a
    PK_WARPS rows."""
    return min(_cdiv(M, PK_WARPS), resident * sms)


def pack_rows(M: int, block: int, warp: int, grid: int) -> List[int]:
    """The rows warp `warp` of block `block` packs, in order."""
    return list(range(block * PK_WARPS + warp, M, grid * PK_WARPS))


# ---------------------------------------------------------------------------
# The pose sums (K3's drotT / doff)
# ---------------------------------------------------------------------------

def sm_count(device) -> int:
    """The SMs of a CUDA device (torch's properties); 132, an H100's, for
    any other device (the plain version's default split on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def pose_split(M: int, sms: int = 132) -> Dict[str, int]:
    """Rows per block (`split`) and blocks (S) of one pose_sum_kernel launch
    on M rows: about PS_BLOCKS_PER_SM blocks a SM whatever M is, and at
    least PS_ROW_STEP rows a block (one step of every accumulator), so a
    small M takes few blocks."""
    split = max(PS_ROW_STEP, _cdiv(max(M, 1), PS_BLOCKS_PER_SM * sms))
    return dict(split=split, S=_cdiv(M, split))


def pose_workspace(M: int, sms: int = 132) -> int:
    """Floats of the f32 partial rows of one launch."""
    return pose_split(M, sms)["S"] * PS_COLS


def pose_row_owner(r: int, split: int) -> Tuple[int, int, int, int]:
    """(block s, step i, accumulator k, row lane l) that adds row r:
    r = s split + PS_ROW_STEP i + PS_LANES k + l."""
    s, rest = divmod(r, split)
    i, rest = divmod(rest, PS_ROW_STEP)
    k, lane = divmod(rest, PS_LANES)
    return s, i, k, lane
