"""The layout arithmetic of two per-point kernels, on the host:
`hand_embed_kernel` (csrc/common.cuh: the hand embedding e in tiles of
points staged in shared memory, each stored by one bulk copy) and
`colsum_partial_kernel` (csrc/trunk.cuh: db as a fixed-order column sum).

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
    order itself is `fused_fine.colsum_ordered_plain`.

Nothing on the main path calls these but `colsum_split` and
`colsum_workspace` (the wrapper's split and its scratch check); the CUDA
side computes the same numbers (`honerf_hand_embed_t`, `honerf_colsum`).
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

CONSTANTS = ("EMB_THREADS", "EMB_BLOCKS_PER_SM", "EMB_POINTS_BF16", "EMB_LDE_MAX",
             "EMB_STAGE_FLOATS", "EMB_TILE_BYTES_MAX", "EMB_SMEM_MAX", "CS_THREADS", "CS_WARPS",
             "CS_COLS", "CS_ACC", "CS_ROW_STEP", "CS_BLOCKS", "CS_MAX_TILES")
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
