"""The layout arithmetic of the bf16 GEMMs (csrc/wgmma.cuh: gemm_kernel
and gemm_tn_kernel on wgmma with a TMA ring), on the host.

The constants here are csrc/wgmma.cuh's, under the same names;
tests/test_torch_wgmma_layout.py reads them from the header and holds the
two equal, and holds the functions below against hand-worked cases:

  * `smem_desc` / `desc_fields`: the 64-bit wgmma shared-memory matrix
    descriptor (start address >> 4, leading and stride byte offsets >> 4,
    the swizzle mode);
  * `swizzle128`: where the 128-byte swizzle puts a byte of a tile
    (16-byte chunk c of 128-byte row r lands at chunk c ^ (r % 8));
  * `tma_box_offset` / `wgmma_offset`: the byte a TMA box writes an
    element to, and the byte wgmma reads it from through a descriptor;
  * `gemm_maps` / `tn_maps`: the tensor maps and work split of one launch
    (the concat's two K ranges with their exact extents, the M and N
    tails), and the preconditions TMA sets.

The `K4_*` constants are csrc/fused_sdf.cu's (obj_sdf_fused_kernel, the
object SDF in one launch; tests/test_torch_k4_layout.py holds them to the
source): `k4_offset` is where a tile element lives (the PE's writes),
`k4_acc_cell` which (row, column) an accumulator register holds,
`k4_store_offset` the address the epilogue writes a register pair to, and
`k4_a_desc` the A descriptor wgmma reads the tile through; `k4_smem_bytes`
the block's shared memory, `k4_layers` the producer's K steps a layer.

The `TF_*` / `UC_*` constants are csrc/trunk_fused.cu's (the bf16 hand
trunk in two launches, hand_trunk_fwd_kernel and hand_uchain_kernel;
tests/test_torch_trunk_fused_layout.py holds them to the source):
`tf_phases` / `uc_phases` are the phases of a tile (honerf_trunk_fwd's
table, hand_uchain_kernel's order), `tf_loads` / `uc_loads` the
producer's TMA boxes a K step, `tf_smem_bytes` / `uc_smem_bytes` the
blocks' shared memory, `tf_tile_rows` the rows a consumer thread stores,
and `ring_schedule` a model of the producer, the two consumers, the
ring's barriers and the consumers' turns that finds a deadlock if there
is one.

The `TF32_*` constants are csrc/trunk_fused_f32.cu's (the f32 hand trunk
in two launches, hand_trunk_fwd_f32_kernel and hand_uchain_f32_kernel, on
3xTF32 wgmma; tests/test_torch_trunk_f32_layout.py holds them to the
source): `tf32_offset` is where an f32 tile element lives (TMA's box of e,
the epilogues' writes, the A fragments' reads), `tf32_box_offset` where a
TMA box of f32 puts an element and `tf32_b_read` where a K-major TF32
wgmma reads B; `tf32_phases` / `tf32_uc_phases` the phases of a tile,
`tf32_loads` / `tf32_uc_loads` the producer's two slots a K step,
`tf32_smem_bytes` / `tf32_uc_smem_bytes` the blocks' shared memory,
`tf32_acc_cell` / `tf32_frag_cell` the accumulator's and the A
fragment's cells, `tf32_tile_rows` the tiles a block walks; `ring_schedule`
with `pairs` runs their barriers.  The f32 trunk's backward in two
launches (csrc/trunk_bwd_f32.cu: hand_trunk_ut_f32_kernel,
hand_trunk_dz_f32_kernel, the forward's layout and ring;
tests/test_torch_trunk_bwd_f32_layout.py): `tb32_ut_phases` /
`tb32_dz_phases` their phase tables (`tb32_pieces` de's pieces),
`tb32_loads` both producers' slots.  The f32 color net in two launches
(csrc/color_fused_f32.cu: color_fwd_f32_kernel, color_bwd_f32_kernel, the
same layout and ring; tests/test_torch_color_f32_layout.py): the `CF32_*`
constants, `cf32_fwd_phases` / `cf32_bwd_phases` their phase tables
(`cf32_pieces` dx's pieces), `cf32_loads` both producers' slots (layer
0's two K ranges of boxes), `cf32_smem_bytes` the blocks' shared memory.
The bf16 color net in two launches (csrc/color_fused.cu: color_fwd_kernel,
color_bwd_kernel, the bf16 trunk's tile and 3-stage ring;
tests/test_torch_color_bf16_layout.py): the `CF16_*` constants, `cf16_fwd_phases`
/ `cf16_bwd_phases` their phase tables (`cf16_pieces` dx's pieces),
`cf16_loads` the producers' boxes a K step, `cf16_smem_bytes` the blocks'
shared memory.  The bf16 trunk's backward in two launches
(csrc/trunk_bwd.cu: hand_trunk_ut_kernel, hand_trunk_dz_kernel, the same
tile and ring; tests/test_torch_trunk_bwd_bf16_layout.py): the `TB16_*`
constants, `tb16_ut_phases` / `tb16_dz_phases` their phase tables
(`tb16_pieces` de's pieces), `tb16_loads` the producers' boxes a K step,
`tb16_epi_loads` the chain epilogues' f32 row boxes streamed through the
ring, `tb16_smem_bytes` the blocks' shared memory.

Nothing on the main path calls the functions but `tn_workspace`; the CUDA
side computes the same numbers (`honerf_gemm`, `honerf_gemm_tn`,
`honerf_obj_sdf`, `honerf_trunk_fwd`, `honerf_trunk_uchain`,
`honerf_trunk_fwd_f32`, `honerf_trunk_uchain_f32`, `honerf_trunk_ut_f32`,
`honerf_trunk_dz_f32`, `honerf_color_fwd_f32`, `honerf_color_bwd_f32`,
`honerf_color_fwd`, `honerf_color_bwd`, `honerf_trunk_ut`, `honerf_trunk_dz`).
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Optional, Sequence

BM = 128               # output rows of a tile: two consumer warpgroups x 64
BN = 256               # output columns of a tile: one m64n256k16
BK = 64                # K of a stage: one 128-byte swizzle row of bf16
STAGES = 4
MN_CHUNK = 64          # bf16 columns of one MN-major box
SWIZZLE_BYTES = 128    # the swizzle span: one BK row of bf16
A_BYTES = BM * BK * 2
A_HALF_BYTES = A_BYTES // 2
B_CHUNK_BYTES = BK * MN_CHUNK * 2
B_BYTES = BK * BN * 2
STAGE_BYTES = A_BYTES + B_BYTES
RING_BYTES = STAGES * STAGE_BYTES
SBO = 1024
K_MAJOR_LBO = 16
MN_MAJOR_LBO = B_CHUNK_BYTES
K_MAJOR_K16 = 32
MN_MAJOR_K16 = 2048
BN_TN = 128            # gemm_tn_kernel's output columns: one m64n128k16 (fresh sums a stage)
TN_STAGE_BYTES = A_BYTES + BK * BN_TN * 2
EPI_LD = 44
EPI_WARP_FLOATS = 16 * EPI_LD
CONSUMER_WARPS = 8
EPI_BYTES = CONSUMER_WARPS * EPI_WARP_FLOATS * 4
THREADS = 384
SMEM_BYTES = 1024 + RING_BYTES + EPI_BYTES + 2 * STAGES * 8
SMEM_LIMIT = 232448    # the dynamic shared memory one H100 block may use

CONSTANTS = ("BM", "BN", "BK", "STAGES", "MN_CHUNK", "A_BYTES", "A_HALF_BYTES",
             "B_CHUNK_BYTES", "B_BYTES", "STAGE_BYTES", "RING_BYTES", "SBO", "K_MAJOR_LBO",
             "MN_MAJOR_LBO", "K_MAJOR_K16", "MN_MAJOR_K16", "BN_TN", "TN_STAGE_BYTES", "EPI_LD",
             "EPI_WARP_FLOATS", "CONSUMER_WARPS", "EPI_BYTES", "THREADS", "SMEM_BYTES")


# csrc/fused_sdf.cu: obj_sdf_fused_kernel
K4_TILE = 128          # points a tile: two consumer warpgroups x 64
K4_EP = 64             # PE columns: one 128-byte swizzle row of bf16
K4_WIDTH = 256         # the widest layer: one m64n256k16
K4_CHUNK_BYTES = K4_TILE * 128                    # 64 columns of the tile's rows
K4_ACT_BYTES = K4_WIDTH // 64 * K4_CHUNK_BYTES    # the activation tile
K4_ES_BYTES = K4_CHUNK_BYTES                      # es, kept to the skip
K4_STAGES = 4
K4_STAGE_BYTES = 64 * K4_WIDTH * 2                # 64 k-rows of one layer's weights
K4_RING_BYTES = K4_STAGES * K4_STAGE_BYTES
K4_SMEM_BYTES = 1024 + K4_ACT_BYTES + K4_ES_BYTES + K4_RING_BYTES + 2 * K4_STAGES * 8
K4_MAX_LAYERS = 12
K4_CONSTANTS = ("K4_TILE", "K4_EP", "K4_WIDTH", "K4_CHUNK_BYTES", "K4_ACT_BYTES", "K4_ES_BYTES",
                "K4_STAGES", "K4_STAGE_BYTES", "K4_RING_BYTES", "K4_SMEM_BYTES", "K4_MAX_LAYERS")


# csrc/trunk_fused.cu: hand_trunk_fwd_kernel, hand_uchain_kernel
TF_TILE = 128          # points a tile: two consumer warpgroups x 64
TF_WIDTH = 256         # the widest hidden layer: one m64n256k16
TF_CHUNK_BYTES = TF_TILE * 128                    # 64 columns of the tile's rows
TF_ACT_BYTES = TF_WIDTH // 64 * TF_CHUNK_BYTES    # the activation (or a t) tile
TF_A_BYTES = TF_CHUNK_BYTES                       # e's box of a stage: 64 columns x 128 rows
TF_B_BYTES = 64 * TF_WIDTH * 2                    # 64 k-rows of 256 weight columns
TF_STAGE_BYTES = TF_A_BYTES + TF_B_BYTES
TF_STAGES = 3
TF_RING_BYTES = TF_STAGES * TF_STAGE_BYTES
TF_SMEM_BYTES = 1024 + TF_ACT_BYTES + TF_RING_BYTES + 2 * TF_STAGES * 8
TF_MAX_LAYERS = 12
TF_MAX_PHASES = 16
UC_STAGES = 3
UC_STAGE_BYTES = TF_B_BYTES
UC_RING_BYTES = UC_STAGES * UC_STAGE_BYTES
UC_SMEM_BYTES = 1024 + 2 * TF_ACT_BYTES + UC_RING_BYTES + 2 * UC_STAGES * 8
UC_PIECE = 128         # u columns a layer-0 piece: two m64n128k16 accumulators
TF_CONSTANTS = ("TF_TILE", "TF_WIDTH", "TF_CHUNK_BYTES", "TF_ACT_BYTES", "TF_A_BYTES",
                "TF_B_BYTES", "TF_STAGE_BYTES", "TF_STAGES", "TF_RING_BYTES", "TF_SMEM_BYTES",
                "TF_MAX_LAYERS", "TF_MAX_PHASES", "UC_STAGES", "UC_STAGE_BYTES", "UC_RING_BYTES",
                "UC_SMEM_BYTES", "UC_PIECE")
TF_HIDDEN, TF_Z, TF_SDF = 0, 1, 2

# csrc/trunk_fused_f32.cu: hand_trunk_fwd_f32_kernel, hand_uchain_f32_kernel
TF32_TILE = 64         # points a tile: both consumers read its 64 rows, each half the columns
TF32_WIDTH = 256
TF32_BK = 32           # k of a K step: one 128-byte swizzle row of f32
TF32_CHUNK_BYTES = TF32_TILE * 128                    # 32 columns of the tile's rows
TF32_ACT_BYTES = TF32_WIDTH // TF32_BK * TF32_CHUNK_BYTES
TF32_A_BYTES = TF32_CHUNK_BYTES                       # e's box: 32 columns x 64 rows
TF32_BOX_ROWS = 64                                    # B rows of one TMA box
TF32_BOX_BYTES = TF32_BOX_ROWS * 128
TF32_B_BYTES = TF32_WIDTH * 128                       # 256 B rows x 32 k
TF32_STAGE_BYTES = TF32_A_BYTES + TF32_B_BYTES
TF32_STAGES = 4
TF32_RING_BYTES = TF32_STAGES * TF32_STAGE_BYTES
TF32_SMEM_BYTES = 1024 + TF32_ACT_BYTES + TF32_RING_BYTES + 2 * TF32_STAGES * 8
TF32_MAX_LAYERS = 10
TF32_MAX_PHASES = 14
TF32_UC_STAGES = 3
TF32_UC_STAGE_BYTES = TF32_B_BYTES
TF32_UC_RING_BYTES = TF32_UC_STAGES * TF32_UC_STAGE_BYTES
TF32_UC_SMEM_BYTES = 1024 + 2 * TF32_ACT_BYTES + TF32_UC_RING_BYTES + 2 * TF32_UC_STAGES * 8
TF32_PIECE = 256       # u columns a piece: two phases (the skip's part, layer 0's)
TF32_UC_MAX_PHASES = 40
TF32_CONSTANTS = ("TF32_TILE", "TF32_WIDTH", "TF32_BK", "TF32_CHUNK_BYTES", "TF32_ACT_BYTES",
                  "TF32_A_BYTES", "TF32_BOX_ROWS", "TF32_BOX_BYTES", "TF32_B_BYTES",
                  "TF32_STAGE_BYTES", "TF32_STAGES", "TF32_RING_BYTES", "TF32_SMEM_BYTES",
                  "TF32_MAX_LAYERS", "TF32_MAX_PHASES", "TF32_UC_STAGES", "TF32_UC_STAGE_BYTES",
                  "TF32_UC_RING_BYTES", "TF32_UC_SMEM_BYTES", "TF32_PIECE",
                  "TF32_UC_MAX_PHASES")
T32_HIDDEN, T32_Z = 0, 1

# csrc/trunk_bwd_f32.cu: hand_trunk_ut_f32_kernel, hand_trunk_dz_f32_kernel
# (both with the forward's shared memory, TF32_SMEM_BYTES: the tile and a
# 4-slot ring of A's box and B's rows)
TB32_MAX_PHASES = 40
TB32_CONSTANTS = ("TB32_MAX_PHASES",)
TB32_UT, TB32_CHAIN, TB32_SKIP, TB32_ZERO = 0, 1, 2, 3

# csrc/color_fused_f32.cu: color_fwd_f32_kernel, color_bwd_f32_kernel (both
# with the f32 trunk forward's shared memory: the tile and a 4-slot ring of
# A's box and B's rows)
CF32_MAX_PHASES = 24
CF32_PIECE = 256       # dx columns a piece
CF32_SMEM_BYTES = TF32_SMEM_BYTES
CF32_COLORS = 3        # the real columns of the last layer
CF32_CONSTANTS = ("CF32_MAX_PHASES", "CF32_PIECE", "CF32_SMEM_BYTES", "CF32_COLORS")
CF32_RELU, CF32_SIGMOID, CF32_MASK, CF32_DX = 0, 1, 2, 3

# csrc/color_fused.cu: color_fwd_kernel, color_bwd_kernel (the bf16 color
# net: the bf16 trunk's tile of 128 points and a 3-stage ring of an A box
# and 64 k-rows of B)
CF16_TILE = 128
CF16_WIDTH = 256
CF16_CHUNK_BYTES = CF16_TILE * 128
CF16_ACT_BYTES = CF16_WIDTH // 64 * CF16_CHUNK_BYTES
CF16_A_BYTES = CF16_CHUNK_BYTES
CF16_B_BYTES = 64 * CF16_WIDTH * 2
CF16_STAGE_BYTES = CF16_A_BYTES + CF16_B_BYTES
CF16_STAGES = 3
CF16_RING_BYTES = CF16_STAGES * CF16_STAGE_BYTES
CF16_SMEM_BYTES = 1024 + CF16_ACT_BYTES + CF16_RING_BYTES + 2 * CF16_STAGES * 8
CF16_MAX_LAYERS = 10
CF16_MAX_PHASES = 24
CF16_PIECE = 256       # dx columns a piece
CF16_COLORS = 3        # the real columns of the last layer
CF16_CONSTANTS = ("CF16_TILE", "CF16_WIDTH", "CF16_CHUNK_BYTES", "CF16_ACT_BYTES",
                  "CF16_A_BYTES", "CF16_B_BYTES", "CF16_STAGE_BYTES", "CF16_STAGES",
                  "CF16_RING_BYTES", "CF16_SMEM_BYTES", "CF16_MAX_LAYERS", "CF16_MAX_PHASES",
                  "CF16_PIECE", "CF16_COLORS")
CF16_RELU, CF16_SIGMOID, CF16_MASK, CF16_DX = 0, 1, 2, 3

# csrc/trunk_bwd.cu: hand_trunk_ut_kernel, hand_trunk_dz_kernel (the bf16
# trunk's backward: the bf16 trunk's tile of 128 points and a 3-stage ring
# of an A box and 64 k-rows of B)
TB16_TILE = 128
TB16_WIDTH = 256
TB16_CHUNK_BYTES = TB16_TILE * 128
TB16_ACT_BYTES = TB16_WIDTH // 64 * TB16_CHUNK_BYTES
TB16_A_BYTES = TB16_CHUNK_BYTES
TB16_B_BYTES = 64 * TB16_WIDTH * 2
TB16_STAGE_BYTES = TB16_A_BYTES + TB16_B_BYTES
TB16_STAGES = 3
TB16_RING_BYTES = TB16_STAGES * TB16_STAGE_BYTES
TB16_SMEM_BYTES = 1024 + TB16_ACT_BYTES + TB16_RING_BYTES + 2 * TB16_STAGES * 8
DZ16_STAGE_BYTES = TB16_B_BYTES   # the downward kernel's stages: B alone
DZ16_RING_BYTES = TB16_STAGES * DZ16_STAGE_BYTES
DZ16_SMEM_BYTES = 1024 + 2 * TB16_ACT_BYTES + DZ16_RING_BYTES + 2 * TB16_STAGES * 8
TB16_MAX_LAYERS = 10
TB16_MAX_PHASES = 24
DZ16_PIECE = 128       # de columns a piece: the skip's and layer 0's m64n128k16 sums
TB16_EPI_COLS = 32     # f32 columns of a chain epilogue's rows a ring step
TB16_ROWS_BYTES = TB16_TILE * TB16_EPI_COLS * 4   # one f32 row box of a step
TB16_CONSTANTS = ("TB16_TILE", "TB16_WIDTH", "TB16_CHUNK_BYTES", "TB16_ACT_BYTES",
                  "TB16_A_BYTES", "TB16_B_BYTES", "TB16_STAGE_BYTES", "TB16_STAGES",
                  "TB16_RING_BYTES", "TB16_SMEM_BYTES", "DZ16_STAGE_BYTES", "DZ16_RING_BYTES",
                  "DZ16_SMEM_BYTES", "TB16_MAX_LAYERS", "TB16_MAX_PHASES", "DZ16_PIECE",
                  "TB16_EPI_COLS", "TB16_ROWS_BYTES")
TB16_UT, TB16_CHAIN, TB16_DE = 0, 1, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Descriptors and the swizzle
# ---------------------------------------------------------------------------

def smem_desc(addr: int, lbo: int, sbo: int) -> int:
    """The wgmma descriptor of a 128-byte-swizzled operand at shared byte
    address addr (wgmma.cuh: smem_desc)."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo & 0x3FFFF) >> 4) << 16)
            | (((sbo & 0x3FFFF) >> 4) << 32) | (1 << 62))


def desc_fields(desc: int) -> Dict[str, int]:
    """A descriptor's fields, in bytes where they are offsets."""
    return dict(start=(desc & 0x3FFF) << 4, lbo=((desc >> 16) & 0x3FFF) << 4,
                sbo=((desc >> 32) & 0x3FFF) << 4, base_offset=(desc >> 49) & 7,
                swizzle=(desc >> 62) & 3)


def swizzle128(offset: int) -> int:
    """The byte a 128-byte swizzle puts `offset` (from a 1024-byte-aligned
    base) at: bits 4-6 (the 16-byte chunk) XOR bits 7-9 (the row mod 8)."""
    return offset ^ (((offset >> 7) & 7) << 4)


def tma_box_offset(row: int, col: int) -> int:
    """Byte of a 128-byte-swizzled TMA box (64 bf16 a row) at which the
    element in box row `row`, column `col` lands."""
    assert 0 <= col < SWIZZLE_BYTES // 2
    return swizzle128(row * SWIZZLE_BYTES + 2 * col)


def wgmma_offset(desc: int, mn: int, k: int, k_major: bool) -> int:
    """The byte wgmma reads element (mn, k) of its operand from (mn: the
    operand's M or N index, k within its 16), through descriptor desc:
    K-major, rows of 128 bytes 8 to an SBO group; MN-major, 64 columns a
    128-byte row, the next 64 an LBO on, 8 k-rows an SBO group."""
    f = desc_fields(desc)
    if k_major:
        linear = f["start"] + (mn // 8) * f["sbo"] + (mn % 8) * SWIZZLE_BYTES + 2 * k
    else:
        linear = (f["start"] + (mn // MN_CHUNK) * f["lbo"] + (k // 8) * f["sbo"]
                  + (k % 8) * SWIZZLE_BYTES + 2 * (mn % MN_CHUNK))
    return swizzle128(linear)


def a_desc(stage_base: int, consumer: int, kk: int, tn: bool) -> int:
    """The A descriptor of consumer `consumer`'s k16 step kk (wgmma.cuh:
    mainloop): gemm_kernel's A K-major, the TN product's X^T MN-major."""
    a = stage_base + consumer * A_HALF_BYTES
    if tn:
        return smem_desc(a + kk * MN_MAJOR_K16, MN_MAJOR_LBO, SBO)
    return smem_desc(a + kk * K_MAJOR_K16, K_MAJOR_LBO, SBO)


def b_desc(stage_base: int, kk: int) -> int:
    """The B descriptor of k16 step kk (MN-major, the transpose bit)."""
    return smem_desc(stage_base + A_BYTES + kk * MN_MAJOR_K16, MN_MAJOR_LBO, SBO)


# ---------------------------------------------------------------------------
# Tensor maps and the work split
# ---------------------------------------------------------------------------

class TensorMap(NamedTuple):
    """One 2D bf16 tensor map: `offset` elements past the operand's base,
    `inner` x `outer` elements, rows `row_bytes` apart, boxes of
    box_inner x box_outer."""

    offset: int
    inner: int
    outer: int
    row_bytes: int
    box_inner: int
    box_outer: int


def _check_operand(what: str, base: int, ld: int) -> None:
    if base % 16 or (2 * ld) % 16:
        raise ValueError(f"{what}: TMA takes a 16-byte-aligned base and a row stride that is "
                         f"a multiple of 16 bytes (base {base:#x}, stride {ld} elements)")


def gemm_maps(M: int, K1: int, K2: int, N: int, lda1: int, lda2: int, ldb: int,
              bases=(0, 0, 0)) -> Dict[str, object]:
    """gemm_kernel's launch (common.cuh: honerf_gemm): the tensor maps of
    A1, A2 and B's two row ranges, the K steps of each part, the column
    tiles and the work units.  bases: the byte addresses of A1, A2, B."""
    if K1 <= 0 or K2 < 0 or N % 8:
        raise ValueError("K1 > 0, K2 >= 0 and N % 8 == 0")
    _check_operand("A1", bases[0], lda1)
    _check_operand("B", bases[2], ldb)
    maps = {"a1": TensorMap(0, K1, M, 2 * lda1, BK, BM),
            "b1": TensorMap(0, N, K1, 2 * ldb, MN_CHUNK, BK)}
    if K2:
        _check_operand("A2", bases[1], lda2)
        maps["a2"] = TensorMap(0, K2, M, 2 * lda2, BK, BM)
        maps["b2"] = TensorMap(K1 * ldb, N, K2, 2 * ldb, MN_CHUNK, BK)
    tiles_n = _cdiv(N, BN)
    return dict(maps=maps, kt1=_cdiv(K1, BK), kt2=_cdiv(K2, BK), tiles_n=tiles_n,
                units=_cdiv(M, BM) * tiles_n)


def gemm_steps(M: int, K1: int, K2: int, N: int, lda1: int, lda2: int, ldb: int):
    """[(map, inner coordinate, row coordinate) of the A box, [B boxes]]
    per K step of one output tile (the producer's loads, rows from 0)."""
    g = gemm_maps(M, K1, K2, N, lda1, lda2, ldb)
    steps: List[tuple] = []
    for k in range(g["kt1"] + g["kt2"]):
        first = k < g["kt1"]
        kk = (k if first else k - g["kt1"]) * BK
        a, b = ("a1", "b1") if first else ("a2", "b2")
        steps.append(((a, kk, 0), [(b, j * MN_CHUNK, kk) for j in range(BN // MN_CHUNK)]))
    return steps


def tn_maps(M: int, K: int, N: int, ldx: int, ldy: int, split: int,
            bases=(0, 0)) -> Dict[str, object]:
    """gemm_tn_kernel's launch (trunk.cuh: honerf_gemm_tn): X's and Y's
    tensor maps, the partials' padded extents (BM x BN_TN tiles), the work
    units and each split's K steps."""
    if split <= 0 or split % BK or K % 8 or N % 8:
        raise ValueError(f"split a positive multiple of {BK}, K and N multiples of 8")
    _check_operand("X", bases[0], ldx)
    _check_operand("Y", bases[1], ldy)
    S = _cdiv(M, split)
    Kp, Np = _cdiv(K, BM) * BM, _cdiv(N, BN_TN) * BN_TN
    tiles = (Kp // BM) * (Np // BN_TN)
    return dict(maps={"a1": TensorMap(0, K, M, 2 * ldx, MN_CHUNK, BK),
                      "b1": TensorMap(0, N, M, 2 * ldy, MN_CHUNK, BK)},
                splits=S, Kp=Kp, Np=Np, tiles_n=Np // BN_TN, tiles=tiles, units=tiles * S,
                steps=[_cdiv(min(M, (s + 1) * split) - s * split, BK) for s in range(S)])


def tn_split(K: int, N: int, m: int, blocks: int) -> int:
    """Points per split of gemm_tn_kernel for m points: enough work units
    for about `blocks` (one per SM), a multiple of BK."""
    tiles = _cdiv(K, BM) * _cdiv(N, BN_TN)
    splits = max(1, min(_cdiv(blocks, tiles), _cdiv(m, 256)))
    return _cdiv(_cdiv(m, splits), BK) * BK


def tn_workspace(K: int, N: int, m: int, split: int) -> int:
    """Floats of the f32 partials of one gemm_tn_kernel launch."""
    return _cdiv(m, split) * _cdiv(K, BM) * BM * _cdiv(N, BN_TN) * BN_TN


# ---------------------------------------------------------------------------
# The object SDF in one launch (csrc/fused_sdf.cu: obj_sdf_fused_kernel)
# ---------------------------------------------------------------------------

def k4_offset(row: int, col: int) -> int:
    """Byte of the activation tile (from its 1024-byte-aligned base) that
    holds element (row, col): chunks of 64 columns, each a TMA box's
    layout (k4_offset in the source; the PE writes here)."""
    assert 0 <= row < K4_TILE and 0 <= col < K4_WIDTH
    return (col // 64) * K4_CHUNK_BYTES + tma_box_offset(row, col % 64)


def k4_acc_cell(thread: int, i: int):
    """(row, column) of the tile that accumulator i of consumer thread
    `thread` (0-255 over both consumer warpgroups) holds after a layer:
    acc[4j + q] is row 64 c + 16 w + g + 8 (q >> 1), column 8 j + 2 t +
    (q & 1), with c the warpgroup, w its warp, g = lane / 4, t = lane % 4."""
    c, w, lane = thread // 128, (thread % 128) // 32, thread % 32
    g, t = lane // 4, lane % 4
    j, q = divmod(i, 4)
    return 64 * c + 16 * w + g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1)


def k4_store_offset(thread: int, j: int, h: int) -> int:
    """The byte the epilogue writes thread `thread`'s bf16 pair (acc[4j +
    2h], acc[4j + 2h + 1]) to: chunk j // 8, row ra + 8 h, the 16-byte
    column chunk j % 8 swizzled by the row, 4 t bytes in."""
    c, w, lane = thread // 128, (thread % 128) // 32, thread % 32
    g, t = lane // 4, lane % 4
    row = 64 * c + 16 * w + g + 8 * h
    return (j >> 3) * K4_CHUNK_BYTES + row * 128 + (((j & 7) ^ (row & 7)) << 4) + 4 * t


def k4_a_desc(base: int, chunk: int, consumer: int, kk: int, es: bool = False) -> int:
    """The A descriptor of consumer `consumer`'s k16 step kk over the
    activation tile's chunk `chunk` (or over es, K4_ACT_BYTES past the
    tile), the tile at shared byte address `base`."""
    a = base + (K4_ACT_BYTES if es else chunk * K4_CHUNK_BYTES) + consumer * K4_CHUNK_BYTES // 2
    return smem_desc(a + kk * K_MAJOR_K16, K_MAJOR_LBO, SBO)


def k4_smem_bytes() -> Dict[str, int]:
    """The block's shared memory by part (bytes), the total K4_SMEM_BYTES."""
    return dict(align=1024, act=K4_ACT_BYTES, es=K4_ES_BYTES, ring=K4_RING_BYTES,
                barriers=2 * K4_STAGES * 8)


def k4_layers(rows, cols, skips) -> List[Dict[str, int]]:
    """Per layer (honerf_obj_sdf's check and table): kt (K steps of 64 over
    the activation), skip (one more over es), n (columns), the k-rows of
    the weights each K step's stage holds."""
    out, d_in = [], K4_EP
    for l, (r, n, sk) in enumerate(zip(rows, cols, skips)):
        kt_rows = r - (K4_EP if sk else 0)
        if n % 64 or n > K4_WIDTH or kt_rows != d_in or (sk and l == 0):
            raise ValueError(f"layer {l}: {r} rows, {n} columns, skip {sk}: not a K4 layer")
        steps = kt_rows // 64 + (1 if sk else 0)
        out.append(dict(kt=kt_rows // 64, skip=int(bool(sk)), n=n,
                        k_rows=[64 * k for k in range(steps)]))
        d_in = n
    return out


# ---------------------------------------------------------------------------
# The bf16 hand trunk in two launches (csrc/trunk_fused.cu)
# ---------------------------------------------------------------------------

def tf_offset(row: int, col: int) -> int:
    """Byte of a trunk tile (activation or t; from its 1024-byte-aligned
    base) that holds element (row, col): k4_offset's layout (tf_offset in
    the source)."""
    assert 0 <= row < TF_TILE and 0 <= col < TF_WIDTH
    return (col // 64) * TF_CHUNK_BYTES + tma_box_offset(row, col % 64)


def tf_smem_bytes() -> Dict[str, int]:
    """hand_trunk_fwd_kernel's shared memory by part (bytes): the
    activation tile, the ring of e's box + the weights' 64 k-rows."""
    return dict(align=1024, act=TF_ACT_BYTES, ring=TF_RING_BYTES, barriers=2 * TF_STAGES * 8)


def uc_smem_bytes() -> Dict[str, int]:
    """hand_uchain_kernel's: two t tiles (the chain's, the skip's kept to
    layer 0) and a ring of 64 k-rows of W^T."""
    return dict(align=1024, t=2 * TF_ACT_BYTES, ring=UC_RING_BYTES, barriers=2 * UC_STAGES * 8)


def tf_phases(Ep: int, Hp: int, rows: Sequence[int], cols: Sequence[int], skip: int,
              n_store: Optional[int] = None, sdf: bool = False) -> List[Dict[str, int]]:
    """honerf_trunk_fwd's phase table: per hidden layer one phase (K steps
    over the tile, then over e's boxes: layer 0 and the skip), then the
    last layer's pieces: K1's sdf column (sdf), z's first n_store columns
    in pieces of up to 256 (m64n64k16 for a 64-column one), or none.
    Raises ValueError where the entry point refuses the shapes."""
    n = len(rows)
    if (not 3 <= n <= TF_MAX_LAYERS or not 0 < skip < n - 1 or Hp <= 0 or Hp % 64
            or Hp > TF_WIDTH or Ep <= 0 or Ep % 64 or (sdf and n_store)):
        raise ValueError("not a fused trunk")
    out = []
    for l in range(n):
        last = l + 1 == n
        want = Ep if l == 0 else (Hp + Ep if l == skip else Hp)
        if rows[l] != want or (not last and cols[l] != Hp) or cols[l] % 64:
            raise ValueError(f"layer {l}: {rows[l]} x {cols[l]} is not a fused trunk layer")
        base = dict(layer=l, n0=0, boxes=Hp // 64, kind=TF_HIDDEN, narrow=0, prescale=0,
                    act_steps=Hp // 64, e_steps=0, e_row0=0, scale_e=0)
        if not last:
            out.append(dict(base, act_steps=0 if l == 0 else Hp // 64,
                            e_steps=Ep // 64 if l in (0, skip) else 0,
                            e_row0=0 if l == 0 else Hp, scale_e=int(l == skip),
                            prescale=int(l + 1 == skip)))
        elif sdf:
            out.append(dict(base, boxes=1, kind=TF_SDF, narrow=1))
        elif n_store:
            if n_store > cols[l]:
                raise ValueError("n_store past the last layer's columns")
            for n0 in range(0, n_store, TF_WIDTH):
                width = min(TF_WIDTH, cols[l] - n0)
                out.append(dict(base, n0=n0, boxes=width // 64, kind=TF_Z,
                                narrow=int(width == 64)))
    if len(out) > TF_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def tf_loads(phases, tile: int) -> List[List[tuple]]:
    """The producer's TMA loads, per phase and K step: (A, [B ...]) with A
    e's box at (column, row) or None, each B (layer, column, k-row)."""
    out = []
    for ph in phases:
        steps = []
        for k in range(ph["act_steps"] + ph["e_steps"]):
            ke = k - ph["act_steps"]
            a = (64 * ke, TF_TILE * tile) if ke >= 0 else None
            row = ph["e_row0"] + 64 * ke if ke >= 0 else 64 * k
            steps.append((a, [(ph["layer"], ph["n0"] + 64 * j, row)
                              for j in range(ph["boxes"])]))
        out.append(steps)
    return out


def uc_phases(n_layers: int, skip: int, Hp: int, Ep: int, with_u: bool) -> List[Dict[str, int]]:
    """hand_uchain_kernel's phases of a tile: the chain layers n-2 .. 1 (A
    = t tile src, the new t into tile dst: with u the skip writes tile 1
    and tile 0 keeps the skip's t), then with u layer 0's pieces of
    UC_PIECE columns (the skip's t tile 0 and layer 0's t tile 1)."""
    out = []
    for l in range(n_layers - 2, 0, -1):
        out.append(dict(kind="chain", layer=l, n0=0, boxes=Hp // 64,
                        src=int(with_u and l < skip), dst=int(with_u and l <= skip)))
    if with_u:
        for n0 in range(0, Ep, UC_PIECE):
            out.append(dict(kind="piece", layer=0, n0=n0, boxes=min(UC_PIECE, Ep - n0) // 64,
                            src=0, dst=-1))
    return out


def uc_loads(phases, Hp: int, skip: int) -> List[List[list]]:
    """The u-chain producer's loads, per phase and K step: [(stage byte,
    map layer, column, k-row) ...]: a chain layer's boxes of W_l^T at 0,
    8 KB, ...; a piece's skip boxes (W_skip^T's columns from Hp) at 0 and
    8 KB, layer 0's at 16 KB and 24 KB."""
    out = []
    for ph in phases:
        steps = []
        for k in range(Hp // 64):
            if ph["kind"] == "chain":
                steps.append([(j * B_CHUNK_BYTES, ph["layer"], 64 * j, 64 * k)
                              for j in range(ph["boxes"])])
            else:
                steps.append([(j * B_CHUNK_BYTES, skip, Hp + ph["n0"] + 64 * j, 64 * k)
                              for j in range(ph["boxes"])]
                             + [(UC_STAGE_BYTES // 2 + j * B_CHUNK_BYTES, 0, ph["n0"] + 64 * j,
                                 64 * k) for j in range(ph["boxes"])])
        out.append(steps)
    return out


def tf_tile_rows(M: int, sms: int = 132) -> Dict[int, List[int]]:
    """Block -> the tiles it walks (one persistent block an SM, at most one
    a tile): blockIdx.x, + gridDim.x, ... below ceil(M / TF_TILE)."""
    tiles = _cdiv(M, TF_TILE)
    grid = min(tiles, sms)
    return {b: list(range(b, tiles, grid)) for b in range(grid)}


def tf_thread_rows(tile: int, thread: int) -> List[int]:
    """The two points consumer thread `thread` (0-255 over both consumer
    warpgroups) stores of a tile: grow0 = tile * 128 + ra and grow0 + 8,
    ra = 64 c + 16 w + lane / 4 (k4_acc_cell's rows)."""
    c, w, lane = thread // 128, (thread % 128) // 32, thread % 32
    ra = 64 * c + 16 * w + lane // 4
    return [tile * TF_TILE + ra, tile * TF_TILE + ra + 8]


# ---------------------------------------------------------------------------
# The f32 hand trunk in two launches (csrc/trunk_fused_f32.cu)
# ---------------------------------------------------------------------------

def tf32_box_offset(row: int, col: int) -> int:
    """Byte of a 128-byte-swizzled TMA box of f32 (32 a row) at which the
    element in box row `row`, column `col` lands."""
    assert 0 <= col < TF32_BK
    return swizzle128(row * SWIZZLE_BYTES + 4 * col)


def tf32_offset(row: int, col: int) -> int:
    """Byte of an f32 trunk tile (from its 1024-byte-aligned base) that
    holds element (row, col): chunks of 32 columns, each 64 rows of 128
    bytes with the 128-byte swizzle (t32_offset in the source)."""
    assert 0 <= row < TF32_TILE and 0 <= col < TF32_WIDTH
    return (col // TF32_BK) * TF32_CHUNK_BYTES + tf32_box_offset(row, col % TF32_BK)


def tf32_b_read(desc: int, n: int, k: int) -> int:
    """The byte a K-major TF32 wgmma reads B element (n, k) from (k within
    its 8) through descriptor desc: rows of 128 bytes, 8 to an SBO group
    (TF32 wgmma has no MN-major operand)."""
    f = desc_fields(desc)
    return swizzle128(f["start"] + (n // 8) * f["sbo"] + (n % 8) * SWIZZLE_BYTES + 4 * k)


def tf32_smem_bytes() -> Dict[str, int]:
    """hand_trunk_fwd_f32_kernel's shared memory by part (bytes): the f32
    activation tile, the ring of slots (e's box + up to 256 B rows)."""
    return dict(align=1024, act=TF32_ACT_BYTES, ring=TF32_RING_BYTES,
                barriers=2 * TF32_STAGES * 8)


def tf32_uc_smem_bytes() -> Dict[str, int]:
    """hand_uchain_f32_kernel's: two f32 t tiles and a ring of B rows."""
    return dict(align=1024, t=2 * TF32_ACT_BYTES, ring=TF32_UC_RING_BYTES,
                barriers=2 * TF32_UC_STAGES * 8)


def tf32_phases(Ep: int, Hp: int, rows: Sequence[int], cols: Sequence[int], skip: int,
                n_store: Optional[int] = None) -> List[Dict[str, int]]:
    """honerf_trunk_fwd_f32's phase table: per hidden layer one phase (K
    steps of 32 over the tile, then over e's boxes: layer 0 and the skip,
    the skip's scaled), then z's first n_store columns in pieces of 256,
    128 or 64 (the widest that fits), or none.  Raises ValueError where the
    entry point refuses the shapes."""
    n = len(rows)
    if (not 3 <= n <= TF32_MAX_LAYERS or not 0 < skip < n - 1 or Hp not in (64, 128, 256)
            or Ep <= 0 or Ep % 64):
        raise ValueError("not an f32 fused trunk")
    out = []
    for l in range(n):
        last = l + 1 == n
        want = Ep if l == 0 else (Hp + Ep if l == skip else Hp)
        if rows[l] != want or (not last and cols[l] != Hp) or cols[l] % 64:
            raise ValueError(f"layer {l}: {rows[l]} x {cols[l]} is not a fused trunk layer")
        if not last:
            out.append(dict(act_steps=0 if l == 0 else Hp // TF32_BK,
                            e_steps=Ep // TF32_BK if l in (0, skip) else 0,
                            e_row0=0 if l == 0 else Hp, scale=int(l == skip), layer=l, n0=0,
                            width=Hp, kind=T32_HIDDEN))
        elif n_store:
            if n_store > cols[l]:
                raise ValueError("n_store past the last layer's columns")
            n0 = 0
            while n0 < n_store:
                rem = cols[l] - n0
                width = 256 if rem >= 256 else (128 if rem >= 128 else 64)
                out.append(dict(act_steps=Hp // TF32_BK, e_steps=0, e_row0=0, scale=0, layer=l,
                                n0=n0, width=width, kind=T32_Z))
                n0 += width
    if len(out) > TF32_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def tf32_loads(phases, tile: int, out_rows: Sequence[int]) -> List[List[tuple]]:
    """The forward producer's TMA loads, per phase and slot (two a K step:
    B's small rows, then its big rows): (A, [B ...]) with A e's box at
    (column, row) or None (e's box rides in the small slot of an e step),
    each B (layer, k, row) of the layer's [big; small] W^T map, out_rows[l]
    its first small row."""
    out = []
    for ph in phases:
        slots = []
        for k in range(ph["act_steps"] + ph["e_steps"]):
            ke = k - ph["act_steps"]
            kc = ph["e_row0"] + TF32_BK * ke if ke >= 0 else TF32_BK * k
            for half in (0, 1):
                a = (TF32_BK * ke, TF32_TILE * tile) if ke >= 0 and half == 0 else None
                row0 = (out_rows[ph["layer"]] if half == 0 else 0) + ph["n0"]
                slots.append((a, [(ph["layer"], kc, row0 + TF32_BOX_ROWS * j)
                                  for j in range(ph["width"] // TF32_BOX_ROWS)]))
        out.append(slots)
    return out


def tf32_uc_phases(n_layers: int, skip: int, Hp: int, Ep: int,
                   with_u: bool) -> List[Dict[str, int]]:
    """honerf_trunk_uchain_f32's phase table: the chain layers n-2 .. 1
    (A = t tile src, the new t into tile dst: with u the skip writes tile 1
    and tile 0 keeps the skip's t), then with u two phases a piece of u's
    columns (256, 128 or 64, the widest that fits): the skip's part
    (W_skip's rows from Hp + n0, A = tile 0; u = its sum / sqrt2) and layer
    0's (W_0's rows from n0, A = tile 1; u += its sum)."""
    out = []
    for l in range(n_layers - 2, 0, -1):
        out.append(dict(kind="chain", layer=l, row0=0, width=Hp,
                        src=int(with_u and l < skip), dst=int(with_u and l <= skip)))
    n0 = 0
    while with_u and n0 < Ep:
        rem = Ep - n0
        width = TF32_PIECE if rem >= TF32_PIECE else (128 if rem >= 128 else 64)
        out.append(dict(kind="skip", layer=skip, row0=Hp + n0, width=width, src=0, dst=-1))
        out.append(dict(kind="zero", layer=0, row0=n0, width=width, src=1, dst=-1))
        n0 += width
    if len(out) > TF32_UC_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def tf32_uc_loads(phases, Hp: int, in_rows: Sequence[int]) -> List[List[list]]:
    """The u-chain producer's loads, per phase and slot (two a K step of 32
    over Hp: small rows, then big): [(slot byte, layer, k, row) ...], the
    boxes of 64 B rows from byte 0 of the slot."""
    out = []
    for ph in phases:
        slots = []
        for k in range(Hp // TF32_BK):
            for half in (0, 1):
                row0 = (in_rows[ph["layer"]] if half == 0 else 0) + ph["row0"]
                slots.append([(j * TF32_BOX_BYTES, ph["layer"], TF32_BK * k,
                               row0 + TF32_BOX_ROWS * j)
                              for j in range(ph["width"] // TF32_BOX_ROWS)])
        out.append(slots)
    return out


def tf32_acc_cell(thread: int, i: int, nw: int):
    """(tile row, column) that accumulator register i of consumer thread
    `thread` (0-255 over both consumers) holds in a phase of nw columns a
    consumer: row 16 w + lane / 4 + 8 ((i % 4) >> 1), column c nw + 8 (i /
    4) + 2 (lane % 4) + (i % 2)."""
    c, w, lane = thread // 128, (thread % 128) // 32, thread % 32
    j, q = divmod(i, 4)
    return 16 * w + lane // 4 + 8 * (q >> 1), c * nw + 8 * j + 2 * (lane % 4) + (q & 1)


def tf32_frag_cell(thread: int, kk: int, q: int):
    """(tile row, column within a 32-column chunk) of A fragment value q of
    k8 step kk that a consumer thread loads: a0 (r, t), a1 (r + 8, t), a2
    (r, t + 4), a3 (r + 8, t + 4), r = 16 w + lane / 4, t = lane % 4 (the
    same for both consumers: each reads all 64 rows)."""
    w, lane = (thread % 128) // 32, thread % 32
    return 16 * w + lane // 4 + 8 * (q & 1), 8 * kk + lane % 4 + 4 * (q >> 1)


def tf32_tile_rows(M: int, sms: int = 132) -> Dict[int, List[int]]:
    """Block -> the f32 tiles it walks: blockIdx.x, + gridDim.x, ... below
    ceil(M / TF32_TILE)."""
    tiles = _cdiv(M, TF32_TILE)
    grid = min(tiles, sms)
    return {b: list(range(b, tiles, grid)) for b in range(grid)}


def _tb32_check(n_layers: int, skip: int, Hp: int, Ep: int) -> None:
    if (not 3 <= n_layers <= TF32_MAX_LAYERS or not 0 < skip < n_layers - 1
            or Hp not in (64, 128, 256) or Ep <= 0 or Ep % 64):
        raise ValueError("not an f32 fused backward")


def _phase(act_steps, box_steps, box, box_k0, layer, row0, width, kind) -> Dict[str, int]:
    return dict(act_steps=act_steps, box_steps=box_steps, box=box, box_k0=box_k0, layer=layer,
                row0=row0, width=width, kind=kind)


def tb32_ut_phases(Ep: int, Hp: int, in_cols: Sequence[int], skip: int) -> List[Dict[str, int]]:
    """honerf_trunk_ut_f32's phase table: one phase a layer l < n - 1 (in_cols
    has n - 1 entries), K steps of 32 over the dm tile, then over A's boxes
    (layer 0: du_b's, box 0, from B's k 0; the skip: du_s's, box 1, from k
    Hp), Hp columns of the layer's [big; small] W^T rows.  Raises
    ValueError where the entry point refuses the shapes."""
    n = len(in_cols) + 1
    _tb32_check(n, skip, Hp, Ep)
    out = []
    for l in range(n - 1):
        want = Ep if l == 0 else (Hp + Ep if l == skip else Hp)
        if in_cols[l] != want:
            raise ValueError(f"layer {l}: {in_cols[l]} rows are not a trunk layer's")
        out.append(_phase(0 if l == 0 else Hp // TF32_BK,
                          Ep // TF32_BK if l in (0, skip) else 0, int(l > 0),
                          0 if l == 0 else Hp, l, 0, Hp, TB32_UT))
    return out


def tb32_pieces(Ep: int) -> List[tuple]:
    """de's pieces: (n0, width), the widest of 256, 128, 64 that fits."""
    out, n0 = [], 0
    while n0 < Ep:
        rem = Ep - n0
        width = TF32_PIECE if rem >= TF32_PIECE else (128 if rem >= 128 else 64)
        out.append((n0, width))
        n0 += width
    return out


def tb32_dz_phases(n_layers: int, skip: int, Hp: int, Ep: int, Op: int) -> List[Dict[str, int]]:
    """honerf_trunk_dz_f32's phase table: the top layer over the top
    cotangent's Op / 32 boxes (box 0), then the chain layers n-2 .. 1 over
    the tile (Hp columns, each writing dz_{l-1} in place), de's skip parts
    just before the skip's chain layer (a piece of 256, 128 or 64 columns:
    W_skip's rows from Hp + n0 over dz_skip; de = its sum / sqrt2), and
    after layer 1 de's layer-0 parts (W_0's rows from n0 over dz_0; de +=
    its sum)."""
    _tb32_check(n_layers, skip, Hp, Ep)
    if Op <= 0 or Op % 64:
        raise ValueError("not an f32 fused backward")
    kt = Hp // TF32_BK
    pieces = tb32_pieces(Ep)
    out = [_phase(0, Op // TF32_BK, 0, 0, n_layers - 1, 0, Hp, TB32_CHAIN)]
    for l in range(n_layers - 2, 0, -1):
        if l == skip:
            out += [_phase(kt, 0, 0, 0, skip, Hp + n0, w, TB32_SKIP) for n0, w in pieces]
        out.append(_phase(kt, 0, 0, 0, l, 0, Hp, TB32_CHAIN))
    out += [_phase(kt, 0, 0, 0, 0, n0, w, TB32_ZERO) for n0, w in pieces]
    if len(out) > TB32_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def tb32_loads(phases, tile: int, small_rows: Sequence[int]) -> List[List[tuple]]:
    """Both backward producers' TMA loads, per phase and slot (two a K step:
    B's small rows, then its big rows): (A, [B ...]) with A (box, column,
    row) of the phase's box map or None (the box rides in the small slot of
    a box step), each B (layer, k, row) of the layer's [big; small] map,
    small_rows[l] its first small row."""
    out = []
    for ph in phases:
        slots = []
        for k in range(ph["act_steps"] + ph["box_steps"]):
            kb = k - ph["act_steps"]
            kc = ph["box_k0"] + TF32_BK * kb if kb >= 0 else TF32_BK * k
            for half in (0, 1):
                a = ((ph["box"], TF32_BK * kb, TF32_TILE * tile)
                     if kb >= 0 and half == 0 else None)
                row0 = (small_rows[ph["layer"]] if half == 0 else 0) + ph["row0"]
                slots.append((a, [(ph["layer"], kc, row0 + TF32_BOX_ROWS * j)
                                  for j in range(ph["width"] // TF32_BOX_ROWS)]))
        out.append(slots)
    return out


# ---------------------------------------------------------------------------
# The f32 color net in two launches (csrc/color_fused_f32.cu)
# ---------------------------------------------------------------------------

def _cf32_phase(act_steps, box_steps0, box_steps1, layer, row0, width, kind) -> Dict[str, int]:
    return dict(act_steps=act_steps, box_steps0=box_steps0, box_steps1=box_steps1, layer=layer,
                row0=row0, width=width, kind=kind)


def cf32_smem_bytes() -> Dict[str, int]:
    """Both color kernels' shared memory by part (bytes): the f32 tile (the
    activations, or the transpose's dz), the ring of slots (A's box + up to
    256 B rows)."""
    return dict(align=1024, tile=TF32_ACT_BYTES, ring=TF32_RING_BYTES,
                barriers=2 * TF32_STAGES * 8)


def _cf32_check(n: int, widths: Sequence[int]) -> None:
    if not 2 <= n <= TF32_MAX_LAYERS or any(w not in (64, 128, 256) for w in widths):
        raise ValueError("not an f32 fused color net")


def cf32_fwd_phases(Ep: int, X: int, rows: Sequence[int],
                    cols: Sequence[int]) -> List[Dict[str, int]]:
    """honerf_color_fwd_f32's phase table: one phase a layer, layer 0 over
    e's Ep / 32 boxes (box map 0) then cx2's X / 32 (map 1), the others
    over the tile; relu epilogues, the last layer's a sigmoid.  Raises
    ValueError where the entry point refuses the shapes."""
    n = len(rows)
    _cf32_check(n, cols)
    if Ep <= 0 or Ep % 64 or X <= 0 or X % 64:
        raise ValueError("not an f32 fused color net")
    H, out = cols[0], []
    for l in range(n):
        last = l + 1 == n
        if rows[l] != (Ep + X if l == 0 else H) or (not last and cols[l] != H):
            raise ValueError(f"layer {l}: {rows[l]} x {cols[l]} is not a color layer")
        out.append(_cf32_phase(0 if l == 0 else H // TF32_BK, Ep // TF32_BK if l == 0 else 0,
                               X // TF32_BK if l == 0 else 0, l, 0, cols[l],
                               CF32_SIGMOID if last else CF32_RELU))
    return out


def cf32_pieces(width: int) -> List[tuple]:
    """dx's pieces: (n0, width), the widest of 256, 128, 64 that fits."""
    out, n0 = [], 0
    while n0 < width:
        rem = width - n0
        w = CF32_PIECE if rem >= CF32_PIECE else (128 if rem >= 128 else 64)
        out.append((n0, w))
        n0 += w
    return out


def cf32_bwd_phases(in_cols: Sequence[int], out_cols: Sequence[int]) -> List[Dict[str, int]]:
    """honerf_color_bwd_f32's phase table: layers n-1 .. 1 over the tile
    (the top over the seed's out_cols[n-1] / 32 K steps, the others over H
    / 32), each masked into the tile in place; then dx's pieces (W_0's rows
    from n0) over dz_0."""
    n = len(in_cols)
    _cf32_check(n, out_cols)
    H = out_cols[0]
    if in_cols[0] <= 0 or in_cols[0] % 64 or any(
            (l > 0 and in_cols[l] != H) or (l + 1 < n and out_cols[l] != H) for l in range(n)):
        raise ValueError("not an f32 fused color net")
    out = [_cf32_phase(out_cols[l] // TF32_BK, 0, 0, l, 0, H, CF32_MASK)
           for l in range(n - 1, 0, -1)]
    out += [_cf32_phase(H // TF32_BK, 0, 0, 0, n0, w, CF32_DX) for n0, w in cf32_pieces(in_cols[0])]
    if len(out) > CF32_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def cf32_loads(phases, tile: int, small_rows: Sequence[int]) -> List[List[tuple]]:
    """Both color producers' TMA loads, per phase and slot (two a K step:
    B's small rows, then its big rows): (A, [B ...]) with A (box, column,
    row) of box map 0's boxes, then map 1's, or None (the box rides in the
    small slot of a box step), each B (layer, k, row) of the layer's [big;
    small] map, B's k running on across the phase's ranges, small_rows[l]
    its first small row."""
    out = []
    for ph in phases:
        slots = []
        steps = ph["act_steps"] + ph["box_steps0"] + ph["box_steps1"]
        for k in range(steps):
            kb = k - ph["act_steps"]
            box = int(kb >= ph["box_steps0"])
            col = TF32_BK * (kb - ph["box_steps0"] if box else kb)
            for half in (0, 1):
                a = (box, col, TF32_TILE * tile) if kb >= 0 and half == 0 else None
                row0 = (small_rows[ph["layer"]] if half == 0 else 0) + ph["row0"]
                slots.append((a, [(ph["layer"], TF32_BK * k, row0 + TF32_BOX_ROWS * j)
                                  for j in range(ph["width"] // TF32_BOX_ROWS)]))
        out.append(slots)
    return out


# ---------------------------------------------------------------------------
# The bf16 color net in two launches (csrc/color_fused.cu)
# ---------------------------------------------------------------------------

def _cf16_phase(act_steps, box_steps0, box_steps1, layer, n0, boxes, kind) -> Dict[str, int]:
    return dict(act_steps=act_steps, box_steps0=box_steps0, box_steps1=box_steps1, layer=layer,
                n0=n0, boxes=boxes, kind=kind)


def cf16_smem_bytes() -> Dict[str, int]:
    """Both bf16 color kernels' shared memory by part (bytes): the bf16
    tile (the activations, or the transpose's dz), the ring of stages (an
    A box + 64 k-rows of up to 256 B columns)."""
    return dict(align=1024, tile=CF16_ACT_BYTES, ring=CF16_RING_BYTES,
                barriers=2 * CF16_STAGES * 8)


def _cf16_check(n: int, hidden: int) -> None:
    if not 2 <= n <= CF16_MAX_LAYERS or hidden <= 0 or hidden % 64 or hidden > CF16_WIDTH:
        raise ValueError("not a bf16 fused color net")


def cf16_fwd_phases(Ep: int, X: int, rows: Sequence[int],
                    cols: Sequence[int]) -> List[Dict[str, int]]:
    """honerf_color_fwd's phase table: one phase a layer, layer 0 over e's
    Ep / 64 boxes (box map 0) then cx2's X / 64 (map 1), the others over
    the tile; relu epilogues (m64n256k16), the last layer's 64 columns a
    sigmoid (m64n64k16).  Raises ValueError where the entry point refuses
    the shapes."""
    n = len(rows)
    H = cols[0]
    _cf16_check(n, H)
    if Ep <= 0 or Ep % 64 or X <= 0 or X % 64:
        raise ValueError("not a bf16 fused color net")
    out = []
    for l in range(n):
        last = l + 1 == n
        if rows[l] != (Ep + X if l == 0 else H) or cols[l] != (64 if last else H):
            raise ValueError(f"layer {l}: {rows[l]} x {cols[l]} is not a color layer")
        out.append(_cf16_phase(0 if l == 0 else H // 64, Ep // 64 if l == 0 else 0,
                               X // 64 if l == 0 else 0, l, 0, cols[l] // 64,
                               CF16_SIGMOID if last else CF16_RELU))
    return out


def cf16_pieces(width: int) -> List[tuple]:
    """dx's pieces: (n0, width), the widest of 256, 128, 64 that fits."""
    out, n0 = [], 0
    while n0 < width:
        rem = width - n0
        w = CF16_PIECE if rem >= CF16_PIECE else (128 if rem >= 128 else 64)
        out.append((n0, w))
        n0 += w
    return out


def cf16_bwd_phases(in_cols: Sequence[int], out_cols: Sequence[int]) -> List[Dict[str, int]]:
    """honerf_color_bwd's phase table: layers n-1 .. 1 over the tile (the
    top over the seed's 64 columns, one K step; the others over H / 64),
    each masked into the tile in place; then dx's pieces (W_0^T's columns
    from n0) over dz_0."""
    n = len(in_cols)
    H = out_cols[0]
    _cf16_check(n, H)
    if in_cols[0] <= 0 or in_cols[0] % 64 or any(
            (l > 0 and in_cols[l] != H) or out_cols[l] != (64 if l + 1 == n else H)
            for l in range(n)):
        raise ValueError("not a bf16 fused color net")
    out = [_cf16_phase(out_cols[l] // 64, 0, 0, l, 0, H // 64, CF16_MASK)
           for l in range(n - 1, 0, -1)]
    out += [_cf16_phase(H // 64, 0, 0, 0, n0, w // 64, CF16_DX)
            for n0, w in cf16_pieces(in_cols[0])]
    if len(out) > CF16_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def cf16_loads(phases, tile: int) -> List[List[tuple]]:
    """Both bf16 color producers' TMA loads, per phase and K step: (A, [B
    ...]) with A (box map, column, row) of map 0's boxes, then map 1's, or
    None (A is the tile), each B (layer, column, k-row): the phase's boxes
    of 64 columns from n0, B's k-row 64 k running on across the phase's
    ranges."""
    out = []
    for ph in phases:
        steps = []
        for k in range(ph["act_steps"] + ph["box_steps0"] + ph["box_steps1"]):
            kb = k - ph["act_steps"]
            box = int(kb >= ph["box_steps0"])
            a = ((box, 64 * (kb - ph["box_steps0"] if box else kb), CF16_TILE * tile)
                 if kb >= 0 else None)
            steps.append((a, [(ph["layer"], ph["n0"] + 64 * j, 64 * k)
                              for j in range(ph["boxes"])]))
        out.append(steps)
    return out


# ---------------------------------------------------------------------------
# The bf16 trunk's backward in two launches (csrc/trunk_bwd.cu)
# ---------------------------------------------------------------------------

def _tb16_phase(act_steps, box_steps0, box_steps1, layer, n0, boxes, kind, s_plane=-1,
                x_plane=-1, n1=0, src=0, dst=0) -> Dict[str, int]:
    return dict(_cf16_phase(act_steps, box_steps0, box_steps1, layer, n0, boxes, kind),
                s_plane=s_plane, x_plane=x_plane, n1=n1, src=src, dst=dst)


def tb16_smem_bytes(down: bool = False) -> Dict[str, int]:
    """The bf16 backward kernels' shared memory by part (bytes): upward, the
    bf16 dm tile and the ring of stages (an A box + 64 k-rows of up to 256
    B columns); downward, two dz tiles (dz_skip kept in the second) and a
    ring of B-only stages."""
    if down:
        return dict(align=1024, tiles=2 * TB16_ACT_BYTES, ring=DZ16_RING_BYTES,
                    barriers=2 * TB16_STAGES * 8)
    return dict(align=1024, tile=TB16_ACT_BYTES, ring=TB16_RING_BYTES,
                barriers=2 * TB16_STAGES * 8)


def _tb16_check(n_layers: int, skip: int, Hp: int, Ep: int) -> None:
    if (not 3 <= n_layers <= TB16_MAX_LAYERS or not 0 < skip < n_layers - 1
            or Hp not in (64, 128, 256) or Ep <= 0 or Ep % 64):
        raise ValueError("not a bf16 fused trunk backward")


def tb16_ut_phases(Ep: int, Hp: int, in_cols: Sequence[int], skip: int) -> List[Dict[str, int]]:
    """honerf_trunk_ut's phase table: one phase a layer below the last,
    layer 0 over du_b's Ep / 64 boxes (box map 0), the middle layers over
    the dm tile, the skip over the tile then du_s's Ep / 64 boxes (map 1),
    B's k-row running on; Hp / 64 B boxes a K step; the epilogue's rows:
    the sigmoid plane l, the c plane l (c_{l+1}; none for the last layer,
    whose c_last is read directly).  Raises ValueError where the entry
    point refuses the shapes."""
    n = len(in_cols) + 1
    _tb16_check(n, skip, Hp, Ep)
    out = []
    for l, rows in enumerate(in_cols):
        if rows != (Ep if l == 0 else (Hp + Ep if l == skip else Hp)):
            raise ValueError(f"layer {l}: {rows} rows do not chain")
        out.append(_tb16_phase(0 if l == 0 else Hp // 64, Ep // 64 if l == 0 else 0,
                               Ep // 64 if l == skip else 0, l, 0, Hp // 64, TB16_UT, l,
                               l if l + 1 < len(in_cols) else -1))
    return out


def tb16_pieces(Ep: int) -> List[tuple]:
    """de's pieces: (n0, width), DZ16_PIECE columns, the last 64 where Ep
    leaves that."""
    out, n0 = [], 0
    while n0 < Ep:
        w = DZ16_PIECE if Ep - n0 >= DZ16_PIECE else 64
        out.append((n0, w))
        n0 += w
    return out


def tb16_dz_phases(n_layers: int, skip: int, Hp: int, Ep: int, Op: int) -> List[Dict[str, int]]:
    """honerf_trunk_dz's phase table: the top layer over the seed's Op / 64
    chunks (the top cotangent copied into the two tiles), each chain layer l
    over the tile holding dz_l (tile 1: dz_skip, kept to layer 0; tile 0 the
    rest), its epilogue reading the sigmoid and ds planes l - 1 and writing
    dz_{l-1} into tile 1 at the skip, else tile 0; then de's pieces, two
    sums each: the skip's part over tile 1 (B = wts[skip]'s columns from Hp
    + n0), layer 0's over tile 0 (wts[0]'s from n1 = n0)."""
    _tb16_check(n_layers, skip, Hp, Ep)
    if Op <= 0 or Op % 64 or Op > 2 * TB16_WIDTH:
        raise ValueError("not a bf16 fused trunk backward")
    kt = Hp // 64
    out = [_tb16_phase(Op // 64 if l + 1 == n_layers else kt, 0, 0, l, 0, kt, TB16_CHAIN, l - 1,
                       l - 1, src=int(l == skip), dst=int(l - 1 == skip))
           for l in range(n_layers - 1, 0, -1)]
    out += [_tb16_phase(kt, 0, 0, skip, Hp + n0, w // 64, TB16_DE, n1=n0, src=1)
            for n0, w in tb16_pieces(Ep)]
    if len(out) > TB16_MAX_PHASES:
        raise ValueError("too many phases")
    return out


def tb16_loads(phases, tile: int) -> List[List[tuple]]:
    """Both bf16 backward producers' TMA loads of the products, per phase
    and K step: (A, [B ...]) as cf16_loads (map 0 du_b, map 1 du_s; A None:
    a tile), a piece of de's second B (layer 0, column, k-row) after its
    first's."""
    out = []
    for ph, steps in zip(phases, cf16_loads(phases, tile)):
        if ph["kind"] == TB16_DE:
            steps = [(a, bs + [(0, ph["n1"] + 64 * j, kr) for j in range(ph["boxes"])])
                     for a, bs in steps for kr in [bs[0][2]]]
        out.append(steps)
    return out


def tb16_epi_loads(phases, tile: int, Hp: int) -> List[List[tuple]]:
    """The producers' epilogue steps after each chain phase's K steps:
    ((sigmoid plane, column, row), (c / ds plane, column, row) or None), a
    box of TB16_EPI_COLS columns x a tile's rows each, Hp / TB16_EPI_COLS
    steps a chain phase, none a piece."""
    return [[((ph["s_plane"], TB16_EPI_COLS * e, TB16_TILE * tile),
              (ph["x_plane"], TB16_EPI_COLS * e, TB16_TILE * tile)
              if ph["x_plane"] >= 0 else None)
             for e in range(Hp // TB16_EPI_COLS)] if ph["s_plane"] >= 0 else []
            for ph in phases]


def tb16_ring_steps(phases, Hp: int) -> List[int]:
    """Ring steps of each phase (ring_schedule's phase_steps): its K steps,
    then its epilogue steps."""
    return [ph["act_steps"] + ph["box_steps0"] + ph["box_steps1"] + len(epi)
            for ph, epi in zip(phases, tb16_epi_loads(phases, 0, Hp))]


def ring_schedule(phase_steps: Sequence[int], tiles: int, stages: int, turns: bool = False,
                  early_hand_off: bool = True, seed: Optional[int] = None,
                  pairs: bool = False) -> int:
    """Run one block's producer and two consumers as the kernels do,
    interleaved at random (seed) or in turn: the producer fills K step i
    once both consumers freed step i - stages; a consumer waits for its
    step, frees the previous one once the next is issued and the last at
    the phase's end.  Lockstep (the fused trunk's schedule) stops there;
    with `turns` (obj_sdf_fused_kernel's) consumer c also syncs
    named barrier 3 + c before each phase and arrives at the other's once
    a phase (consumer 1 first, once, and not in its very last phase):
    before the wait for step `stages` when early_hand_off and the phase is
    deeper than the ring, else after its last step.  With `pairs`
    (the f32 kernels: phase_steps counts slots, two a K step) a consumer
    waits for both slots of a K step, then frees both.  Every wait is
    monotone, so one run that ends shows that every interleaving ends.
    Returns the events run; raises RuntimeError on a deadlock, on a
    barrier arrived at twice before its sync (the hardware would complete
    it without its syncer), or on arrivals left over at the end."""
    rng = random.Random(seed) if seed is not None else None
    phases = [(t, q, n) for t in range(tiles) for q, n in enumerate(phase_steps)]
    total = sum(n for _, _, n in phases)
    released = [0] * total
    filled = [0]
    arrivals, syncs = [0, 0], [0, 0]

    def consumer(c):
        it = 0
        if turns and c == 1:
            yield ("arrive", 0)
        for i, (_, _, n) in enumerate(phases):
            final = i + 1 == len(phases)
            if turns:
                yield ("sync", c)
            handed = not turns
            prev = None
            if pairs:
                for k in range(0, n, 2):
                    yield ("full", it)
                    yield ("full", it + 1)
                    yield ("release", it)
                    yield ("release", it + 1)
                    it += 2
                continue
            for k in range(n):
                if not handed and early_hand_off and k == stages:
                    handed = True
                    if not (c == 1 and final):
                        yield ("arrive", 1 - c)
                yield ("full", it)
                if prev is not None:
                    yield ("release", prev)
                prev, it = it, it + 1
            yield ("release", prev)
            if not handed and not (c == 1 and final):
                yield ("arrive", 1 - c)

    def producer():
        for it in range(total):
            yield ("empty", it)

    agents = [producer(), consumer(0), consumer(1)]
    nxt = [next(a, None) for a in agents]
    events = 0

    def ready(ev):
        kind, x = ev
        if kind == "empty":
            return x < stages or released[x - stages] == 2
        if kind == "full":
            return x < filled[0]
        if kind == "sync":
            return arrivals[x] > syncs[x]
        return True

    while any(ev is not None for ev in nxt):
        live = [i for i, ev in enumerate(nxt) if ev is not None and ready(ev)]
        if not live:
            raise RuntimeError(f"deadlock after {events} events: waiting on {nxt}")
        i = rng.choice(live) if rng else live[0]
        kind, x = nxt[i]
        if kind == "empty":
            filled[0] += 1
        elif kind == "release":
            released[x] += 1
        elif kind == "sync":
            syncs[x] += 1
        elif kind == "arrive":
            arrivals[x] += 1
            if arrivals[x] - syncs[x] > 1:
                raise RuntimeError(f"barrier {3 + x} arrived at twice before its sync")
        events += 1
        nxt[i] = next(agents[i], None)
    if arrivals != syncs:
        raise RuntimeError(f"arrivals {arrivals} left against syncs {syncs}")
    return events


# ---------------------------------------------------------------------------
# An f32 pass's weight gradients in one launch (csrc/trunk_dw_f32.cu)
# ---------------------------------------------------------------------------

TDW32_ROWS = 128       # dW rows an item: two consumers x 64
TDW32_NB = 128         # dW columns an item, at most
TDW32_BK = 32          # points a K step
TDW32_BOX_BYTES = TDW32_BK * 128                    # 32 points x 32 f32 columns
TDW32_X_BYTES = 4 * TDW32_BOX_BYTES                 # two consumers x 64 columns
TDW32_Y_BYTES = TDW32_NB // 32 * TDW32_BOX_BYTES
TDW32_STAGE_BYTES = TDW32_X_BYTES + TDW32_Y_BYTES
TDW32_STAGES = 3
TDW32_RING_BYTES = TDW32_STAGES * TDW32_STAGE_BYTES
TDW32_B_BYTES = TDW32_NB * 128                      # B's big (or small) rows of a K step
TDW32_SPLIT_BYTES = 2 * TDW32_B_BYTES
TDW32_BUF_BYTES = 2 * TDW32_SPLIT_BYTES             # two K steps' [small; big]
TDW32_ACC_BYTES = 256 * TDW32_NB // 2 * 4          # the flushed running sums
TDW32_RED_BYTES = 256 * 4                          # db's thread sums
TDW32_SMEM_BYTES = (1024 + TDW32_RING_BYTES + TDW32_BUF_BYTES + TDW32_ACC_BYTES
                    + TDW32_RED_BYTES + 2 * TDW32_STAGES * 8 + 16)
TDW32_MAX_MAPS = 12
TDW32_MAX_OUT = 16
TDW32_PART = (TDW32_ROWS + 1) * TDW32_NB            # floats of an item's partial
TDW32_MAX_TILES = 1024
TDW32_ITEM_INTS = 24
TDW32_FLUSH = 32       # K steps a running sum holds before it joins the shared-memory sum
TDW32_CONSTANTS = ("TDW32_ROWS", "TDW32_NB", "TDW32_BK", "TDW32_BOX_BYTES", "TDW32_X_BYTES",
                   "TDW32_Y_BYTES", "TDW32_STAGE_BYTES", "TDW32_STAGES", "TDW32_RING_BYTES",
                   "TDW32_B_BYTES", "TDW32_SPLIT_BYTES", "TDW32_BUF_BYTES", "TDW32_ACC_BYTES",
                   "TDW32_RED_BYTES",
                   "TDW32_SMEM_BYTES", "TDW32_MAX_MAPS", "TDW32_MAX_OUT", "TDW32_PART",
                   "TDW32_MAX_TILES", "TDW32_ITEM_INTS", "TDW32_FLUSH")
TDW32_NONE, TDW32_MMA, TDW32_SUM = 0, 1, 2
# a K step's cost in the planner's units (one 128 x 128 product), by kind
# and width; an item's fixed cost (its partial, the tile's sum) in K steps
_TDW32_COST = {(TDW32_MMA, 128): 1.0, (TDW32_MMA, 64): 0.6, (TDW32_SUM, 128): 0.25,
               (TDW32_SUM, 64): 0.25}
_TDW32_ITEM_COST = 3.0


class Tdw32Seg(NamedTuple):
    """Rows [row0, row0 + rows) of a product's X: map `map`'s plane
    `layer`, columns col0.., times the skip's 1/sqrt2 when `scale`."""

    row0: int
    rows: int
    map: int
    layer: int
    col0: int
    scale: int = 0


class Tdw32Prod(NamedTuple):
    """One of an output's two products: kind (TDW32_MMA: X^T Y; TDW32_SUM:
    X's column sums into dW's column 0), X's row segments, Y's (map, layer)."""

    kind: int
    segs: tuple
    y: tuple = (0, 0)


class Tdw32Out(NamedTuple):
    """An output slot: dW (K, N) and db (N,), the sum of its products
    (u-chain's first, the forward's second; db from the second's Y)."""

    K: int
    N: int
    prods: tuple


def tdw32_box(p: int, col: int) -> int:
    """Byte of an f32 box (32 points x 32 columns, the 128-byte swizzle)
    that holds point p, column col (tdw32_box in the source)."""
    assert 0 <= p < TDW32_BK and 0 <= col < 32
    return swizzle128(p * 128 + 4 * col)


def tdw32_b_offset(n: int, k: int) -> int:
    """Byte of the transposed split (either half) that holds B element (n,
    k): column n's row of 128 bytes, k's quad at (k / 4) ^ (n % 8)."""
    assert 0 <= n < TDW32_NB and 0 <= k < TDW32_BK
    return n * 128 + (((k // 4) ^ (n % 8)) << 4) + 4 * (k % 4)


def tdw32_split_cells(tau: int, nb: int) -> List[tuple]:
    """The (point, column) cells of a K step's Y that consumer thread tau
    (0-255) splits, in its order: column tau % nb, quads of 4 points from
    (tau / nb) quads."""
    quads = TDW32_BK * nb // 256 // 4
    n, q0 = tau % nb, (tau // nb) * quads
    return [(4 * q + i, n) for q in range(q0, q0 + quads) for i in range(4)]


def tdw32_a_cells(thread: int) -> List[tuple]:
    """The (point, dW row within the consumer's 64) cells of a K step's X
    that a consumer thread loads, x[kk][q] in order: point 8 kk + t + 4 (q
    >> 1), row r + 8 (q & 1)."""
    w, lane = (thread % 128) // 32, thread % 32
    r, t = 16 * w + lane // 4, lane % 4
    return [(8 * kk + t + 4 * (q >> 1), r + 8 * (q & 1)) for kk in range(4) for q in range(4)]


def tdw32_smem_bytes() -> Dict[str, int]:
    """trunk_dw_f32_kernel's shared memory by part (bytes)."""
    return dict(align=1024, ring=TDW32_RING_BYTES, split=TDW32_BUF_BYTES, acc=TDW32_ACC_BYTES,
                red=TDW32_RED_BYTES, barriers=2 * TDW32_STAGES * 8, last=16)


def _tdw32_x(segs, row: int, K: int) -> int:
    """The packed X source of a consumer whose 64 rows start at dW row `row`."""
    if row >= K:
        return -1
    for s in segs:
        if s.row0 <= row < s.row0 + s.rows:
            if row + 64 > s.row0 + s.rows and row + 64 <= K:
                raise ValueError("a consumer's 64 rows straddle two sources")
            return s.map + 16 * s.layer + 2048 * s.scale + 4096 * (s.col0 + row - s.row0)
    raise ValueError(f"no source holds dW row {row}")


def tdw32_tiles(outs: Sequence[Tdw32Out]) -> List[Dict]:
    """The tiles of a pass: each output's rows in 128s, its columns in
    128s and a last 64; per tile the products' kinds (a SUM only where the
    tile holds column 0) and each consumer's packed X source."""
    tiles = []
    for o, out in enumerate(outs):
        if out.K % 64 or out.N % 64 or len(out.prods) != 2:
            raise ValueError("dW rows and columns are multiples of 64; two products an output")
        for r0 in range(0, out.K, TDW32_ROWS):
            for c0 in range(0, out.N, TDW32_NB):
                nb = min(TDW32_NB, out.N - c0)
                kinds, xs, ys = [], [], []
                for pr in out.prods:
                    kind = pr.kind if (pr.kind != TDW32_SUM or c0 == 0) else TDW32_NONE
                    kinds.append(kind)
                    xs.append([_tdw32_x(pr.segs, r0 + 64 * c, out.K) if kind else -1
                               for c in (0, 1)])
                    ys.append(pr.y[0] + 16 * pr.y[1] if kind == TDW32_MMA else 0)
                if kinds[1] != TDW32_MMA:
                    raise ValueError("an output's second product is X^T Y")
                cost = sum(_TDW32_COST[(k, nb)] for k in kinds if k)
                tiles.append(dict(out=o, r0=r0, c0=c0, nb=nb, rows=min(TDW32_ROWS, out.K - r0),
                                  kind=kinds, x=xs, y=ys, db=int(r0 == 0), cost=cost))
    if len(tiles) > TDW32_MAX_TILES:
        raise ValueError("too many tiles")
    return tiles


def _tdw32_items(tiles, M: int, L: int) -> List[Dict]:
    """Items at L points a 128 x 128 product: each tile split into ranges of
    about L / cost points (multiples of TDW32_BK), ordered by output, then
    split, then tile (the items that read one point range run together);
    a tile's partials are consecutive from `first`."""
    plans, first = [], 0
    for tl in tiles:
        want = max(TDW32_BK, int(round(L * 2.0 / max(tl["cost"], 1.0))))
        span = min(_cdiv(M, TDW32_BK) * TDW32_BK, _cdiv(want, TDW32_BK) * TDW32_BK)
        splits = _cdiv(M, span)
        span = _cdiv(_cdiv(M, splits), TDW32_BK) * TDW32_BK
        splits = _cdiv(M, span)
        plans.append((span, splits, first))
        first += splits
    items = []
    outs = sorted({tl["out"] for tl in tiles})
    for o in outs:
        idx = [i for i, tl in enumerate(tiles) if tl["out"] == o]
        for s in range(max(plans[i][1] for i in idx)):
            for i in idx:
                span, splits, first = plans[i]
                if s < splits:
                    p0 = s * span
                    items.append(dict(tiles[i], tile=i, split=s, splits=splits, first=first,
                                      p0=p0, np=min(span, M - p0)))
    return items


def tdw32_makespan(items, sms: int) -> float:
    """The busiest block's work under the kernel's static order (block b
    runs items b, b + grid, ...), in K steps of a 128 x 128 product."""
    grid = min(len(items), sms)
    load = [0.0] * grid
    for i, it in enumerate(items):
        steps = _cdiv(it["np"], TDW32_BK)
        load[i % grid] += steps * it["cost"] + _TDW32_ITEM_COST + 0.25 * it["splits"]
    return max(load)


def tdw32_plan(outs: Sequence[Tdw32Out], M: int, sms: int = 132) -> List[Dict]:
    """The work list of one launch on M points: the tiles of `outs`, split
    over the points at the item length (tried from one item a tile to about
    eight items an SM) whose static order finishes first."""
    if M <= 0:
        return []
    tiles = tdw32_tiles(outs)
    total = sum(tl["cost"] for tl in tiles) * M
    best = None
    for items_per_sm in [x / 4 for x in range(1, 33)]:
        L = max(TDW32_BK, int(total / (items_per_sm * sms) / 2.0))
        items = _tdw32_items(tiles, M, L)
        span = tdw32_makespan(items, sms)
        if best is None or span < best[0]:
            best = (span, items)
    return best[1]


def tdw32_item_ints(items) -> List[int]:
    """The work list as the kernel reads it (TDW32Item: TDW32_ITEM_INTS
    ints an item)."""
    out = []
    for it in items:
        row = [it["out"], it["tile"], it["split"], it["splits"], it["first"], it["r0"], it["c0"],
               it["nb"], it["rows"], it["p0"], it["np"], it["db"], *it["kind"], *it["x"][0],
               *it["x"][1], *it["y"], 0, 0, 0, 0]
        assert len(row) == TDW32_ITEM_INTS
        out.extend(row)
    return out
