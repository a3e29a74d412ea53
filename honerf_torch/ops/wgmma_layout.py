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

Nothing on the main path calls the functions but `tn_workspace`; the CUDA
side computes the same numbers (`honerf_gemm`, `honerf_gemm_tn`,
`honerf_obj_sdf`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

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
