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

Nothing on the main path calls the functions but `tn_workspace`; the CUDA
side computes the same numbers (`honerf_gemm`, `honerf_gemm_tn`).
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
