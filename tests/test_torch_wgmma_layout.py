"""The bf16 GEMMs' layout arithmetic (honerf_torch/ops/wgmma_layout.py),
held against csrc/wgmma.cuh and against hand-worked cases.

The kernels run only on the card (tests/test_torch_cuda.py holds them
against f64 there); what surrounds them is checked here on the CPU: the
header's constants are the helper's, the wgmma shared-memory descriptor's
fields, the 128-byte swizzle (a bijection on a tile, and the same byte for
TMA's box and wgmma's descriptor in both major orders), the tensor maps of
a concat with ragged K1, K2 and M, N tails, the TN product's split over
the points, and the preconditions TMA sets.  Runs in about a second.
"""

import re
from pathlib import Path

import pytest

from honerf_torch.ops import fused_fine as FT
from honerf_torch.ops import wgmma_layout as WL

HEADER = Path(WL.__file__).resolve().parent / "csrc" / "wgmma.cuh"


def _header_constants():
    """Every namespace-level `constexpr int NAME = expr` of the header,
    evaluated in order."""
    env = {}
    text = HEADER.read_text()
    for decl in re.findall(r"^constexpr int ([^;]+);", text, flags=re.M):
        for part in decl.split(","):
            name, expr = (x.strip() for x in part.split("="))
            env[name] = eval(expr.replace("/", "//"), {}, dict(env))  # noqa: S307
    return env


def test_header_constants_are_the_helpers():
    env = _header_constants()
    for name in WL.CONSTANTS:
        assert env[name] == getattr(WL, name), name
    # one block: the ring, the epilogue slabs and the barriers fit, and the
    # registers setmaxnreg moves balance (launch bounds: 65,536 / 384 -> 168)
    assert WL.SMEM_BYTES <= WL.SMEM_LIMIT
    assert env["PRODUCER_REGS"] * 128 + env["CONSUMER_REGS"] * 256 <= 168 * 384
    assert env["PRODUCER_REGS"] % 8 == 0 and env["CONSUMER_REGS"] % 8 == 0


def test_stage_sizes():
    # a stage: 128 rows x 64 k of A (16 KB) and 64 k x 256 columns of B (32 KB);
    # the TN product's 128 columns of Y fill 16 KB of its B
    assert (WL.A_BYTES, WL.B_BYTES, WL.STAGE_BYTES) == (16384, 32768, 49152)
    assert WL.TN_STAGE_BYTES == 32768 and WL.BN_TN % WL.MN_CHUNK == 0
    assert WL.BK * 2 == WL.SWIZZLE_BYTES and WL.MN_CHUNK * 2 == WL.SWIZZLE_BYTES
    # every operand tile starts on the swizzle pattern's 1024-byte period
    for off in (WL.A_BYTES, WL.A_HALF_BYTES, WL.B_CHUNK_BYTES, WL.STAGE_BYTES):
        assert off % 1024 == 0
    assert WL.RING_BYTES == 4 * 49152 and WL.SMEM_BYTES == 220224


@pytest.mark.parametrize("addr,lbo,sbo,want", [
    # a K-major A stage at 0x1400: start 0x140, LBO 1 (unused), SBO 64
    (0x1400, 16, 1024, 0x140 | 1 << 16 | 64 << 32 | 1 << 62),
    # an MN-major B chunk one k16 step in: start (0x4000 + 2048) >> 4
    (0x4000 + 2048, 8192, 1024, 0x480 | 512 << 16 | 64 << 32 | 1 << 62),
    # the top of shared memory: 14 bits of start address >> 4
    (0x3FFF0, 8192, 1024, 0x3FFF | 512 << 16 | 64 << 32 | 1 << 62),
])
def test_descriptor_fields(addr, lbo, sbo, want):
    desc = WL.smem_desc(addr, lbo, sbo)
    assert desc == want
    assert WL.desc_fields(desc) == dict(start=addr, lbo=lbo, sbo=sbo, base_offset=0, swizzle=1)


def test_descriptor_advance_per_k16_step():
    # K-major: +32 bytes (2 in the >> 4 field); MN-major: +2048 (128)
    assert WL.a_desc(0, 0, 1, tn=False) - WL.a_desc(0, 0, 0, tn=False) == 2
    assert WL.a_desc(0, 0, 1, tn=True) - WL.a_desc(0, 0, 0, tn=True) == 128
    assert WL.b_desc(0, 3) - WL.b_desc(0, 0) == 3 * 128
    # the second consumer's A half starts 8 KB in
    assert WL.desc_fields(WL.a_desc(0, 1, 0, tn=False))["start"] == 8192


@pytest.mark.parametrize("row,col,want", [
    (0, 0, 0), (0, 63, 126), (1, 0, 144), (3, 8, 416), (7, 0, 7 * 128 + 112),
    (8, 0, 1024), (9, 5, 1024 + 128 + 16 + 10),
])
def test_swizzle_hand_worked(row, col, want):
    # 16-byte chunk c of 128-byte row r lands at chunk c ^ (r % 8)
    assert WL.tma_box_offset(row, col) == want


def test_swizzle_is_a_bijection_on_a_64x64_tile():
    offs = {WL.tma_box_offset(r, c) for r in range(64) for c in range(64)}
    assert offs == set(range(0, 64 * 128, 2))
    # and it only permutes 16-byte chunks within a 128-byte row
    for r in range(64):
        row = {WL.tma_box_offset(r, c) // 128 for c in range(64)}
        assert row == {r}


@pytest.mark.parametrize("consumer", [0, 1])
def test_k_major_a_reads_where_tma_wrote(consumer):
    """gemm_kernel's A: one 64 (k) x 128 (m) box; consumer c reads rows
    64c.. through the K-major descriptor, k16 step kk at +32 bytes."""
    for kk in range(WL.BK // 16):
        desc = WL.a_desc(0, consumer, kk, tn=False)
        for m in range(64):
            for k in range(16):
                assert (WL.wgmma_offset(desc, m, k, k_major=True)
                        == WL.tma_box_offset(64 * consumer + m, 16 * kk + k))


@pytest.mark.parametrize("consumer", [0, 1])
def test_mn_major_operands_read_where_tma_wrote(consumer):
    """B (k rows of 256 columns, four 64-column boxes) and the TN
    product's X^T (consumer c's 64 columns of X, one box): MN-major
    descriptors with the transpose bit, k16 step kk at +2048 bytes."""
    base = 3 * WL.STAGE_BYTES   # a stage of the ring other than the first
    for kk in range(WL.BK // 16):
        b = WL.b_desc(base, kk)
        a = WL.a_desc(base, consumer, kk, tn=True)
        for k in range(16):
            for n in range(0, WL.BN, 7):
                want = (base + WL.A_BYTES + (n // WL.MN_CHUNK) * WL.B_CHUNK_BYTES
                        + WL.tma_box_offset(16 * kk + k, n % WL.MN_CHUNK))
                assert WL.wgmma_offset(b, n, k, k_major=False) == want
            for i in range(64):
                want = base + consumer * WL.A_HALF_BYTES + WL.tma_box_offset(16 * kk + k, i)
                assert WL.wgmma_offset(a, i, k, k_major=False) == want


def test_concat_maps_with_ragged_k_and_tails():
    """[A1 | A2] with K1 200 (rows 256 wide) and K2 1400 (rows 1408 wide),
    M 33,001, N 264: each part's map ends exactly at its K, so the step
    that crosses it reads zeros, not the row's padding; B's second range
    starts at row K1."""
    g = WL.gemm_maps(M=33001, K1=200, K2=1400, N=264, lda1=256, lda2=1408, ldb=264)
    m = g["maps"]
    assert m["a1"] == WL.TensorMap(0, 200, 33001, 512, 64, 128)
    assert m["b1"] == WL.TensorMap(0, 264, 200, 528, 64, 64)
    assert m["a2"] == WL.TensorMap(0, 1400, 33001, 2816, 64, 128)
    assert m["b2"] == WL.TensorMap(200 * 264, 264, 1400, 528, 64, 64)
    assert (g["kt1"], g["kt2"], g["tiles_n"], g["units"]) == (4, 22, 2, 258 * 2)
    steps = WL.gemm_steps(M=33001, K1=200, K2=1400, N=264, lda1=256, lda2=1408, ldb=264)
    assert len(steps) == 26
    assert steps[3] == (("a1", 192, 0), [("b1", 64 * j, 192) for j in range(4)])
    assert steps[4] == (("a2", 0, 0), [("b2", 64 * j, 0) for j in range(4)])
    assert steps[-1][0] == ("a2", 1344, 0)   # 1344 + 64 > 1400: zeros past K2
    # no concat: one range, no second maps
    g = WL.gemm_maps(M=65536, K1=1408, K2=0, N=256, lda1=1408, lda2=0, ldb=256)
    assert set(g["maps"]) == {"a1", "b1"} and (g["kt1"], g["kt2"], g["units"]) == (22, 0, 512)


@pytest.mark.parametrize("bases,ld,msg", [
    ((8, 0, 0), 256, "A1"),      # A1 8 bytes past a 16-byte boundary
    ((0, 2, 0), 256, "A2"),      # A2 misaligned
    ((0, 0, 0), 260, "A1"),      # rows 520 bytes apart
])
def test_tma_preconditions(bases, ld, msg):
    with pytest.raises(ValueError, match=msg):
        WL.gemm_maps(M=128, K1=256, K2=256, N=256, lda1=ld, lda2=256, ldb=256, bases=bases)
    with pytest.raises(ValueError):
        WL.tn_maps(M=128, K=256, N=256, ldx=256, ldy=256, split=96)   # split % 64


def test_tn_split_and_workspace():
    """dW over 33,001 points at K 256, N 320: 2 x 3 tiles of 128 x 128,
    22 splits of 1,536 points (the last 745: twelve steps, zeros past M),
    about one work unit per SM; the partials fit the scratch."""
    split = WL.tn_split(256, 320, 33001, FT._TN_BLOCKS_BF16)
    assert split == 1536
    t = WL.tn_maps(M=33001, K=256, N=320, ldx=320, ldy=320, split=split)
    assert (t["Kp"], t["Np"], t["tiles"], t["splits"], t["units"]) == (256, 384, 6, 22, 132)
    assert t["steps"][0] == 24 and t["steps"][-1] == 12
    assert t["maps"]["a1"] == WL.TensorMap(0, 256, 33001, 640, 64, 64)
    assert WL.tn_workspace(256, 320, 33001, split) == 22 * 256 * 384
    # the widest dW of a train step fits the scratch FT._WS_FLOATS
    for K, N in ((1408, 256), (256, 256), (256, 320), (1408, 64)):
        for m in (28224, 56448, 65536, 70001):
            s = WL.tn_split(K, N, m, FT._TN_BLOCKS_BF16)
            assert s % WL.BK == 0 and WL.tn_workspace(K, N, m, s) <= FT._WS_FLOATS
