// The bf16 GEMM mainloop shared by gemm_kernel (common.cuh, C = epilogue(
// [A1 | A2] @ B)) and gemm_tn_kernel (trunk.cuh, dW = X^T Y over the
// point axis), written for Hopper: wgmma.mma_async m64n256k16 with bf16
// operands and f32 accumulators, on tiles that TMA
// (cp.async.bulk.tensor.2d) lands in a ring of STAGES shared-memory stages
// with 128-byte swizzle.
//
// A block is three warpgroups.  Warpgroup 0 is the producer: one thread
// issues every TMA load, and setmaxnreg hands its registers to the
// consumers.  Warpgroups 1 and 2 are the consumers, each owning 64 rows of
// a BM x BN = 128 x 256 output tile (128 f32 accumulators a thread;
// gemm_tn_kernel's tiles are 128 x BN_TN = 128, mainloop says why).  Each
// stage has a full barrier (the producer's expect_tx, completed by TMA) and
// an empty one (each consumer warp arrives once its wgmma no longer reads
// the stage).  The kernel is persistent: one block per SM walks the work
// units blockIdx.x, + gridDim.x, ..., and the producer runs ahead into the
// next unit's stages while the consumers run the last unit's epilogue.
//
// Shared-memory layouts (the arithmetic is ops/wgmma_layout.py, mirrored
// here; tests/test_torch_wgmma_layout.py holds the two together):
//  * gemm_kernel's A is K-major: a stage is one BK (k) x BM (m) TMA box,
//    128 rows of 128 bytes; wgmma reads it through a K-major descriptor
//    (SBO 1024 bytes = 8 rows), the start advanced 32 bytes per k16 step.
//  * B (K x N row-major) and both operands of the TN product (points x
//    columns) are MN-major: boxes of 64 (mn) x BK (k), each BK k-rows of
//    128 bytes, read through an MN-major descriptor with wgmma's transpose
//    bit (LBO 8192 bytes: the next 64 columns; SBO 1024: the next 8
//    k-rows), the start advanced 2048 bytes per k16 step.  No operand is
//    repacked: the weights stay (K, N) row-major.
//  * The concat [A1 | A2] over K runs as two K ranges, each with tensor
//    maps of its own (A1 with K extent K1 and B's first K1 rows; A2 with
//    extent K2 and B's rows from K1 on): TMA's out-of-bounds zero fill
//    covers a ragged K step, the M tail and the N tail, never the bytes
//    past K1 in A1's row.
//  * a_scale / x_scale (the skip concat): each consumer warpgroup rounds
//    its own 64-row half of a landed A stage to bf16(x * scale) in shared
//    memory, then fence.proxy.async.shared::cta and a warpgroup barrier, so
//    that wgmma (the async proxy) reads the scaled bytes.
// Each output is the sum of its K steps in one fixed order (no split-K
// atomics): a rerun gives the same bits.
//
// What bounds it on an H100, at the trunk's shapes (M 65,536 points, N
// 256): a K-256 layer moves ~134 MB (A, the bf16 activation, the f32
// sigmoid row S) for 8.6 GFLOP, bytes-bound (40 us at 3.35 TB/s against
// 8.7 us of bf16 tensor-core work); K 1408 / 1664 is near balance (184 MB
// of A for 47 GFLOP).  So A is read once (a 256-wide tile covers N = 256;
// the column tiles of one row block are neighbouring units, so a wider N
// reads A from L2), the epilogue of one unit overlaps the next unit's
// loads, and the products run at wgmma's rate.  The TN product over the
// points reads Y once and X once per 128-column tile (the tiles of one
// split are neighbouring units: from L2 after the first) and writes f32
// partials.  Measured (bench_gemm.py, an H100 80GB HBM3 at 700 W): the
// mainloop alone (epilogue8 skipped) runs at torch.matmul's speed or
// better; epilogue8 on the 8 consumer warps of an SM then takes 30-80% of
// gemm_kernel's time (the softplus rows the most), and the kernel reads
// 34-61% of its bytes bound.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace honerf {
namespace wg {

constexpr int BM = 128;                    // output rows of a tile: two consumers x 64
constexpr int BN = 256;                    // output columns of a tile: one m64n256k16
constexpr int BK = 64;                     // K of a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;                  // ring depth
constexpr int MN_CHUNK = 64;               // bf16 columns of one MN-major box
constexpr int A_BYTES = BM * BK * 2;       // 16 KB: the A tile of a stage
constexpr int A_HALF_BYTES = A_BYTES / 2;  // one consumer's 64 rows (or TN's 64 columns)
constexpr int B_CHUNK_BYTES = BK * MN_CHUNK * 2;  // 8 KB: 64 columns x BK k-rows
constexpr int B_BYTES = BK * BN * 2;       // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// wgmma descriptor constants (bytes)
constexpr int SBO = 1024;                  // 8 rows of 128 bytes
constexpr int K_MAJOR_LBO = 16;            // unused by a swizzled K-major operand
constexpr int MN_MAJOR_LBO = B_CHUNK_BYTES;
constexpr int K_MAJOR_K16 = 32;            // start advance per k16 step
constexpr int MN_MAJOR_K16 = 2048;
// the epilogue's per-warp f32 slab: 16 rows x 32 columns, row stride
// EPI_LD floats (44: the float2 writes and float4 reads are both free of
// bank conflicts)
constexpr int EPI_LD = 44;
constexpr int EPI_WARP_FLOATS = 16 * EPI_LD;
constexpr int CONSUMER_WARPS = 8;
constexpr int EPI_BYTES = CONSUMER_WARPS * EPI_WARP_FLOATS * 4;
// gemm_tn_kernel's tiles are BM x BN_TN: one m64n128k16 a consumer, so
// that each K stage can sum into fresh accumulators (mainloop)
constexpr int BN_TN = 128;
constexpr int TN_STAGE_BYTES = A_BYTES + BK * BN_TN * 2;  // 32 KB of a 48 KB stage
constexpr int THREADS = 384;               // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// 1024 bytes of slack align the ring to the swizzle pattern's 1024-byte period
constexpr int SMEM_BYTES = 1024 + RING_BYTES + EPI_BYTES + 2 * STAGES * 8;

// One work unit: an output tile (and, for TN, a range of points).
struct Unit {
  int r0, c0;   // first output row and column
  int kt1;      // K steps over A1 (gemm_kernel); the rest run over A2
  int steps;    // K steps in all
  int p0, s;    // TN: first point and split index
};

// Tensor maps and the work split of one launch.
struct GemmMaps {
  CUtensorMap a1, a2, b1, b2;  // gemm_kernel: A1, A2, B rows [0, K1), B rows [K1, K1 + K2);
                               // gemm_tn_kernel: X (a1), Y (b1)
  int units;                   // work units
  int tiles_n;                 // column tiles
  int tiles;                   // TN: output tiles (row tiles x column tiles)
  int kt1, kt2;                // gemm_kernel: K steps of A1 and of A2
  int M, split;                // TN: points, points per split (a multiple of BK)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 64-bit wgmma shared-memory matrix descriptor: start address >> 4 in
// bits 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in
// 32-45, base offset 0 (the ring is 1024-byte aligned), swizzle mode in
// 62-63 (1: 128-byte swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One 2D TMA box into shared memory at dst, completing on bar; c0 is the
// inner (contiguous) coordinate in elements, c1 the row.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), both bf16 from shared
// memory.  TA / TB: the transpose bits (0: K-major, 1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128); scale_d 0: d = A B.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64); one MN-major B box.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint4 scale_bf16x8(uint4 v, float s) {
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(__bfloat162float(h[i]) * s);
  return v;
}

template <bool kTN>
__device__ __forceinline__ Unit unit_of(const GemmMaps& g, int u) {
  Unit w;
  if constexpr (!kTN) {
    w.r0 = (u / g.tiles_n) * BM;
    w.c0 = (u % g.tiles_n) * BN;
    w.kt1 = g.kt1;
    w.steps = g.kt1 + g.kt2;
    w.p0 = 0;
    w.s = 0;
  } else {
    // units of one split are neighbours: the blocks in flight share points
    w.s = u / g.tiles;
    const int t = u % g.tiles;
    w.r0 = (t / g.tiles_n) * BM;
    w.c0 = (t % g.tiles_n) * BN_TN;
    w.p0 = w.s * g.split;
    const int end = min(g.M, w.p0 + g.split);
    w.steps = (end - w.p0 + BK - 1) / BK;
    w.kt1 = w.steps;
  }
  return w;
}

// The producer thread: every unit's K steps into the ring.
template <bool kTN>
__device__ __forceinline__ void produce(const GemmMaps& g, uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  prefetch_map(&g.a1);
  prefetch_map(&g.b1);
  if (!kTN && g.kt2) {
    prefetch_map(&g.a2);
    prefetch_map(&g.b2);
  }
  int it = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit w = unit_of<kTN>(g, u);
    for (int k = 0; k < w.steps; ++k, ++it) {
      const int stage = it % STAGES;
      const uint32_t round = it / STAGES;
      mbar_wait(empty + 8 * stage, (round & 1) ^ 1);  // the consumers freed it
      const uint32_t a = ring + stage * STAGE_BYTES, b = a + A_BYTES, bar = full + 8 * stage;
      mbar_expect_tx(bar, kTN ? TN_STAGE_BYTES : STAGE_BYTES);
      if constexpr (!kTN) {
        const bool first = k < w.kt1;
        const int kk = (first ? k : k - w.kt1) * BK;
        tma_load(first ? &g.a1 : &g.a2, a, bar, kk, w.r0);
#pragma unroll
        for (int j = 0; j < BN / MN_CHUNK; ++j)
          tma_load(first ? &g.b1 : &g.b2, b + j * B_CHUNK_BYTES, bar, w.c0 + j * MN_CHUNK, kk);
      } else {
        const int pt = w.p0 + k * BK;
#pragma unroll
        for (int c = 0; c < BM / MN_CHUNK; ++c)
          tma_load(&g.a1, a + c * A_HALF_BYTES, bar, w.r0 + c * MN_CHUNK, pt);
#pragma unroll
        for (int j = 0; j < BN_TN / MN_CHUNK; ++j)
          tma_load(&g.b1, b + j * B_CHUNK_BYTES, bar, w.c0 + j * MN_CHUNK, pt);
      }
    }
  }
}

// A consumer's K step in two parts.  prepare: wait for the stage's full
// barrier (round: the ring's lap) and, when scale != 0, round this
// consumer's A half to bf16(A * scale) in shared memory, then make it
// visible to wgmma (the async proxy).  launch: issue the stage's four k16
// products into d (fresh: the first one overwrites d) and commit them.
__device__ __forceinline__ void prepare(unsigned char* ring_ptr, uint32_t full, int c,
                                        float scale, int stage, uint32_t round) {
  mbar_wait(full + 8 * stage, round & 1);    // the stage has landed
  if (scale != 0.f) {  // the skip concat: this consumer's A half -> bf16(A * scale)
    uint4* half = reinterpret_cast<uint4*>(ring_ptr + stage * STAGE_BYTES + c * A_HALF_BYTES);
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int i = 0; i < A_HALF_BYTES / 16 / 128; ++i)
      half[tid + 128 * i] = scale_bf16x8(half[tid + 128 * i], scale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  }
}

template <bool kTN, int R>
__device__ __forceinline__ void launch(float (&d)[R], uint32_t ring, int c, int stage,
                                       bool fresh) {
  const uint32_t a = ring + stage * STAGE_BYTES + c * A_HALF_BYTES;
  const uint32_t b = ring + stage * STAGE_BYTES + A_BYTES;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = smem_desc(b + kk * MN_MAJOR_K16, MN_MAJOR_LBO, SBO);
    const int scale_d = fresh && kk == 0 ? 0 : 1;
    if constexpr (kTN)
      wgmma_m64n128k16<1, 1>(d, smem_desc(a + kk * MN_MAJOR_K16, MN_MAJOR_LBO, SBO), db,
                             scale_d);
    else
      wgmma_m64n256k16<0, 1>(d, smem_desc(a + kk * K_MAJOR_K16, K_MAJOR_LBO, SBO), db,
                             scale_d);
  }
  wgmma_commit();
  fence_acc(d);
}

// The whole kernel body.  kTN: A is MN-major (X^T of the TN product), else
// K-major.  scale != 0 rounds A to bf16(A * scale) before the products.
// epi(acc, unit, consumer, slab) stores a consumer's 64 x BN sums
// (gemm_kernel) or 64 x BN_TN (gemm_tn_kernel); slab: the calling warp's
// EPI_WARP_FLOATS of f32 staging.
//
// The tensor core adds each k16 product into its f32 accumulators rounding
// toward zero, so a long sum drifts below the exact one: ~1.4e-6 of its
// norm after 88 k16 steps (K 1408), ~6e-6 over the TN product's
// ~5,500-point splits summed straight into one accumulator.  So
// gemm_kernel (K <= 1664) keeps one accumulator, and the TN consumers sum
// each K stage into fresh accumulators (scale-d 0 on its first k16 step),
// added into the running sums with round to nearest once the stage's
// products are done: with m64n128k16, 64 running sums and 64 fresh ones a
// thread (two fresh sets, to keep one step's products in flight while the
// last one's are added, spill and serialize the wgmmas).
template <bool kTN, class Epi>
__device__ __forceinline__ void mainloop(const GemmMaps& g, float scale, const Epi& epi) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t raw = smem_u32(wg_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_ptr = wg_smem + (ring - raw);
  float* slabs = reinterpret_cast<float*>(ring_ptr + RING_BYTES);
  const uint32_t full = ring + RING_BYTES + EPI_BYTES;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + 8 * STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) produce<kTN>(g, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = warpgroup - 1;              // rows 64c..64c+63 of the tile
  const int lane = threadIdx.x & 31;
  float* slab = slabs + (threadIdx.x / 32 - 4) * EPI_WARP_FLOATS;
  constexpr int R = kTN ? BN_TN / 2 : BN / 2;   // accumulators a thread
  float acc[R];
  int it = 0;
  for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
    const Unit w = unit_of<kTN>(g, u);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    if constexpr (!kTN) {
      int prev = -1;
      for (int k = 0; k < w.steps; ++k, ++it) {
        const int stage = it % STAGES;
        prepare(ring_ptr, full, c, scale, stage, it / STAGES);
        launch<kTN>(acc, ring, c, stage, false);
        wgmma_wait<1>();   // the previous step's products are done: free its stage
        fence_acc(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    } else {
      // the next stage is waited for and scaled while this one's products run
      float part[R];
      int stage = it % STAGES;
      prepare(ring_ptr, full, c, scale, stage, it / STAGES);
      for (int k = 0; k < w.steps; ++k) {
        launch<kTN>(part, ring, c, stage, true);
        const int done = stage;
        ++it;
        if (k + 1 < w.steps) {
          stage = it % STAGES;
          prepare(ring_ptr, full, c, scale, stage, it / STAGES);
        }
        wgmma_wait<0>();
        fence_acc(part);
        if (lane == 0) mbar_arrive(empty + 8 * done);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += part[i];
      }
    }
    epi(acc, w, c, slab);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps (cached), the SM count, the launch shape
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: fetched through the runtime, so
// the library needs no -lcuda.
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

struct MapKey {
  const void* ptr;
  uint64_t inner, outer, row_bytes;
  uint32_t box_inner, box_outer, elem_bytes;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer && row_bytes == o.row_bytes &&
           box_inner == o.box_inner && box_outer == o.box_outer && elem_bytes == o.elem_bytes;
  }
};

// A bf16 (elem_bytes 2) or f32 (4) row-major matrix of `outer` rows of
// `inner` elements, `ld` elements apart, in boxes of box_inner x box_outer
// with 128-byte swizzle and zero fill out of bounds.  Encoded maps are kept
// by (pointer, extents, stride, box, type): a map holds nothing else, so a
// hit is exact.  False on an operand TMA cannot take (a base not 16-byte
// aligned, a row stride not a multiple of 16 bytes).
static bool tma_map(CUtensorMap* out, const void* ptr, int inner, int outer, int ld,
                    int box_inner, int box_outer, int elem_bytes = 2) {
  constexpr int kSlots = 256;
  static MapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static bool used[kSlots];
  static std::mutex lock;
  const MapKey key{ptr, (uint64_t)inner, (uint64_t)outer, (uint64_t)ld * elem_bytes,
                   (uint32_t)box_inner, (uint32_t)box_outer, (uint32_t)elem_bytes};
  if (inner <= 0 || outer <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (reinterpret_cast<uintptr_t>(ptr) & 15) || key.row_bytes % 16)
    return false;
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) * 0x9E3779B97F4A7C15ull;
  h ^= (key.inner * 31 + key.outer) * 0xC2B2AE3D27D4EB4Full ^ key.row_bytes ^
       ((uint64_t)box_outer << 8) ^ ((uint64_t)elem_bytes << 40);
  const int slot = (int)((h >> 32) % kSlots);
  std::lock_guard<std::mutex> guard(lock);
  if (used[slot] && keys[slot] == key) {
    *out = maps[slot];
    return true;
  }
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {key.inner, key.outer};
  const cuuint64_t strides[1] = {key.row_bytes};
  const cuuint32_t box[2] = {key.box_inner, key.box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r = enc(out, type, 2, const_cast<void*>(ptr), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  keys[slot] = key;
  maps[slot] = *out;
  used[slot] = true;
  return true;
}

// SMs of the current device (one persistent block each).
static int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

}  // namespace wg
}  // namespace honerf
