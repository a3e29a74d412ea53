// Device code shared by the f32 fused kernels, 3xTF32 on wgmma:
// csrc/trunk_fused_f32.cu (the trunk's forward and u-chain),
// csrc/trunk_bwd_f32.cu (its backward's two chains) and
// csrc/color_fused_f32.cu (the color net's forward and transpose); the
// last two share the ring kernels' shell below.
//
//  * The tile: 64 points of up to 256 f32 columns in chunks of 32 columns,
//    each 64 rows of 128 bytes with the 128-byte swizzle (t32_offset): the
//    bytes of a TMA box of f32, and what the A fragments read.
//  * A K step of 32 (t32_steps): A from the tile (or a box in a ring slot)
//    into registers and split there, big = tf32(x), small = tf32(x - big);
//    B's [big; small] rows (fused_fine.tf32_operands, K-major) in two ring
//    slots; into a fresh accumulator the four k8 products big.small, then
//    small.big, then big.big, added to the running sum with round to
//    nearest (gemm_f32_kernel's order: the tensor core's adds truncate).
//  * Both consumer warpgroups read all 64 rows of A and each computes half
//    of a phase's columns (wgmma m64nNk8 .tf32, N = 128, 64 or 32).
//
// The design notes: csrc/trunk_fused_f32.cu.

#pragma once

#include "common.cuh"

namespace honerf {

constexpr int TF32_TILE = 64;                                       // points a tile
constexpr int TF32_WIDTH = 256;                                     // the widest layer
constexpr int TF32_BK = 32;                                         // a K step: 128 B of f32
constexpr int TF32_CHUNK_BYTES = TF32_TILE * 128;                   // 32 columns of the tile
constexpr int TF32_ACT_BYTES = TF32_WIDTH / TF32_BK * TF32_CHUNK_BYTES;  // the act (or t) tile
constexpr int TF32_A_BYTES = TF32_CHUNK_BYTES;                      // e's box: 32 cols x 64 rows
constexpr int TF32_BOX_ROWS = 64;                                   // B rows of one TMA box
constexpr int TF32_BOX_BYTES = TF32_BOX_ROWS * 128;
constexpr int TF32_B_BYTES = TF32_WIDTH * 128;                      // 256 B rows x 32 k
constexpr int TF32_STAGE_BYTES = TF32_A_BYTES + TF32_B_BYTES;
constexpr int TF32_STAGES = 4;
constexpr int TF32_RING_BYTES = TF32_STAGES * TF32_STAGE_BYTES;
constexpr int TF32_SMEM_BYTES = 1024 + TF32_ACT_BYTES + TF32_RING_BYTES + 2 * TF32_STAGES * 8;
constexpr int TF32_MAX_LAYERS = 10;
constexpr int TF32_MAX_PHASES = 14;
constexpr int TF32_UC_STAGES = 3;
constexpr int TF32_UC_STAGE_BYTES = TF32_B_BYTES;
constexpr int TF32_UC_RING_BYTES = TF32_UC_STAGES * TF32_UC_STAGE_BYTES;
constexpr int TF32_UC_SMEM_BYTES =
    1024 + 2 * TF32_ACT_BYTES + TF32_UC_RING_BYTES + 2 * TF32_UC_STAGES * 8;
constexpr int TF32_PIECE = 256;                                     // u columns a piece
constexpr int TF32_UC_MAX_PHASES = 40;

// Byte offset of element (row, col) of a tile stored as chunks of 32 f32
// columns, each 64 rows of 128 bytes with the 128-byte swizzle (the bytes
// of a TMA box of e, and of gemm_kernel's K-major A).
__device__ __forceinline__ uint32_t t32_offset(int row, int col) {
  const int b = 4 * (col & 31);
  return (uint32_t)((col >> 5) * TF32_CHUNK_BYTES + row * 128 + ((((b >> 4) ^ (row & 7))) << 4) +
                    (b & 15));
}

// d (64 x NW, f32) (+)= A (64 x 8) B (8 x NW), A tf32 in registers.
template <int NW>
__device__ __forceinline__ void t32_mma(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d);

// d (64 x 128, f32) (+)= A (64 x 8) B (8 x 128): A the tf32 register fragment,
// B K-major from shared memory; scale_d 0: d = A B.
template <>
__device__ __forceinline__ void t32_mma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 8) B (8 x 64): A the tf32 register fragment,
// B K-major from shared memory; scale_d 0: d = A B.
template <>
__device__ __forceinline__ void t32_mma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 32, f32) (+)= A (64 x 8) B (8 x 32): A the tf32 register fragment,
// B K-major from shared memory; scale_d 0: d = A B.
template <>
__device__ __forceinline__ void t32_mma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void t32_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[i][q])::"memory");
}

// Both consumer warpgroups (256 threads) at named barrier 1.
__device__ __forceinline__ void t32_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// The A fragments of a 32-deep K step from a chunk of 32 columns
// (t32_offset's layout): k8 step kk's a0 (r, t), a1 (r + 8, t), a2 (r,
// t + 4), a3 (r + 8, t + 4).
__device__ __forceinline__ void t32_load_a(const unsigned char* chunk, int r, int t,
                                           float (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[kk][q] = *reinterpret_cast<const float*>(
          chunk + t32_offset(r + 8 * (q & 1), 8 * kk + t + 4 * (q >> 1)));
}

// Each value times scale (the skip's f32 1/sqrt2, else exactly 1), then
// split_tf32 (common.cuh).
__device__ __forceinline__ void t32_split_a(const float (&x)[4][4], float scale,
                                            uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(x[kk][q] * scale, ab[kk][q], as[kk][q]);
}

// A K step's sum into the running one, rounded to nearest; returns the
// scale-d of the next step's first product: 0, a fresh sum.
template <int R>
__device__ __forceinline__ int t32_accumulate(float (&run)[R], const float (&fresh)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) run[i] = __fadd_rn(run[i], fresh[i]);
  return 0;
}

// A phase's `steps` K steps of 32 for a consumer's NW columns into run.
// Step k waits for its two slots (s1: B's small rows, then s2: its big
// rows; B at byte boff of a slot, NW rows of 128 bytes), takes A from
// src(k, s1) (the tile's chunk, or e's box in s1) once s1 landed; fresh =
// big.small, then small.big, then big.big over the four k8 steps (the
// first with scale-d `open`: 0, a fresh sum), run += fresh.  Each slot is
// freed once its products are done.  (Loading the next step's A while a
// step's products run measured slower, whether or not it waited for the
// next slot first: PERF.md section 6.)
template <int NW, class Src>
__device__ __forceinline__ void t32_steps(float (&run)[NW / 2], int steps, const Src& src,
                                          float scale, uint32_t ring, uint32_t full,
                                          uint32_t empty, int stages, int stage_bytes, int boff,
                                          int r, int t, int& it) {
  const int lane = threadIdx.x & 31;
  float fresh[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) run[i] = fresh[i] = 0.f;
  int open = 0;
  for (int k = 0; k < steps; ++k) {
    const int s1 = it % stages;
    wg::mbar_wait(full + 8 * s1, (it / stages) & 1);
    uint32_t ab[4][4], as[4][4];
    {
      float x[4][4];
      t32_load_a(src(k, s1), r, t, x);
      t32_split_a(x, scale, ab, as);
    }
    const uint32_t b1 = ring + s1 * stage_bytes + boff;
    wg::fence_acc(fresh);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b1 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO),
                  kk ? 1 : open);
    wg::wgmma_commit();
    const int s2 = (it + 1) % stages;
    wg::mbar_wait(full + 8 * s2, ((it + 1) / stages) & 1);
    const uint32_t b2 = ring + s2 * stage_bytes + boff;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      t32_mma<NW>(fresh, as[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);
    wg::wgmma_commit();
    it += 2;
    wg::wgmma_wait<1>();
    if (lane == 0) wg::mbar_arrive(empty + 8 * s1);
    wg::wgmma_wait<0>();
    wg::fence_acc(fresh);
    t32_fence(ab);
    t32_fence(as);
    if (lane == 0) wg::mbar_arrive(empty + 8 * s2);
    open = t32_accumulate(run, fresh);
  }
}

// ---------------------------------------------------------------------------
// The ring kernels' shell (csrc/trunk_bwd_f32.cu, csrc/color_fused_f32.cu):
// the 64 KB tile, then a TF32_STAGES-slot ring of [A's box | B's rows]
// slots; warpgroup 0's first thread streams each phase's K steps, two
// slots a step (B's small rows with the box, then B's big rows).
// ---------------------------------------------------------------------------

// A phase of a tile: K steps of 32 over the tile, then over box map 0's
// boxes, then map 1's (each from its column 0; B's k runs on across the
// three ranges), B: `width` rows of layer `layer`'s [big; small] map from
// row0 (its small rows from small_rows[layer] + row0); kind: the kernel's
// epilogue.
struct T32RingPhase {
  int act_steps, box_steps0, box_steps1, layer, row0, width, kind;
};

// What the producer streams: the phases of a tile, A's box maps ((M, K)
// f32, boxes of 32 x 64), each layer's [big; small] B map (boxes of 32 x
// 64).
template <int PHASES>
struct T32Ring {
  CUtensorMap box[2];
  CUtensorMap w[TF32_MAX_LAYERS];
  T32RingPhase ph[PHASES];
  int small_rows[TF32_MAX_LAYERS];
  int n_phases, n_maps, n_boxes, tiles;
};

template <class Ring>
__device__ __forceinline__ void t32_ring_produce(const Ring& q, uint32_t ring, uint32_t full,
                                                 uint32_t empty) {
  for (int i = 0; i < q.n_boxes; ++i) wg::prefetch_map(&q.box[i]);
  for (int l = 0; l < q.n_maps; ++l) wg::prefetch_map(&q.w[l]);
  int it = 0;
  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    for (int k_ph = 0; k_ph < q.n_phases; ++k_ph) {
      const T32RingPhase& ph = q.ph[k_ph];
      const int steps = ph.act_steps + ph.box_steps0 + ph.box_steps1;
      for (int k = 0; k < steps; ++k) {
        const int kb = k - ph.act_steps;
        const int box = kb >= ph.box_steps0 ? 1 : 0;
        const int col = TF32_BK * (box ? kb - ph.box_steps0 : kb);
        for (int half = 0; half < 2; ++half, ++it) {  // 0: B's small rows, 1: its big rows
          const int stage = it % TF32_STAGES;
          wg::mbar_wait(empty + 8 * stage, ((it / TF32_STAGES) & 1) ^ 1);
          const uint32_t sb = ring + stage * TF32_STAGE_BYTES, bar = full + 8 * stage;
          const bool with_a = kb >= 0 && half == 0;
          wg::mbar_expect_tx(bar, ph.width / TF32_BOX_ROWS * TF32_BOX_BYTES +
                                      (with_a ? TF32_A_BYTES : 0));
          if (with_a) wg::tma_load(&q.box[box], sb, bar, col, tile * TF32_TILE);
          const int row0 = (half == 0 ? q.small_rows[ph.layer] : 0) + ph.row0;
          for (int j = 0; j < ph.width / TF32_BOX_ROWS; ++j)
            wg::tma_load(&q.w[ph.layer], sb + TF32_A_BYTES + j * TF32_BOX_BYTES, bar,
                         TF32_BK * k, row0 + TF32_BOX_ROWS * j);
        }
      }
    }
  }
}

// A phase's products: consumer c's NW columns into run, A from the tile's
// chunks, then the boxes in the slots.
template <int NW>
__device__ __forceinline__ void t32_ring_mma(float (&run)[NW / 2], const T32RingPhase& ph,
                                             const unsigned char* tile,
                                             const unsigned char* ring_ptr, uint32_t ring,
                                             uint32_t full, uint32_t empty, int c, int r, int t,
                                             int& it) {
  const auto src = [&](int k, int s1) {
    return k < ph.act_steps ? tile + k * TF32_CHUNK_BYTES : ring_ptr + s1 * TF32_STAGE_BYTES;
  };
  t32_steps<NW>(run, ph.act_steps + ph.box_steps0 + ph.box_steps1, src, 1.f, ring, full, empty,
                TF32_STAGES, TF32_STAGE_BYTES, TF32_A_BYTES + c * NW * 128, r, t, it);
}

// The cells of f32 rows (ld apart; ld 0: one row for every point) that a
// consumer thread's epilogue reads, all at once (0 past M): their loads
// are issued before the consumers' barrier.
template <int NW>
__device__ __forceinline__ void t32_load_rows(float2 (&v)[NW / 8][2], const float* rows, int ld,
                                              int M, int c, int t, int grow0) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      v[j][h] = grow < M ? __ldg(reinterpret_cast<const float2*>(rows + (size_t)grow * ld +
                                                                 c * NW + 8 * j + 2 * t))
                         : make_float2(0.f, 0.f);
    }
}

// A ring kernel's body: the shared memory, the ring's barriers, the
// producer; then each consumer walks the tiles, runs prologue(tile, tile
// index) and each phase, run(ph, ...).
template <class Args, class Prologue, class Run>
__device__ __forceinline__ void t32_ring_kernel(const Args& p, unsigned char* smem,
                                                const Prologue& prologue, const Run& run) {
  const uint32_t raw = wg::smem_u32(smem);
  const uint32_t tile_s = (raw + 1023) & ~1023u;
  unsigned char* tile = smem + (tile_s - raw);
  const unsigned char* ring_ptr = tile + TF32_ACT_BYTES;
  const uint32_t ring = tile_s + TF32_ACT_BYTES;
  const uint32_t full = ring + TF32_RING_BYTES, empty = full + 8 * TF32_STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF32_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == 0) t32_ring_produce(p.q, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  const int c = warpgroup - 1;  // columns c NW .. of each phase
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // rows r, r + 8 of the tile
  int it = 0;
  for (int tl = blockIdx.x; tl < p.q.tiles; tl += gridDim.x) {
    const int grow0 = tl * TF32_TILE + r;
    prologue(tile, tl);
    for (int k_ph = 0; k_ph < p.q.n_phases; ++k_ph)
      run(p.q.ph[k_ph], tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
  }
}

// Raise a kernel's dynamic shared-memory cap, once per process.
static cudaError_t t32_smem_ready(const void* kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace honerf
