// The bf16 color net in two launches: its forward (color_fwd_kernel) and
// its transpose (color_bwd_kernel) (ops/fused_fine_full.py: color_fwd,
// color_bwd; K2's passes and K3's recompute call the forward, K3's passes
// the transpose).
//
// Replaces: the bf16 mode of `_color_fwd_block` (honerf_tpu/ops/
//   fused_fine_full.py:854-869, called from `_fine_fwd_block` :920) inside
//   K2's pallas_call (:1556) and K3's recompute, and of `_color_bwd_block`
//   (:872-913, with res_stash: the sigmoid read back, the relu masks from
//   the kept activations) inside K3's pallas_call (:1650), with
//   FineMeta(dtype='bf16').  The split launches they replace (one
//   gemm_kernel a layer; color_dz_kernel before the transpose's) stay
//   callable for comparison only (fused_fine_full._color_fwd_split,
//   _color_bwd_split).
//
// What bounds them on an H100: operations, near balance.  The forward's
//   products, [e 1408 | feat 256 | grad-PE 128] -> 256 -> 256 -> 256 -> 256
//   -> 64, are ~1.24 MFLOP a point, the transpose's the same: ~1.25 ms per
//   million points each at 989 TFLOP/s.  Their bytes: e and [feat |
//   grad-PE] read (3.6 KB a point), with keep the four relu rows written
//   (2 KB); the transpose reads those rows and writes dx (7 KB f32) and,
//   with dW, the five dz rows in f32 and bf16 (7.7 KB).  The weights (~1.3
//   MB) stay in L2.
//
// Design (csrc/trunk_fused.cu's, which holds the bf16 trunk): one
//   persistent block an SM walks tiles of CF16_TILE = 128 points.
//   Warpgroup 0 is the producer: one thread streams each phase's K steps
//   of 64 by TMA into a ring of CF16_STAGES stages, each an A box of 64
//   columns x 128 rows (16 KB) and 64 k-rows of the layer's weights (up to
//   256 columns, 32 KB), with wgmma.cuh's 128-byte swizzle.  Warpgroups 1
//   and 2 each own 64 of the tile's points and run wgmma m64n256k16
//   (m64n128k16 / m64n64k16 for a narrower piece) with the f32 sums in
//   registers; the epilogues work straight from the accumulators.  Shared
//   memory: the 64 KB bf16 activation tile (the K-major A layout wgmma
//   reads, tf_offset's) and the 144 KB ring, 209 KB.  ptxas (sm_90a): 168
//   registers a thread in either kernel, no spill; 214,064 bytes of dynamic
//   shared memory a block (CF16_SMEM_BYTES).
//
//  * The forward: layer 0 over e's Ep / 64 boxes (box map 0), then cx2's
//    X / 64 (map 1), B's k-row running on across both; layers 1 .. n-2
//    over the tile; each epilogue relu(acc + b) rounded to bf16 in place
//    into the consumer's own rows of the tile and, with keep, those rows
//    stored to acts[l] from the tile by TMA while the next layer's products
//    run (cf16_store_rows; K3's masks and its dW read them); the last
//    layer (64 columns, m64n64k16) stores sigmoid(acc + b) of its 3 real
//    columns into packed[:, 4:7] (rows 8 apart: scalar stores).
//  * The transpose: a tile's prologue forms dz = s (1 - s) dcolor (s read
//    back from packed; color_dz_kernel's arithmetic) on the last layer's 64
//    columns into the tile, with dW also to dzf[n-1] (f32) and dzb[n-1]
//    (bf16); then for layers n-1 .. 1 da = dz W_l^T over the tile (B =
//    W_l^T, the pack's cwts), masked by acts[l-1] > 0 in place into the
//    tile, with dW to dzf[l-1] and the tile's rows to dzb[l-1] by TMA
//    (EPI_MASK's arithmetic; cf16_store_rows); then dx = dz_0 W_0^T over
//    the tile in pieces of 256 columns (CF16_PIECE; 128
//    or 64 for the rest), each stored straight to dx (f32): no tile or
//    stage holds dx's 1792 columns.  The dW launches (gemm_tn_kernel,
//    colsum_partial_kernel) run after it on the dz rows, as before.
//
//   Every sum runs in the split launches' order: gemm_kernel's wgmma
//   m64n256k16 over 64-deep K steps in the same order (layer 0's e range,
//   then cx2's), one accumulator from zero, and epilogue8's arithmetic; the
//   last layer's 64 columns on m64n64k16, whose columns hold the same sums
//   (K1's sdf column, csrc/trunk_fused.cu).  So every output is expected
//   to keep the split launches' bits.
//
//   The two consumers share the weight stream in lockstep (trunk_fused.cu
//   says why no turns); ops/wgmma_layout.py: cf16_fwd_phases /
//   cf16_bwd_phases / cf16_loads model the tables, ring_schedule the
//   barriers (tests/test_torch_color_bf16_layout.py).

#include "wgmma.cuh"

namespace honerf {

constexpr int CF16_TILE = 128;
constexpr int CF16_WIDTH = 256;                                  // the widest layer: m64n256k16
constexpr int CF16_CHUNK_BYTES = CF16_TILE * 128;                // 64 columns of the tile
constexpr int CF16_ACT_BYTES = CF16_WIDTH / 64 * CF16_CHUNK_BYTES;
constexpr int CF16_A_BYTES = CF16_CHUNK_BYTES;                   // a box: 64 columns x 128 rows
constexpr int CF16_B_BYTES = 64 * CF16_WIDTH * 2;                // 64 k-rows of 256 columns
constexpr int CF16_STAGE_BYTES = CF16_A_BYTES + CF16_B_BYTES;
constexpr int CF16_STAGES = 3;
constexpr int CF16_RING_BYTES = CF16_STAGES * CF16_STAGE_BYTES;
constexpr int CF16_SMEM_BYTES = 1024 + CF16_ACT_BYTES + CF16_RING_BYTES + 2 * CF16_STAGES * 8;
constexpr int CF16_MAX_LAYERS = 10;
constexpr int CF16_MAX_PHASES = 24;
constexpr int CF16_PIECE = 256;                                  // dx columns a piece
constexpr int CF16_COLORS = 3;                                   // the last layer's real columns

enum CF16Kind { CF16_RELU = 0, CF16_SIGMOID = 1, CF16_MASK = 2, CF16_DX = 3 };

struct CF16Phase {
  int act_steps;   // K steps over the tile
  int box_steps0;  // then over box map 0's boxes (the forward's e)
  int box_steps1;  // then over map 1's (cx2)
  int layer;       // weight map, bias, mask row
  int n0;          // B's first column (dx's piece)
  int boxes;       // B boxes of 64 columns a K step: 4 (m64n256k16), 2 (n128) or 1 (n64)
  int kind;        // CF16Kind
};

struct CF16Ring {
  CUtensorMap box[2];                  // A boxes of 64 columns x 128 rows
  CUtensorMap w[CF16_MAX_LAYERS];      // B: (K, N) row-major, boxes of 64 x 64
  CF16Phase ph[CF16_MAX_PHASES];
  int n_phases, n_maps, n_boxes, tiles;
};

static bool cf16_misaligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
}

// Byte offset of element (row, col) of the tile: chunks of 64 columns,
// each 128 rows of 128 bytes with the 128-byte swizzle (trunk_fused.cu's
// tf_offset).
__device__ __forceinline__ uint32_t cf16_offset(int row, int col) {
  const int b = 2 * (col & 63);
  return (uint32_t)((col >> 6) * CF16_CHUNK_BYTES + row * 128 +
                    ((((b >> 4) ^ (row & 7))) << 4) + (b & 15));
}

__device__ __forceinline__ void cf16_sync(int c) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// The producer thread: every tile's phases' K steps into the ring (B's
// k-row 64 k, running on across a phase's ranges).
__device__ __forceinline__ void cf16_produce(const CF16Ring& q, uint32_t ring, uint32_t full,
                                             uint32_t empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    for (int i = 0; i < q.n_phases; ++i) {
      const CF16Phase& ph = q.ph[i];
      const int steps = ph.act_steps + ph.box_steps0 + ph.box_steps1;
      for (int k = 0; k < steps; ++k, ++it) {
        const int stage = it % CF16_STAGES;
        wg::mbar_wait(empty + 8 * stage, ((it / CF16_STAGES) & 1) ^ 1);
        const uint32_t sb = ring + stage * CF16_STAGE_BYTES, bar = full + 8 * stage;
        const int kb = k - ph.act_steps;
        wg::mbar_expect_tx(bar, ph.boxes * wg::B_CHUNK_BYTES + (kb >= 0 ? CF16_A_BYTES : 0));
        if (kb >= 0) {
          const int box = kb >= ph.box_steps0;
          wg::tma_load(&q.box[box], sb, bar, 64 * (box ? kb - ph.box_steps0 : kb),
                       tile * CF16_TILE);
        }
        for (int j = 0; j < ph.boxes; ++j)
          wg::tma_load(&q.w[ph.layer], sb + CF16_A_BYTES + j * wg::B_CHUNK_BYTES, bar,
                       ph.n0 + j * wg::MN_CHUNK, 64 * k);
      }
    }
  }
}

// One phase's products for consumer c into fresh accumulators (R 128:
// m64n256k16, 64: m64n128k16, 32: m64n64k16): its K steps over the tile,
// then over the stages' A boxes; each stage freed once the next step's
// products are issued and the previous ones retired (trunk_fused.cu's
// tf_mma).
template <int R>
__device__ __forceinline__ void cf16_mma(float (&acc)[R], const CF16Phase& ph, uint32_t act,
                                         uint32_t ring, uint32_t full, uint32_t empty, int c,
                                         int& it) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  int prev = -1;
  const int steps = ph.act_steps + ph.box_steps0 + ph.box_steps1;
  for (int k = 0; k < steps; ++k, ++it) {
    const int stage = it % CF16_STAGES;
    wg::mbar_wait(full + 8 * stage, (it / CF16_STAGES) & 1);
    const uint32_t sb = ring + stage * CF16_STAGE_BYTES;
    const uint32_t a = k < ph.act_steps ? act + k * CF16_CHUNK_BYTES + c * (CF16_CHUNK_BYTES / 2)
                                        : sb + c * (CF16_A_BYTES / 2);
    const uint32_t b = sb + CF16_A_BYTES;
    wg::fence_acc(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg::smem_desc(a + kk * wg::K_MAJOR_K16, wg::K_MAJOR_LBO, wg::SBO);
      const uint64_t db = wg::smem_desc(b + kk * wg::MN_MAJOR_K16, wg::MN_MAJOR_LBO, wg::SBO);
      if constexpr (R == 128)
        wg::wgmma_m64n256k16<0, 1>(acc, da, db, 1);
      else if constexpr (R == 64)
        wg::wgmma_m64n128k16<0, 1>(acc, da, db, 1);
      else
        wg::wgmma_m64n64k16<0, 1>(acc, da, db, 1);
    }
    wg::wgmma_commit();
    wg::fence_acc(acc);
    wg::wgmma_wait<1>();  // the previous step's products are done: free its stage
    wg::fence_acc(acc);
    if (prev >= 0 && lane == 0) wg::mbar_arrive(empty + 8 * prev);
    prev = stage;
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(acc);
  if (lane == 0) wg::mbar_arrive(empty + 8 * prev);
}

// The shell of both kernels: barriers, the producer, and the consumers'
// walk over the tiles (seed: the transpose's tile prologue; phase: one
// phase's products and epilogue).  acc[4j + q] holds tile row ra + 8 (q >>
// 1), column 8j + 2t + (q & 1); grow0 is row ra's point, in tile `tile`.
template <class Seed, class Phase>
__device__ __forceinline__ void cf16_ring_kernel(const CF16Ring& q, unsigned char* smem,
                                                 const Seed& seed, const Phase& phase) {
  const uint32_t raw = wg::smem_u32(smem);
  const uint32_t act = (raw + 1023) & ~1023u;
  unsigned char* act_ptr = smem + (act - raw);
  const uint32_t ring = act + CF16_ACT_BYTES;
  const uint32_t full = ring + CF16_RING_BYTES, empty = full + 8 * CF16_STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CF16_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int i = 0; i < q.n_boxes; ++i) wg::prefetch_map(&q.box[i]);
      for (int l = 0; l < q.n_maps; ++l) wg::prefetch_map(&q.w[l]);
      cf16_produce(q, ring, full, empty);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  const int c = warpgroup - 1;  // rows 64c..64c+63 of each tile
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ra = 64 * c + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  int it = 0;
  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    const int grow0 = tile * CF16_TILE + ra;
    seed(act_ptr, c, tile);
    for (int i = 0; i < q.n_phases; ++i)
      phase(q.ph[i], act, act_ptr, ring, full, empty, c, ra, t, tile, grow0, it);
  }
  // the rows' bulk stores (cf16_store_rows) complete before the block ends
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Consumer c's 64 rows of the tile's first `width` columns (bf16, as the
// epilogue left them) to the rows of `map` (the kept relu or dz rows) of
// tile `tile`: one TMA box of 64 columns x 64 rows a 64-column chunk (the
// tile's chunks are TMA's 128-byte-swizzled box layout), issued by the
// consumer's first thread once the epilogue's barrier has passed (its
// fence orders the writes before the async proxy's reads); rows past the
// map's M are not written.  The stores run while the next layer's
// products do: the threads' own copy, 16 bytes a thread, cost the forward
// with keep 0.12 of its 0.32 ms at 56,448 points (the epilogue's 4-byte
// stores of the pairs 0.20; an H100 80GB HBM3 at 700 W).
__device__ __forceinline__ void cf16_store_rows(const CUtensorMap* map, uint32_t act, int width,
                                                int c, int tile) {
  if ((threadIdx.x & 127) != 0) return;
  for (int k = 0; k < width / 64; ++k)
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(act + k * CF16_CHUNK_BYTES + c * (CF16_CHUNK_BYTES / 2)), "r"(64 * k),
        "r"(tile * CF16_TILE + 64 * c)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Before a write over the consumer's rows of the tile: its stores issued
// so far have read them.
__device__ __forceinline__ void cf16_rows_read(int c) {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  cf16_sync(c);
}

// ---------------------------------------------------------------------------
// color_fwd_kernel
// ---------------------------------------------------------------------------

struct CF16FwdArgs {
  CF16Ring q;                             // boxes: e, cx2; w: W_l (rows[l], cols[l])
  CUtensorMap act_map[CF16_MAX_LAYERS];   // keep: acts[l] in boxes of 64 x 64
  const float* bias[CF16_MAX_LAYERS];
  __nv_bfloat16* acts[CF16_MAX_LAYERS];   // keep: bf16(relu) of layer l (l < n - 1), or null
  int ldact, H;
  float* color;                           // the sigmoid's 3 columns, rows ldcolor apart
  int ldcolor, M;
};

// A relu layer's epilogue (EPI_RELU's arithmetic): bf16(relu(acc + b)) in
// place into the consumer's rows of the tile.
__device__ __forceinline__ void cf16_relu_epilogue(const float (&acc)[128], const CF16FwdArgs& p,
                                                   int l, unsigned char* act_ptr, int ra, int t) {
  const float* bias = p.bias[l];
#pragma unroll
  for (int j = 0; j < CF16_WIDTH / 8; ++j) {
    if (8 * j >= p.H) break;  // a narrower net: the tile's columns past H are not read
    const int col = 8 * j + 2 * t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(act_ptr + cf16_offset(ra + 8 * h, col)) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * h] + b.x, 0.f),
                                fmaxf(acc[4 * j + 2 * h + 1] + b.y, 0.f));
    }
  }
}

// The last layer's epilogue (EPI_SIGMOID's arithmetic): sigmoid(acc + b)
// of its first CF16_COLORS columns.
__device__ __forceinline__ void cf16_sigmoid_epilogue(const float (&acc)[32], const CF16FwdArgs& p,
                                                      int l, int t, int grow0) {
  const float* bias = p.bias[l];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= CF16_COLORS) continue;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow >= p.M) continue;
      float* out = p.color + (size_t)grow * p.ldcolor + col;
      out[0] = 1.f / (1.f + expf(-(acc[4 * j + 2 * h] + b.x)));
      if (col + 1 < CF16_COLORS) out[1] = 1.f / (1.f + expf(-(acc[4 * j + 2 * h + 1] + b.y)));
    }
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    color_fwd_kernel(const __grid_constant__ CF16FwdArgs p) {
  extern __shared__ __align__(128) unsigned char cf16f_smem[];
  cf16_ring_kernel(
      p.q, cf16f_smem, [](unsigned char*, int, int) {},
      [&](const CF16Phase& ph, uint32_t act, unsigned char* act_ptr, uint32_t ring, uint32_t full,
          uint32_t empty, int c, int ra, int t, int tile, int grow0, int& it) {
        if (ph.kind == CF16_SIGMOID) {
          float acc[32];
          cf16_mma(acc, ph, act, ring, full, empty, c, it);
          cf16_sigmoid_epilogue(acc, p, ph.layer, t, grow0);
          return;
        }
        float acc[128];
        cf16_mma(acc, ph, act, ring, full, empty, c, it);
        const bool keep = p.acts[0] != nullptr;
        if (keep) cf16_rows_read(c);  // the last layer's rows are stored
        cf16_relu_epilogue(acc, p, ph.layer, act_ptr, ra, t);
        cf16_sync(c);  // the next layer's products (and the stores) read the consumer's rows
        if (keep) cf16_store_rows(&p.act_map[ph.layer], act, p.H, c, tile);
      });
}

// ---------------------------------------------------------------------------
// color_bwd_kernel
// ---------------------------------------------------------------------------

struct CF16BwdArgs {
  CF16Ring q;                                   // w: W_l^T (out_cols[l], in_cols[l])
  const float* s;                               // the forward's sigmoid (3 columns), rows lds apart
  int lds;
  const float* dcolor;                          // (M, 3), rows lddc apart
  int lddc;
  const __nv_bfloat16* acts[CF16_MAX_LAYERS];   // bf16(relu) of layer l (l < n - 1): the mask
                                                // of layer l + 1
  int ldact;
  float* dzf[CF16_MAX_LAYERS];                  // with dW: dz_l in f32, rows lddz apart, or null
  __nv_bfloat16* dzb[CF16_MAX_LAYERS];          // and in bf16, rows lddzb apart
  CUtensorMap dzb_map[CF16_MAX_LAYERS];         // dzb[l] (l < n - 1) in boxes of 64 x 64
  int lddz, lddzb;
  float* dx;                                    // (M, in_cols[0]) f32, rows lddx apart
  int lddx;
  int M, n_layers, H, top;                      // top: the last layer's columns (dz_{n-1}'s)
};

// A tile's dz_{n-1} = s (1 - s) dcolor (color_dz_kernel's arithmetic) on
// the last layer's `top` columns, zero past the colors and past M, into
// consumer c's rows of the tile and, with dW, dzf / dzb[n-1]: 8 columns a
// thread at a time.
__device__ __forceinline__ void cf16_seed(const CF16BwdArgs& p, unsigned char* act_ptr, int c,
                                          int tile) {
  const int tid = threadIdx.x & 127, groups = p.top / 8;
  float* dzf = p.dzf[p.n_layers - 1];
  __nv_bfloat16* dzb = p.dzb[p.n_layers - 1];
  if (dzf) cf16_rows_read(c);  // the last tile's dz rows are stored
  for (int i = tid; i < 64 * groups; i += 128) {
    const int row = 64 * c + i / groups, c8 = 8 * (i % groups), grow = tile * CF16_TILE + row;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = 0.f;
      if (grow < p.M && c8 + k < CF16_COLORS) {
        const float s = p.s[(size_t)grow * p.lds + c8 + k];
        v[k] = s * (1.f - s) * p.dcolor[(size_t)grow * p.lddc + c8 + k];
      }
    }
    uint4 pack;
    __nv_bfloat16* hv = reinterpret_cast<__nv_bfloat16*>(&pack);
#pragma unroll
    for (int k = 0; k < 8; ++k) hv[k] = __float2bfloat16_rn(v[k]);
    *reinterpret_cast<uint4*>(act_ptr + cf16_offset(row, c8)) = pack;
    if (dzf && grow < p.M) {
      float4* f = reinterpret_cast<float4*>(dzf + (size_t)grow * p.lddz + c8);
      f[0] = make_float4(v[0], v[1], v[2], v[3]);
      f[1] = make_float4(v[4], v[5], v[6], v[7]);
      *reinterpret_cast<uint4*>(dzb + (size_t)grow * p.lddzb + c8) = pack;
    }
  }
  cf16_sync(c);  // the first layer's products read the seed
}

// A layer's transpose epilogue (EPI_MASK's arithmetic): dz_{l-1} =
// acts[l-1] > 0 ? da : 0 in place into the consumer's rows of the tile
// and, with kDz, in f32 to dzf[l-1] (its bf16 rounding, dzb[l-1], is the
// tile's: cf16_store_rows).  The mask's bf16 pairs are read 8 column
// groups at a time, all loads of a group before its stores.
template <bool kDz>
__device__ __forceinline__ void cf16_mask_epilogue(const float (&acc)[128], const CF16BwdArgs& p,
                                                   int l, unsigned char* act_ptr, int ra, int t,
                                                   int grow0) {
  const __nv_bfloat16* am = p.acts[l - 1];
  float* dzf = p.dzf[l - 1];
  constexpr int G = 8;
#pragma unroll
  for (int j0 = 0; j0 < CF16_WIDTH / 8; j0 += G) {
    if (8 * j0 >= p.H) break;
    unsigned int mv[G][2];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grow = grow0 + 8 * h;
        mv[jj][h] = grow < p.M ? __ldg(reinterpret_cast<const unsigned int*>(
                                     am + (size_t)grow * p.ldact + 8 * (j0 + jj) + 2 * t))
                               : 0u;
      }
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int j = j0 + jj, col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 m2 = *reinterpret_cast<const __nv_bfloat162*>(&mv[jj][h]);
        const float v0 = __bfloat162float(m2.x) > 0.f ? acc[4 * j + 2 * h] : 0.f;
        const float v1 = __bfloat162float(m2.y) > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(act_ptr + cf16_offset(ra + 8 * h, col)) =
            __floats2bfloat162_rn(v0, v1);
        const int grow = grow0 + 8 * h;
        if (kDz && grow < p.M)
          *reinterpret_cast<float2*>(dzf + (size_t)grow * p.lddz + col) = make_float2(v0, v1);
      }
    }
  }
}

// A piece of dx = dz_0 W_0^T: its columns n0 .. n0 + 2R straight to dx
// (EPI_F32: no bias, nothing after the sum).
template <int R>
__device__ __forceinline__ void cf16_dx_epilogue(const float (&acc)[R], const CF16BwdArgs& p,
                                                 int n0, int t, int grow0) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow < p.M)
        *reinterpret_cast<float2*>(p.dx + (size_t)grow * p.lddx + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    color_bwd_kernel(const __grid_constant__ CF16BwdArgs p) {
  extern __shared__ __align__(128) unsigned char cf16b_smem[];
  cf16_ring_kernel(
      p.q, cf16b_smem,
      [&](unsigned char* act_ptr, int c, int tile) { cf16_seed(p, act_ptr, c, tile); },
      [&](const CF16Phase& ph, uint32_t act, unsigned char* act_ptr, uint32_t ring, uint32_t full,
          uint32_t empty, int c, int ra, int t, int tile, int grow0, int& it) {
        if (ph.kind == CF16_MASK) {
          float acc[128];
          cf16_mma(acc, ph, act, ring, full, empty, c, it);
          const bool dz = p.dzf[0] != nullptr;
          if (dz) {
            cf16_rows_read(c);  // the last layer's rows are stored
            cf16_mask_epilogue<true>(acc, p, ph.layer, act_ptr, ra, t, grow0);
          } else {
            cf16_mask_epilogue<false>(acc, p, ph.layer, act_ptr, ra, t, grow0);
          }
          cf16_sync(c);  // the next layer's products (and the stores) read the consumer's rows
          if (dz) cf16_store_rows(&p.dzb_map[ph.layer - 1], act, p.H, c, tile);
        } else if (ph.boxes == 4) {
          float acc[128];
          cf16_mma(acc, ph, act, ring, full, empty, c, it);
          cf16_dx_epilogue(acc, p, ph.n0, t, grow0);
        } else if (ph.boxes == 2) {
          float acc[64];
          cf16_mma(acc, ph, act, ring, full, empty, c, it);
          cf16_dx_epilogue(acc, p, ph.n0, t, grow0);
        } else {
          float acc[32];
          cf16_mma(acc, ph, act, ring, full, empty, c, it);
          cf16_dx_epilogue(acc, p, ph.n0, t, grow0);
        }
      });
}

// Launch one of the two kernels: the grid, one block an SM; the dynamic
// shared-memory cap raised once a process.
template <class Args>
static cudaError_t cf16_launch(void (*kernel)(Args), const Args& p, cudaStream_t stream,
                               bool& smem_set) {
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CF16_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int grid = p.q.tiles < wg::sm_count() ? p.q.tiles : wg::sm_count();
  kernel<<<grid, wg::THREADS, CF16_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// A hidden width the tile holds: a multiple of 64 up to 256.
static bool cf16_hidden_ok(int h) { return h > 0 && h % 64 == 0 && h <= CF16_WIDTH; }

}  // namespace honerf

// The bf16 color net's forward on M points: its input [e | cx2] (bf16; e's
// first Ep columns, rows lde apart, then cx2's first X, rows ldx apart);
// layer l's weights ws[l] (rows[l], cols[l]) bf16 row-major (the pack's
// cws: rows[0] = Ep + X, the hidden layers H x H, the last H x 64) and f32
// biases bs[l].  Outputs: color[grow * ldcolor + c] = sigmoid of the last
// layer's column c < 3 (ldcolor 8: packed[:, 4:7]) and, with acts
// (optional), acts[l] = bf16(relu) of layer l (l < n - 1, rows ldact
// apart).  Refused (cudaErrorInvalidValue): shapes the tiles do not hold (H
// not a multiple of 64 up to 256, a last layer not 64 wide, Ep or X not a
// multiple of 64, rows that do not chain), operands TMA or the vector
// stores cannot take.
extern "C" int honerf_color_fwd(const __nv_bfloat16* e, int lde, int Ep,
                                const __nv_bfloat16* cx2, int ldx, int X, int M, int n_layers,
                                const void* const* ws, const int* rows, const int* cols,
                                const void* const* bs, float* color, int ldcolor,
                                void* const* acts, int ldact, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (n_layers < 2 || n_layers > CF16_MAX_LAYERS || Ep <= 0 || Ep % 64 || X <= 0 || X % 64 ||
      M < 0 || lde % 8 || ldx % 8 || cf16_misaligned16(e) || cf16_misaligned16(cx2) || !color ||
      ldcolor < CF16_COLORS || (acts && ldact % 8) || !cf16_hidden_ok(cols[0]))
    return (int)cudaErrorInvalidValue;
  CF16FwdArgs p{};
  const int H = cols[0];
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l + 1 == n_layers;
    if (rows[l] != (l == 0 ? Ep + X : H) || cols[l] != (last ? 64 : H) ||
        cf16_misaligned16(bs[l]) || (acts && !last && (!acts[l] || cf16_misaligned16(acts[l]))) ||
        !wg::tma_map(&p.q.w[l], ws[l], cols[l], rows[l], cols[l], wg::MN_CHUNK, wg::BK))
      return (int)cudaErrorInvalidValue;
    p.bias[l] = static_cast<const float*>(bs[l]);
    p.acts[l] = acts && !last ? static_cast<__nv_bfloat16*>(acts[l]) : nullptr;
    // layer 0 over e's boxes, then cx2's; the others over the tile
    p.q.ph[l] = CF16Phase{l == 0 ? 0 : H / 64, l == 0 ? Ep / 64 : 0, l == 0 ? X / 64 : 0, l, 0,
                          cols[l] / 64, last ? CF16_SIGMOID : CF16_RELU};
  }
  if (M == 0) return (int)cudaGetLastError();
  if (!wg::tma_map(&p.q.box[0], e, Ep, M, lde, wg::BK, CF16_TILE) ||
      !wg::tma_map(&p.q.box[1], cx2, X, M, ldx, wg::BK, CF16_TILE))
    return (int)cudaErrorInvalidValue;
  // with keep, the relu rows' boxes of 64 columns x 64 rows (cf16_store_rows)
  for (int l = 0; l + 1 < n_layers; ++l)
    if (p.acts[l] && !wg::tma_map(&p.act_map[l], acts[l], H, M, ldact, 64, 64))
      return (int)cudaErrorInvalidValue;
  p.q.n_phases = p.q.n_maps = n_layers;
  p.q.n_boxes = 2;
  p.q.tiles = (M + CF16_TILE - 1) / CF16_TILE;
  p.ldact = ldact;
  p.H = H;
  p.color = color;
  p.ldcolor = ldcolor;
  p.M = M;
  static bool smem_set = false;
  return (int)cf16_launch(color_fwd_kernel, p, stream, smem_set);
}

// The bf16 color net's transpose on the same M points: wts[l] = W_l^T
// (out_cols[l] rows of in_cols[l] bf16: the pack's cwts); s the forward's
// sigmoid (3 columns, rows lds apart: packed[:, 4:7]), dcolor (M, 3) rows
// lddc apart, the forward's kept relu rows acts[l] (bf16, l < n - 1, rows
// ldact apart).  Outputs: dx (M, in_cols[0]) f32 rows lddx apart and, with
// dzf and dzb (optional, both or neither), dz_l (out_cols[l] columns) in
// f32 into dzf[l] (rows lddz apart) and in bf16 into dzb[l] (rows lddzb
// apart) for every layer.  Refused: as honerf_color_fwd.
extern "C" int honerf_color_bwd(int M, int n_layers, const void* const* wts, const int* in_cols,
                                const int* out_cols, const float* s, int lds, const float* dcolor,
                                int lddc, const void* const* acts, int ldact, float* dx, int lddx,
                                void* const* dzf, void* const* dzb, int lddz, int lddzb,
                                cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (n_layers < 2 || n_layers > CF16_MAX_LAYERS || M < 0 || !s || !dcolor || !acts || !dx ||
      cf16_misaligned16(dx) || lddx % 4 || ldact % 8 || !dzf != !dzb ||
      (dzf && (lddz % 4 || lddzb % 8)) || in_cols[0] <= 0 || in_cols[0] % 64 ||
      !cf16_hidden_ok(out_cols[0]))
    return (int)cudaErrorInvalidValue;
  CF16BwdArgs p{};
  const int H = out_cols[0];
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l + 1 == n_layers;
    if (out_cols[l] != (last ? 64 : H) || (l > 0 && in_cols[l] != H) ||
        (!last && (!acts[l] || cf16_misaligned16(acts[l]))) ||
        (dzf && (!dzf[l] || !dzb[l] || cf16_misaligned16(dzf[l]) || cf16_misaligned16(dzb[l]))) ||
        !wg::tma_map(&p.q.w[l], wts[l], in_cols[l], out_cols[l], in_cols[l], wg::MN_CHUNK,
                     wg::BK))
      return (int)cudaErrorInvalidValue;
    p.acts[l] = last ? nullptr : static_cast<const __nv_bfloat16*>(acts[l]);
    p.dzf[l] = dzf ? static_cast<float*>(dzf[l]) : nullptr;
    p.dzb[l] = dzb ? static_cast<__nv_bfloat16*>(dzb[l]) : nullptr;
  }
  // layers n-1 .. 1 over the tile (the top over the seed's 64 columns),
  // then dx's pieces of 256, 128 or 64 columns
  int n_ph = 0;
  for (int l = n_layers - 1; l > 0; --l)
    p.q.ph[n_ph++] = CF16Phase{out_cols[l] / 64, 0, 0, l, 0, H / 64, CF16_MASK};
  for (int n0 = 0; n0 < in_cols[0];) {
    const int rem = in_cols[0] - n0;
    const int width = rem >= CF16_PIECE ? CF16_PIECE : (rem >= 128 ? 128 : 64);
    if (n_ph >= CF16_MAX_PHASES) return (int)cudaErrorInvalidValue;
    p.q.ph[n_ph++] = CF16Phase{H / 64, 0, 0, 0, n0, width / 64, CF16_DX};
    n0 += width;
  }
  if (M == 0) return (int)cudaGetLastError();
  // with dW, the bf16 dz rows' boxes below the top (cf16_store_rows)
  for (int l = 0; dzb && l + 1 < n_layers; ++l)
    if (!wg::tma_map(&p.dzb_map[l], dzb[l], H, M, lddzb, 64, 64)) return (int)cudaErrorInvalidValue;
  p.q.n_phases = n_ph;
  p.q.n_maps = n_layers;
  p.q.n_boxes = 0;
  p.q.tiles = (M + CF16_TILE - 1) / CF16_TILE;
  p.s = s;
  p.lds = lds;
  p.dcolor = dcolor;
  p.lddc = lddc;
  p.ldact = ldact;
  p.lddz = lddz;
  p.lddzb = lddzb;
  p.dx = dx;
  p.lddx = lddx;
  p.M = M;
  p.n_layers = n_layers;
  p.H = H;
  p.top = out_cols[n_layers - 1];
  static bool smem_set = false;
  return (int)cf16_launch(color_bwd_kernel, p, stream, smem_set);
}
