// The bf16 hand trunk's backward in two launches: the u-chain transposed,
// upward (hand_trunk_ut_kernel), then the forward transposed, downward
// (hand_trunk_dz_kernel) (ops/fused_fine.py: trunk_ut, trunk_dz on a bf16
// trunk; cuda_trunk_backward calls them for K3 and K6).
//
// Replaces: the bf16 mode of `_trunk_bwd_block`'s two chains
//   (honerf_tpu/ops/fused_fine.py:342; the upward loop :363-381, the
//   downward one :382-401) inside K6's pallas_call (:488) and K3's
//   (honerf_tpu/ops/fused_fine_full.py:1650) with FineMeta(dtype='bf16').
//   The split launches they replace (one gemm_kernel a layer with the
//   EPI_UT or EPI_DZ epilogue, common.cuh) stay callable for comparison
//   only (fused_fine.cuda_trunk_backward_split).  The weight gradients
//   (gemm_tn_kernel, reduce_partials_kernel, colsum_partial_kernel) run
//   after the chains, in the split launches' order, on the rows these
//   kernels keep.
//
// What bounds them on an H100: bytes.  The products are K5's trunk and
//   u-chain run backward, ~4.9 MFLOP a point (~5 ms per million points at
//   989 TFLOP/s); their rows: du read twice (du_b, du_s: 2.8 KB each), the
//   sigmoid rows read twice (8 KB each), the c rows (7 KB), ds written and
//   read (8 KB each), the top cotangent (0.6 KB) and de (5.6 KB); with dW
//   the kept dm rows (bf16, 4 KB) and dz rows (f32 and bf16, 12 KB): ~67
//   KB a point with dW, ~20 ms per million points at 3.35 TB/s.  The
//   weights (~7 MB in both layouts) stay in L2.
//
// Design (csrc/trunk_fused.cu's and csrc/color_fused.cu's, whose tile and
//   ring these repeat): one persistent block an SM walks tiles of
//   TB16_TILE = 128 points.  Warpgroup 0 is the producer: one thread
//   streams each phase's K steps of 64 by TMA into a ring of TB16_STAGES
//   stages (64 k-rows of the layer's weights, up to 256 columns, 32 KB;
//   upward also an A box of 64 columns x 128 rows, 16 KB) with wgmma.cuh's
//   128-byte swizzle; then, for a chain layer, its epilogue steps: the f32
//   rows its epilogue reads (the sigmoid rows and the c or ds rows), 32
//   columns x 128 rows of each a stage (TB16_ROWS_BYTES each; 3D maps, a
//   layer's rows one plane).  Warpgroups 1 and 2 each own 64 of the
//   tile's points and run wgmma m64n256k16 (m64n128k16 / m64n64k16 for a
//   narrower piece) with the f32 sums in registers; the epilogues read
//   their rows from the stages, which TMA fills while the products run (a
//   thread's own loads of them, in lockstep with the products, were most of
//   each kernel's time as first built; an L2 prefetch of them moved
//   nothing).
//
//  * The upward chain has the forward's shape: dt_l = dm_l W_l, B = W_l
//    (the pack's ws, the forward's operand).  Layer 0 reads du_b's Ep / 64
//    boxes (map 0); the middle layers the dm tile; the skip the tile, then
//    du_s's boxes (map 1), B's k-row running on.  Each epilogue is EPI_UT's:
//    ds_l = dt_l c_{l+1} to ds[l] (f32; c_{n-1} the one row c_last), the
//    next dm_{l+1} = bf16((dt_l s_l) hscale) in place into the consumer's
//    rows of the tile and, with keep, those rows stored to dm[l + 1] by
//    TMA while the next layer's products run (tb16_store_rows).  Shared
//    memory: the 64 KB tile and three 48 KB stages, 209 KB.
//  * The downward chain has the u-chain's shape (csrc/trunk_fused.cu's
//    hand_uchain_kernel: two tiles, dz_skip kept to layer 0): din = dz_l
//    W_l^T, B = W_l^T (the pack's wts).  A tile's prologue copies the top
//    cotangent's Op columns into the two tiles (80 KB at Op 320), which the
//    top layer reads; each later layer reads a tile.  Each chain epilogue
//    is EPI_DZ's, dz_{l-1} = (din hscale) s_{l-1} + ds_{l-1} ((beta s) (1 -
//    s)), rounded to bf16 in place into a tile (dz_skip into the second,
//    where it stays) and, with keep, in f32 to dzf[l - 1] and the tile's
//    rows to dzb[l - 1] by TMA.  After layer 1, de in pieces of DZ16_PIECE
//    columns, each two sums: the skip's part (dz_skip times wts[skip]'s
//    columns from Hp + n0) and layer 0's (dz_0 times wts[0]'s from n0), de
//    = f32(skip part * escale) + layer 0's part, written once (EPI_DZ's
//    u_acc order).  Shared memory: two 64 KB tiles and three 32 KB stages,
//    225 KB.
//
//   Every sum runs in the split launches' order: gemm_kernel's wgmma over
//   64-deep K steps in the same order (the skip's tile range, then du_s's;
//   K steps of four k16 products), one accumulator from zero, and
//   epilogue8's arithmetic.  So every output is expected to keep the split
//   launches' bits.
//
//   The two consumers share the weight stream in lockstep (trunk_fused.cu
//   says why no turns); ops/wgmma_layout.py: tb16_ut_phases /
//   tb16_dz_phases / tb16_loads / tb16_epi_loads model the tables,
//   ring_schedule the barriers (tests/test_torch_trunk_bwd_bf16_layout.py).

#include "common.cuh"

namespace honerf {

constexpr int TB16_TILE = 128;
constexpr int TB16_WIDTH = 256;                                  // the widest layer: m64n256k16
constexpr int TB16_CHUNK_BYTES = TB16_TILE * 128;                // 64 columns of the tile
constexpr int TB16_ACT_BYTES = TB16_WIDTH / 64 * TB16_CHUNK_BYTES;
constexpr int TB16_A_BYTES = TB16_CHUNK_BYTES;                   // a box: 64 columns x 128 rows
constexpr int TB16_B_BYTES = 64 * TB16_WIDTH * 2;                // 64 k-rows of 256 columns
constexpr int TB16_STAGE_BYTES = TB16_A_BYTES + TB16_B_BYTES;    // upward: an A box and B
constexpr int TB16_STAGES = 3;
constexpr int TB16_RING_BYTES = TB16_STAGES * TB16_STAGE_BYTES;
constexpr int TB16_SMEM_BYTES = 1024 + TB16_ACT_BYTES + TB16_RING_BYTES + 2 * TB16_STAGES * 8;
constexpr int DZ16_STAGE_BYTES = TB16_B_BYTES;                   // downward: B alone
constexpr int DZ16_RING_BYTES = TB16_STAGES * DZ16_STAGE_BYTES;
constexpr int DZ16_SMEM_BYTES = 1024 + 2 * TB16_ACT_BYTES + DZ16_RING_BYTES + 2 * TB16_STAGES * 8;
constexpr int TB16_MAX_LAYERS = 10;
constexpr int TB16_MAX_PHASES = 24;
constexpr int DZ16_PIECE = 128;                                  // de columns a piece: two sums
constexpr int TB16_EPI_COLS = 32;                                // f32 columns an epilogue step
constexpr int TB16_ROWS_BYTES = TB16_TILE * TB16_EPI_COLS * 4;   // one f32 row box of a step

enum TB16Kind { TB16_UT = 0, TB16_CHAIN = 1, TB16_DE = 2 };

struct TB16Phase {
  int act_steps;   // K steps over a tile (src)
  int box_steps0;  // then over box map 0's boxes (du_b)
  int box_steps1;  // then over map 1's (du_s)
  int layer;       // weight map (a piece of de: the skip's; the second B is wts[0]'s)
  int n0;          // B's first column (a piece: in wts[skip], from Hp)
  int n1;          // a piece: the second B's first column (in wts[0])
  int boxes;       // B boxes of 64 columns a K step (each B of a piece): 4, 2 or 1
  int kind;        // TB16Kind
  int src, dst;    // the tile a phase reads (A) and the tile its epilogue writes
  int s_plane;     // the epilogue steps' sigmoid plane (rows map 0), or -1: no epilogue steps
  int x_plane;     // their c or ds plane (rows map 1), or -1: none (c_last, read directly)
};

struct TB16Ring {
  CUtensorMap box[2];                  // A boxes of 64 columns x 128 rows
  CUtensorMap w[TB16_MAX_LAYERS];      // B: (K, N) row-major, boxes of 64 x 64
  CUtensorMap rows[2];                 // the epilogue's f32 rows: 32 columns x 128 rows x 1 plane
  TB16Phase ph[TB16_MAX_PHASES];
  int n_phases, n_maps, n_boxes, tiles, epi_steps;
};

static bool tb16_misaligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
}

// Byte offset of element (row, col) of the tiles: chunks of 64 columns,
// each 128 rows of 128 bytes with the 128-byte swizzle (trunk_fused.cu's
// tf_offset; chunk 4 on is the second tile's).
__device__ __forceinline__ uint32_t tb16_offset(int row, int col) {
  const int b = 2 * (col & 63);
  return (uint32_t)((col >> 6) * TB16_CHUNK_BYTES + row * 128 +
                    ((((b >> 4) ^ (row & 7))) << 4) + (b & 15));
}

// Columns cc, cc + 1 (cc even, < 32) of row `row` of an f32 row box (TMA's
// 128-byte-swizzled box of 32 columns x 128 rows).
__device__ __forceinline__ float2 tb16_box_read(const unsigned char* box, int row, int cc) {
  const int b = 4 * cc;
  return *reinterpret_cast<const float2*>(box + row * 128 + ((((b >> 4) ^ (row & 7))) << 4) +
                                          (b & 15));
}

__device__ __forceinline__ void tb16_sync(int c) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// One 3D TMA box (c0 the inner coordinate, c1 the row, c2 the plane) into
// shared memory at dst, completing on bar.
__device__ __forceinline__ void tb16_load3(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                           int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The producer thread: every tile's phases' K steps into the ring (stages
// of kStage bytes, B from kBOff: after the A box upward, at 0 downward; B's
// k-row 64 k, running on across a phase's ranges; a piece of de both of
// its Bs), then a chain phase's epilogue steps (its f32 rows,
// TB16_EPI_COLS columns a step).
template <int kStage, int kBOff>
__device__ __forceinline__ void tb16_produce(const TB16Ring& q, uint32_t ring, uint32_t full,
                                             uint32_t empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    for (int i = 0; i < q.n_phases; ++i) {
      const TB16Phase& ph = q.ph[i];
      const int steps = ph.act_steps + ph.box_steps0 + ph.box_steps1;
      const bool two = ph.kind == TB16_DE;
      for (int k = 0; k < steps; ++k, ++it) {
        const int stage = it % TB16_STAGES;
        wg::mbar_wait(empty + 8 * stage, ((it / TB16_STAGES) & 1) ^ 1);
        const uint32_t sb = ring + stage * kStage, bar = full + 8 * stage;
        const int kb = k - ph.act_steps;
        wg::mbar_expect_tx(bar, (two ? 2 : 1) * ph.boxes * wg::B_CHUNK_BYTES +
                                    (kb >= 0 ? TB16_A_BYTES : 0));
        if (kb >= 0) {
          const int box = kb >= ph.box_steps0;
          wg::tma_load(&q.box[box], sb, bar, 64 * (box ? kb - ph.box_steps0 : kb),
                       tile * TB16_TILE);
        }
        for (int j = 0; j < ph.boxes; ++j) {
          wg::tma_load(&q.w[ph.layer], sb + kBOff + j * wg::B_CHUNK_BYTES, bar,
                       ph.n0 + j * wg::MN_CHUNK, 64 * k);
          if (two)
            wg::tma_load(&q.w[0], sb + kBOff + (ph.boxes + j) * wg::B_CHUNK_BYTES, bar,
                         ph.n1 + j * wg::MN_CHUNK, 64 * k);
        }
      }
      if (ph.s_plane < 0) continue;
      for (int e = 0; e < q.epi_steps; ++e, ++it) {
        const int stage = it % TB16_STAGES;
        wg::mbar_wait(empty + 8 * stage, ((it / TB16_STAGES) & 1) ^ 1);
        const uint32_t sb = ring + stage * kStage, bar = full + 8 * stage;
        wg::mbar_expect_tx(bar, (ph.x_plane >= 0 ? 2 : 1) * TB16_ROWS_BYTES);
        tb16_load3(&q.rows[0], sb, bar, TB16_EPI_COLS * e, tile * TB16_TILE, ph.s_plane);
        if (ph.x_plane >= 0)
          tb16_load3(&q.rows[1], sb + TB16_ROWS_BYTES, bar, TB16_EPI_COLS * e, tile * TB16_TILE,
                     ph.x_plane);
      }
    }
  }
}

// A K step's four k16 products into acc (R 128: m64n256k16, 64: m64n128k16,
// 32: m64n64k16) from A at a (K-major) and B at b (MN-major).
template <int R>
__device__ __forceinline__ void tb16_k_step(float (&acc)[R], uint32_t a, uint32_t b) {
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
}

// One phase's products for consumer c into fresh accumulators: its K steps
// over tile src (at act + src * TB16_ACT_BYTES), then over the stages' A
// boxes; a piece of de also the second sum acc2 over tile 0 and its second
// B.  Each stage freed once the next step's products are issued and the
// previous ones retired (trunk_fused.cu's tf_mma).
template <int R, int kStage, int kBOff, bool kTwo>
__device__ __forceinline__ void tb16_mma(float (&acc)[R], float (&acc2)[R], const TB16Phase& ph,
                                         uint32_t act, uint32_t ring, uint32_t full,
                                         uint32_t empty, int c, int& it) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  if constexpr (kTwo) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc2[i] = 0.f;
  }
  int prev = -1;
  const int steps = ph.act_steps + ph.box_steps0 + ph.box_steps1;
  const uint32_t src = act + ph.src * TB16_ACT_BYTES + c * (TB16_CHUNK_BYTES / 2);
  for (int k = 0; k < steps; ++k, ++it) {
    const int stage = it % TB16_STAGES;
    wg::mbar_wait(full + 8 * stage, (it / TB16_STAGES) & 1);
    const uint32_t sb = ring + stage * kStage;
    const uint32_t a = k < ph.act_steps ? src + k * TB16_CHUNK_BYTES : sb + c * (TB16_A_BYTES / 2);
    wg::fence_acc(acc);
    if constexpr (kTwo) wg::fence_acc(acc2);
    wg::wgmma_fence();
    tb16_k_step<R>(acc, a, sb + kBOff);
    if constexpr (kTwo)  // layer 0's part: dz_0 in tile 0
      tb16_k_step<R>(acc2, act + c * (TB16_CHUNK_BYTES / 2) + k * TB16_CHUNK_BYTES,
                     sb + kBOff + ph.boxes * wg::B_CHUNK_BYTES);
    wg::wgmma_commit();
    wg::fence_acc(acc);
    if constexpr (kTwo) wg::fence_acc(acc2);
    wg::wgmma_wait<1>();  // the previous step's products are done: free its stage
    wg::fence_acc(acc);
    if constexpr (kTwo) wg::fence_acc(acc2);
    if (prev >= 0 && lane == 0) wg::mbar_arrive(empty + 8 * prev);
    prev = stage;
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(acc);
  if constexpr (kTwo) wg::fence_acc(acc2);
  if (lane == 0) wg::mbar_arrive(empty + 8 * prev);
}

// Epilogue step e of a chain phase: the rows of the consumer thread (ra,
// ra + 8) at the step's four column groups (columns 32 e + 8 jj + 2 t)
// from the stage's row boxes (sv: the sigmoid rows; xv: the c or ds rows,
// or with kXRow the one row xrow every point shares).  The caller frees the
// stage (tb16_epi_done) once it has used every value read.
template <bool kXRow, int kStage>
__device__ __forceinline__ void tb16_epi_rows(float2 (&sv)[4][2], float2 (&xv)[4][2],
                                              const float* xrow, const unsigned char* ring_ptr,
                                              uint32_t full, int e, int ra, int t, int it) {
  const int stage = it % TB16_STAGES;
  wg::mbar_wait(full + 8 * stage, (it / TB16_STAGES) & 1);
  const unsigned char* sbox = ring_ptr + stage * kStage;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sv[jj][h] = tb16_box_read(sbox, ra + 8 * h, 8 * jj + 2 * t);
      xv[jj][h] = kXRow ? __ldg(reinterpret_cast<const float2*>(
                              xrow + TB16_EPI_COLS * e + 8 * jj + 2 * t))
                        : tb16_box_read(sbox + TB16_ROWS_BYTES, ra + 8 * h, 8 * jj + 2 * t);
    }
  }
}

// An epilogue step's stage freed, after every thread of the warp has used
// the values it read from it (the producer's next TMA writes over them):
// each thread's reads ordered before the async proxy's writes, then one
// arrival a warp.
__device__ __forceinline__ void tb16_epi_done(uint32_t empty, int& it) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(empty + 8 * (it % TB16_STAGES));
  ++it;
}

// The shell of both kernels: kTiles tiles of TB16_ACT_BYTES, then the ring
// of kStage-byte stages; barriers, the producer, and the consumers' walk
// over the tiles (seed: a tile's prologue; phase: one phase's products and
// epilogue).  acc[4j + q] holds tile row ra + 8 (q >> 1), column 8j + 2t +
// (q & 1); grow0 is row ra's point, in tile `tile`.
template <int kTiles, int kStage, int kBOff, class Seed, class Phase>
__device__ __forceinline__ void tb16_ring_kernel(const TB16Ring& q, unsigned char* smem,
                                                 const Seed& seed, const Phase& phase) {
  const uint32_t raw = wg::smem_u32(smem);
  const uint32_t act = (raw + 1023) & ~1023u;
  unsigned char* act_ptr = smem + (act - raw);
  const uint32_t ring = act + kTiles * TB16_ACT_BYTES;
  const uint32_t full = ring + TB16_STAGES * kStage, empty = full + 8 * TB16_STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TB16_STAGES; ++s) {
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
      for (int i = 0; i < 2; ++i) wg::prefetch_map(&q.rows[i]);
      tb16_produce<kStage, kBOff>(q, ring, full, empty);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  const int c = warpgroup - 1;  // rows 64c..64c+63 of each tile
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ra = 64 * c + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  unsigned char* ring_ptr = act_ptr + kTiles * TB16_ACT_BYTES;
  int it = 0;
  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    const int grow0 = tile * TB16_TILE + ra;
    seed(act_ptr, c, tile);
    for (int i = 0; i < q.n_phases; ++i)
      phase(q.ph[i], act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile, grow0, it);
  }
  // the kept rows' bulk stores (tb16_store_rows) complete before the block ends
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Consumer c's 64 rows of the first `width` columns of the tile at `tile_u`
// (bf16, as the epilogue left them) to plane `plane` of `map` (the kept dm
// or dz rows) at tile `tile`: one TMA box of 64 columns x 64 rows a
// 64-column chunk, issued by the consumer's first thread once the
// epilogue's barrier has passed; rows past the map's M are not written
// (color_fused.cu's cf16_store_rows, in 3D).
__device__ __forceinline__ void tb16_store_rows(const CUtensorMap* map, uint32_t tile_u,
                                                int width, int c, int tile, int plane) {
  if ((threadIdx.x & 127) != 0) return;
  for (int k = 0; k < width / 64; ++k)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(tile_u + k * TB16_CHUNK_BYTES + c * (TB16_CHUNK_BYTES / 2)), "r"(64 * k),
        "r"(tile * TB16_TILE + 64 * c), "r"(plane)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Before a write over the consumer's rows of a tile: its stores issued so
// far have read them.
__device__ __forceinline__ void tb16_rows_read(int c) {
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  tb16_sync(c);
}

// ---------------------------------------------------------------------------
// hand_trunk_ut_kernel
// ---------------------------------------------------------------------------

struct UT16Args {
  TB16Ring q;            // boxes: du_b, du_s; w: W_l (in_cols[l], Hp); rows: the sigmoid and c
                         // rows (planes of ss and of cs[1 .. n-2])
  CUtensorMap dm_map;    // keep: dm[1 .. n-1] (planes 0 .. n-2) in boxes of 64 x 64
  const float* c_last;   // c_{n-1}: one row for every point
  float* ds;             // ds[l] = ds + l * ds_layer, rows ldds apart
  long long ds_layer;
  int ldds;
  int keep, M, n_layers, skip, Hp;
  float hscale;
};

// Layer l's epilogue (EPI_UT's arithmetic), a step of its rows at a time:
// ds_l = dt c_{l+1} to ds[l]; dm_{l+1} = bf16((dt s_l) hscale) in place
// into the consumer's rows of the tile.
template <int R, bool kLast>
__device__ __forceinline__ void ut16_epilogue(const float (&acc)[R], const UT16Args& p, int l,
                                              unsigned char* act_ptr, const unsigned char* ring_ptr,
                                              uint32_t full, uint32_t empty, int ra, int t,
                                              int grow0, int& it) {
  const float hscale = l + 1 == p.skip ? p.hscale : 1.f;
  float* ds = p.ds + l * p.ds_layer;
#pragma unroll
  for (int e = 0; e < R / 16; ++e) {
    float2 sv[4][2], cv[4][2];
    tb16_epi_rows<kLast, TB16_STAGE_BYTES>(sv, cv, p.c_last, ring_ptr, full, e, ra, t, it);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * e + jj, col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grow = grow0 + 8 * h;
        const float z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
        const float2 d = make_float2(z0 * cv[jj][h].x, z1 * cv[jj][h].y);
        *reinterpret_cast<__nv_bfloat162*>(act_ptr + tb16_offset(ra + 8 * h, col)) =
            __floats2bfloat162_rn((z0 * sv[jj][h].x) * hscale, (z1 * sv[jj][h].y) * hscale);
        if (grow < p.M) *reinterpret_cast<float2*>(ds + (size_t)grow * p.ldds + col) = d;
      }
    }
    tb16_epi_done(empty, it);
  }
}

template <int R>
__device__ __forceinline__ void ut16_layer(const UT16Args& p, const TB16Phase& ph, uint32_t act,
                                           unsigned char* act_ptr, uint32_t ring,
                                           const unsigned char* ring_ptr, uint32_t full,
                                           uint32_t empty, int c, int ra, int t, int tile,
                                           int grow0, int& it) {
  float acc[R];
  const int l = ph.layer;
  tb16_mma<R, TB16_STAGE_BYTES, TB16_A_BYTES, false>(acc, acc, ph, act, ring, full, empty, c, it);
  if (p.keep) tb16_rows_read(c);  // the last layer's rows are stored
  if (l + 2 == p.n_layers)
    ut16_epilogue<R, true>(acc, p, l, act_ptr, ring_ptr, full, empty, ra, t, grow0, it);
  else
    ut16_epilogue<R, false>(acc, p, l, act_ptr, ring_ptr, full, empty, ra, t, grow0, it);
  tb16_sync(c);  // the next layer's products (and the stores) read the consumer's rows
  if (p.keep) tb16_store_rows(&p.dm_map, act, p.Hp, c, tile, l);
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    hand_trunk_ut_kernel(const __grid_constant__ UT16Args p) {
  extern __shared__ __align__(128) unsigned char ut16_smem[];
  tb16_ring_kernel<1, TB16_STAGE_BYTES, TB16_A_BYTES>(
      p.q, ut16_smem, [](unsigned char*, int, int) {},
      [&](const TB16Phase& ph, uint32_t act, unsigned char* act_ptr, uint32_t ring,
          const unsigned char* ring_ptr, uint32_t full, uint32_t empty, int c, int ra, int t,
          int tile, int grow0, int& it) {
        if (ph.boxes == 4)
          ut16_layer<128>(p, ph, act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile,
                          grow0, it);
        else if (ph.boxes == 2)
          ut16_layer<64>(p, ph, act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile, grow0,
                         it);
        else
          ut16_layer<32>(p, ph, act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile, grow0,
                         it);
      });
}

// ---------------------------------------------------------------------------
// hand_trunk_dz_kernel
// ---------------------------------------------------------------------------

struct DZ16Args {
  TB16Ring q;            // w: W_l^T; rows: the sigmoid and ds rows
  CUtensorMap dzb_map;   // keep: dzb[0 .. n-2] (planes) in boxes of 64 x 64
  const __nv_bfloat16* top;  // the top cotangent (M, Op), rows ldtop apart
  int ldtop, Op;
  float* de;             // (M, Ep) f32, rows ldde apart
  int ldde;
  float* dzf;            // keep: dz_l in f32 at dzf + l * dzf_layer (l < n - 1), rows lddz apart
  long long dzf_layer;
  int lddz;
  int keep, M, skip, Hp;
  float hscale, escale;
};

// A tile's prologue: consumer c's 64 rows of the top cotangent's Op
// columns (bf16, zero past M) into the tiles (chunks 0-3 in the first, the
// rest in the second), 16 bytes a thread at a time.  A thread writes rows
// of the consumer's other warps, whose last products (the previous tile's
// last piece of de, over both tiles) may still be reading them: every
// warp's products and, with keep, the stores of the last tile's rows are
// done before the first write, with keep or without.
__device__ __forceinline__ void dz16_seed(const DZ16Args& p, unsigned char* act_ptr, int c,
                                          int tile) {
  tb16_rows_read(c);
  const int tid = threadIdx.x & 127, groups = p.Op / 8;
  for (int i = tid; i < 64 * groups; i += 128) {
    const int row = 64 * c + i / groups, c8 = 8 * (i % groups), grow = tile * TB16_TILE + row;
    const uint4 v = grow < p.M ? __ldg(reinterpret_cast<const uint4*>(
                                     p.top + (size_t)grow * p.ldtop + c8))
                               : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(act_ptr + tb16_offset(row, c8)) = v;
  }
  tb16_sync(c);  // the top layer's products read the seed
}

// EPI_DZ's dz = (din hscale) s + ds ((beta s) (1 - s)) as epilogue8's
// compiled code rounds it: one fma of the first product over the second
// (written out, since nvcc may contract the sum the other way here; the
// other order moves the f32 dz rows by an ulp).
__device__ __forceinline__ float tb16_dz(float din, float hscale, float s, float ds) {
  return __fmaf_rn(__fmul_rn(din, hscale), s,
                   __fmul_rn(ds, __fmul_rn(__fmul_rn(kBeta, s), __fsub_rn(1.f, s))));
}

// A chain layer's epilogue (EPI_DZ's arithmetic), a step of its rows at a
// time: dz_{l-1} = (din hscale) s_{l-1} + ds_{l-1} ((beta s) (1 - s)),
// rounded to bf16 in place into the consumer's rows of tile dst and, with
// kKeep, in f32 to dzf[l - 1].
template <int R, bool kKeep>
__device__ __forceinline__ void dz16_epilogue(const float (&acc)[R], const DZ16Args& p, int l,
                                              unsigned char* dst, const unsigned char* ring_ptr,
                                              uint32_t full, uint32_t empty, int ra, int t,
                                              int grow0, int& it) {
  const float hscale = l == p.skip ? p.hscale : 1.f;
  float* dz = p.dzf + (l - 1) * p.dzf_layer;
#pragma unroll
  for (int e = 0; e < R / 16; ++e) {
    float2 sv[4][2], dv[4][2];
    tb16_epi_rows<false, DZ16_STAGE_BYTES>(sv, dv, nullptr, ring_ptr, full, e, ra, t, it);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * e + jj, col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int grow = grow0 + 8 * h;
        const float2 s = sv[jj][h], d = dv[jj][h];
        const float v0 = tb16_dz(acc[4 * j + 2 * h], hscale, s.x, d.x);
        const float v1 = tb16_dz(acc[4 * j + 2 * h + 1], hscale, s.y, d.y);
        *reinterpret_cast<__nv_bfloat162*>(dst + tb16_offset(ra + 8 * h, col)) =
            __floats2bfloat162_rn(v0, v1);
        if (kKeep && grow < p.M)
          *reinterpret_cast<float2*>(dz + (size_t)grow * p.lddz + col) = make_float2(v0, v1);
      }
    }
    tb16_epi_done(empty, it);
  }
}

template <int R>
__device__ __forceinline__ void dz16_chain(const DZ16Args& p, const TB16Phase& ph, uint32_t act,
                                           unsigned char* act_ptr, uint32_t ring,
                                           const unsigned char* ring_ptr, uint32_t full,
                                           uint32_t empty, int c, int ra, int t, int tile,
                                           int grow0, int& it) {
  float acc[R];
  tb16_mma<R, DZ16_STAGE_BYTES, 0, false>(acc, acc, ph, act, ring, full, empty, c, it);
  unsigned char* dst = act_ptr + ph.dst * TB16_ACT_BYTES;
  if (p.keep) {
    tb16_rows_read(c);  // the last layer's rows are stored
    dz16_epilogue<R, true>(acc, p, ph.layer, dst, ring_ptr, full, empty, ra, t, grow0, it);
  } else {
    dz16_epilogue<R, false>(acc, p, ph.layer, dst, ring_ptr, full, empty, ra, t, grow0, it);
  }
  tb16_sync(c);  // the next layer's products (and the stores) read the consumer's rows
  if (p.keep)
    tb16_store_rows(&p.dzb_map, act + ph.dst * TB16_ACT_BYTES, p.Hp, c, tile, ph.layer - 1);
}

// A piece of de (EPI_DZ's U and u_acc): its columns n1 .. n1 + 2R of de =
// f32(the skip's part * escale) + layer 0's part, stored once.
template <int R>
__device__ __forceinline__ void dz16_piece(const DZ16Args& p, const TB16Phase& ph, uint32_t act,
                                           uint32_t ring, uint32_t full, uint32_t empty, int c,
                                           int t, int grow0, int& it) {
  float acc[R], acc2[R];
  tb16_mma<R, DZ16_STAGE_BYTES, 0, true>(acc, acc2, ph, act, ring, full, empty, c, it);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = ph.n1 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow < p.M)
        *reinterpret_cast<float2*>(p.de + (size_t)grow * p.ldde + col) = make_float2(
            __fadd_rn(__fmul_rn(acc[4 * j + 2 * h], p.escale), acc2[4 * j + 2 * h]),
            __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], p.escale), acc2[4 * j + 2 * h + 1]));
    }
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    hand_trunk_dz_kernel(const __grid_constant__ DZ16Args p) {
  extern __shared__ __align__(128) unsigned char dz16_smem[];
  tb16_ring_kernel<2, DZ16_STAGE_BYTES, 0>(
      p.q, dz16_smem,
      [&](unsigned char* act_ptr, int c, int tile) { dz16_seed(p, act_ptr, c, tile); },
      [&](const TB16Phase& ph, uint32_t act, unsigned char* act_ptr, uint32_t ring,
          const unsigned char* ring_ptr, uint32_t full, uint32_t empty, int c, int ra, int t,
          int tile, int grow0, int& it) {
        if (ph.kind == TB16_CHAIN) {
          if (ph.boxes == 4)
            dz16_chain<128>(p, ph, act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile,
                            grow0, it);
          else if (ph.boxes == 2)
            dz16_chain<64>(p, ph, act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile,
                           grow0, it);
          else
            dz16_chain<32>(p, ph, act, act_ptr, ring, ring_ptr, full, empty, c, ra, t, tile,
                           grow0, it);
        } else if (ph.boxes == 2) {
          dz16_piece<64>(p, ph, act, ring, full, empty, c, t, grow0, it);
        } else {
          dz16_piece<32>(p, ph, act, ring, full, empty, c, t, grow0, it);
        }
      });
}

// Launch one of the two kernels: the grid, one block an SM; the dynamic
// shared-memory cap raised once a process.
template <class Args>
static cudaError_t tb16_launch(void (*kernel)(Args), const Args& p, int smem,
                               cudaStream_t stream, bool& smem_set) {
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int grid = p.q.tiles < wg::sm_count() ? p.q.tiles : wg::sm_count();
  kernel<<<grid, wg::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Both chains' entry checks, common to the two entry points.
static bool tb16_shapes_ok(int M, int Ep, int Hp, int n_layers, int skip) {
  return n_layers >= 3 && n_layers <= TB16_MAX_LAYERS && skip > 0 && skip < n_layers - 1 &&
         (Hp == 64 || Hp == 128 || Hp == 256) && Ep > 0 && Ep % 64 == 0 && M >= 0;
}

// A 3D map of `planes` planes of M rows of `cols` elements (elem_bytes
// each; rows ld elements apart, planes `plane` elements apart), boxes of
// box_cols x box_rows x 1 plane with the 128-byte swizzle and zero fill
// past each extent.
static bool tb16_map3(CUtensorMap* out, const void* ptr, int cols, int M, long long ld,
                      int planes, long long plane, int box_cols, int box_rows, int elem_bytes) {
  if (!ptr || tb16_misaligned16(ptr) || cols <= 0 || M <= 0 || ld < cols ||
      (ld * elem_bytes) % 16 || planes <= 0 ||
      (planes > 1 && ((plane * elem_bytes) % 16 || plane < ld * M)))
    return false;
  wg::EncodeTiled enc = wg::encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)M, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)(ld * elem_bytes),
                                 (cuuint64_t)((planes > 1 ? plane : ld * M) * elem_bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(out,
             elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The epilogue's f32 row maps of a chain: planes of M rows of Hp columns,
// boxes of TB16_EPI_COLS columns x a tile's rows.
static bool tb16_rows_map(CUtensorMap* out, const float* ptr, int Hp, int M, long long ld,
                          int planes, long long plane) {
  return tb16_map3(out, ptr, Hp, M, ld, planes, plane, TB16_EPI_COLS, TB16_TILE, 4);
}

}  // namespace honerf

// The upward chain on M points: du_b = du and du_s = bf16(du / sqrt2)
// (bf16, (M, Ep), rows lddu apart); ws[l] = W_l (in_cols[l] rows of Hp
// bf16: the pack's ws) for l < n - 1; the forward's sigmoid rows ss (n - 1
// planes ss_layer floats apart, rows lds apart) and the u-chain's c rows
// c_l (1 <= l < n - 1: n - 2 planes from cs, cs_layer floats apart, rows
// ldc apart), c_last = c_{n-1} (Hp f32, every point's); hscale the skip's
// 1/sqrt2.  Outputs: ds[l] (l < n - 1, f32, planes ds_layer floats apart,
// rows ldds apart) and, with dm (optional), dm_l (1 <= l <= n - 1, bf16:
// n - 1 planes from dm, dm_layer elements apart, rows lddm apart).
// Refused (cudaErrorInvalidValue): shapes the tiles do not hold (Hp not
// 64, 128 or 256, Ep not a multiple of 64, rows that do not chain),
// operands TMA or the vector loads and stores cannot take.
extern "C" int honerf_trunk_ut(int M, int Ep, int Hp, int n_layers, int skip,
                               const void* const* ws, const int* in_cols,
                               const __nv_bfloat16* du_b, const __nv_bfloat16* du_s, int lddu,
                               const float* ss, long long ss_layer, int lds, const float* cs,
                               long long cs_layer, int ldc, const float* c_last, float* ds,
                               long long ds_layer, int ldds, void* dm, long long dm_layer,
                               int lddm, float hscale, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (!tb16_shapes_ok(M, Ep, Hp, n_layers, skip) || lddu % 8 || !ss || !cs || !ds || !c_last ||
      tb16_misaligned16(c_last) || tb16_misaligned16(ds) || ldds % 4 || ds_layer % 4 ||
      (dm && (lddm % 8 || dm_layer % 8)))
    return (int)cudaErrorInvalidValue;
  UT16Args p{};
  for (int l = 0; l + 1 < n_layers; ++l) {
    const int want = l == 0 ? Ep : (l == skip ? Hp + Ep : Hp);
    if (in_cols[l] != want ||
        !wg::tma_map(&p.q.w[l], ws[l], Hp, in_cols[l], Hp, wg::MN_CHUNK, wg::BK))
      return (int)cudaErrorInvalidValue;
    // layer 0 over du_b's boxes (map 0); the skip over the tile, then
    // du_s's (map 1); the epilogue steps over the sigmoid plane l and the
    // c plane of c_{l+1} (none for the last: c_last)
    p.q.ph[l] = TB16Phase{l == 0 ? 0 : Hp / 64, l == 0 ? Ep / 64 : 0, l == skip ? Ep / 64 : 0, l,
                          0, 0, Hp / 64, TB16_UT, 0, 0, l, l + 2 < n_layers ? l : -1};
  }
  if (M == 0) return (int)cudaGetLastError();
  if (!wg::tma_map(&p.q.box[0], du_b, Ep, M, lddu, wg::BK, TB16_TILE) ||
      !wg::tma_map(&p.q.box[1], du_s, Ep, M, lddu, wg::BK, TB16_TILE) ||
      !tb16_rows_map(&p.q.rows[0], ss, Hp, M, lds, n_layers - 1, ss_layer) ||
      !tb16_rows_map(&p.q.rows[1], cs, Hp, M, ldc, n_layers - 2, cs_layer) ||
      (dm && !tb16_map3(&p.dm_map, dm, Hp, M, lddm, n_layers - 1, dm_layer, 64, 64, 2)))
    return (int)cudaErrorInvalidValue;
  p.q.n_phases = p.q.n_maps = n_layers - 1;
  p.q.n_boxes = 2;
  p.q.tiles = (M + TB16_TILE - 1) / TB16_TILE;
  p.q.epi_steps = Hp / TB16_EPI_COLS;
  p.c_last = c_last;
  p.ds = ds;
  p.ds_layer = ds_layer;
  p.ldds = ldds;
  p.keep = dm != nullptr;
  p.M = M;
  p.n_layers = n_layers;
  p.skip = skip;
  p.Hp = Hp;
  p.hscale = hscale;
  static bool smem_set = false;
  return (int)tb16_launch(hand_trunk_ut_kernel, p, TB16_SMEM_BYTES, stream, smem_set);
}

// The downward chain on the same M points from the top cotangent top (bf16,
// (M, Op), rows ldtop apart; Op <= 2 tiles' 512 columns): wts[l] = W_l^T
// (out_cols[l] rows of in_cols[l] bf16: the pack's wts); the sigmoid rows
// ss and the upward chain's ds (n - 1 planes each, as honerf_trunk_ut
// takes them); hscale and escale the skip's two scales.  Outputs: de (M,
// Ep) f32 rows ldde apart and, with dzf and dzb (optional, both or
// neither), dz_l (l < n - 1) in f32 (n - 1 planes from dzf, dzf_layer
// floats apart, rows lddz apart) and in bf16 (planes from dzb, dzb_layer
// apart, rows lddzb apart).  Refused: as honerf_trunk_ut.
extern "C" int honerf_trunk_dz(int M, int Ep, int Hp, int Op, int n_layers, int skip,
                               const void* const* wts, const int* in_cols, const int* out_cols,
                               const __nv_bfloat16* top, int ldtop, const float* ss,
                               long long ss_layer, int lds, const float* ds, long long ds_layer,
                               int ldds, float* de, int ldde, float* dzf, long long dzf_layer,
                               int lddz, void* dzb, long long dzb_layer, int lddzb, float hscale,
                               float escale, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (!tb16_shapes_ok(M, Ep, Hp, n_layers, skip) || Op <= 0 || Op % 64 ||
      Op > 2 * TB16_WIDTH || !top || tb16_misaligned16(top) || !ss || !ds || !de ||
      tb16_misaligned16(de) || ldtop % 8 || ldde % 4 || !dzf != !dzb ||
      (dzf && (tb16_misaligned16(dzf) || lddz % 4 || dzf_layer % 4)))
    return (int)cudaErrorInvalidValue;
  DZ16Args p{};
  for (int l = 0; l < n_layers; ++l) {
    const int want_in = l == 0 ? Ep : (l == skip ? Hp + Ep : Hp);
    const int want_out = l + 1 == n_layers ? Op : Hp;
    if (in_cols[l] != want_in || out_cols[l] != want_out ||
        !wg::tma_map(&p.q.w[l], wts[l], in_cols[l], out_cols[l], in_cols[l], wg::MN_CHUNK,
                     wg::BK))
      return (int)cudaErrorInvalidValue;
  }
  // the top layer over the seed's Op / 64 chunks, then each chain layer l
  // over the tile holding dz_l (tile 1: dz_skip, kept to layer 0; tile 0
  // the rest), its epilogue reading the planes l - 1 of the sigmoid and ds
  // rows; then de's pieces, two sums each: the skip's part over tile 1
  // (wts[skip]'s columns from Hp + n0), layer 0's over tile 0 (wts[0]'s
  // from n0)
  const int kt = Hp / 64;
  int n_ph = 0;
  for (int l = n_layers - 1; l > 0; --l)
    p.q.ph[n_ph++] = TB16Phase{l + 1 == n_layers ? Op / 64 : kt, 0, 0, l, 0, 0, kt, TB16_CHAIN,
                               l == skip ? 1 : 0, l - 1 == skip ? 1 : 0, l - 1, l - 1};
  for (int n0 = 0; n0 < Ep;) {
    const int width = Ep - n0 >= DZ16_PIECE ? DZ16_PIECE : 64;
    if (n_ph >= TB16_MAX_PHASES) return (int)cudaErrorInvalidValue;
    p.q.ph[n_ph++] = TB16Phase{kt, 0, 0, skip, Hp + n0, n0, width / 64, TB16_DE, 1, 0, -1, -1};
    n0 += width;
  }
  if (M == 0) return (int)cudaGetLastError();
  if (!tb16_rows_map(&p.q.rows[0], ss, Hp, M, lds, n_layers - 1, ss_layer) ||
      !tb16_rows_map(&p.q.rows[1], ds, Hp, M, ldds, n_layers - 1, ds_layer) ||
      (dzb && !tb16_map3(&p.dzb_map, dzb, Hp, M, lddzb, n_layers - 1, dzb_layer, 64, 64, 2)))
    return (int)cudaErrorInvalidValue;
  p.q.n_phases = n_ph;
  p.q.n_maps = n_layers;
  p.q.n_boxes = 0;
  p.q.tiles = (M + TB16_TILE - 1) / TB16_TILE;
  p.q.epi_steps = Hp / TB16_EPI_COLS;
  p.top = top;
  p.ldtop = ldtop;
  p.Op = Op;
  p.de = de;
  p.ldde = ldde;
  p.dzf = dzf;
  p.dzf_layer = dzf_layer;
  p.lddz = lddz;
  p.keep = dzf != nullptr;
  p.M = M;
  p.skip = skip;
  p.Hp = Hp;
  p.hscale = hscale;
  p.escale = escale;
  static bool smem_set = false;
  return (int)tb16_launch(hand_trunk_dz_kernel, p, DZ16_SMEM_BYTES, stream, smem_set);
}
