// The weight gradients of an f32 trunk pass (and of K3's color net) in one
// launch: trunk_dw_f32_kernel (ops/fused_fine.py: trunk_dw; cuda_trunk_backward
// calls it for K3 and K6 after the backward's two chains).
//
// Replaces: the f32 mode of the dW / db statements of `_trunk_bwd_block`
//   (honerf_tpu/ops/fused_fine.py:342; dW_l = dm_l^T t_l + in_l^T dz_l at
//   :379-381 and :397-399, db_l = sum dz_l, summed over the grid at
//   :420-429) inside K6's pallas_call (:488) and K3's
//   (honerf_tpu/ops/fused_fine_full.py:1650) with dtype 'f32', and of
//   `_color_bwd_block` (honerf_tpu/ops/fused_fine_full.py:872, dcW_l =
//   a_l^T dz_l, dcb_l = sum dz_l at :902-904) inside K3's.  The launch
//   sequence it replaces (gemm_tn_f32_kernel + reduce_partials_kernel a
//   product, colsum_partial_kernel a layer; trunk.cuh) stays callable for
//   comparison only (fused_fine.cuda_trunk_dw_split).
//
// What bounds it on an H100: operations.  An f32 'full' pass sums, per
//   point, the trunk's products (1408 x 256 twice, 6 x 256 x 256 twice,
//   1664 x 256 twice, 256 x 320) and the color net's (1792 x 256, 3 x 256
//   x 256, 256 x 64): ~6.2 MFLOP a point of f32 work, which 3xTF32 runs at
//   165 of the card's 495 TF32 TFLOP/s (~2.1 ms an f32 step of 56,448
//   points).  Its bytes (each kept row read once, ~44 KB a point) take ~0.7
//   ms at 3.35 TB/s.
//
// Design: one persistent block an SM walks a work list made once per
//   (meta, M) on the host (ops/wgmma_layout.py: tdw32_plan).  An item is
//   128 rows of one layer's dW (two consumers x 64) by up to 128 of its
//   columns over a range of points, and sums both of the layer's products
//   into one accumulator: the reduction runs over the range twice, the
//   u-chain's product (dm_l^T t_l) first, then the forward's (in_l^T dz_l).
//   Layer n - 1's u-chain part is dm_{n-1}'s column sum into column 0 (its t
//   is the one-hot sdf column): the item loads dm_{n-1}'s boxes and adds
//   them, no product.
//  * Warpgroup 0's first thread streams each K step of 32 points by TMA
//    (3D maps: a layer's rows are one map's plane) into a 3-slot ring:
//    X's boxes (32 points x 32 columns; two a consumer) and Y's (the item's
//    columns).  The points are the product's K, and both operands lie
//    point-major.
//  * A = X^T comes from registers: each consumer reads its 64 columns of
//    X's boxes in the A fragments' order and splits them (tf32.cuh,
//    t32_split_a; the skip's forward rows times the f32 1/sqrt2 first).
//  * B = Y must be K-major for a TF32 wgmma (its transpose bits are for
//    16-bit types), so both consumers turn each Y box into [small; big]
//    rows, K-major with the 128-byte swizzle t32_mma reads, in a second
//    buffer while the step before runs its products (two buffers); db's
//    column sums are taken in the same pass, at no extra read.  Both
//    consumers share B: one split serves 128 dW rows.  (Measured and not
//    kept, PERF.md: the split handed to warpgroup 0's idle warps with B
//    buffers of their own barriers, 2.37 against 2.06 ms an f32 'full'
//    pass; A's loads as float2 in an order free of bank conflicts, 2.07.)
//  * The sums: 3xTF32 as the fused f32 kernels (big.small, small.big,
//    big.big into a fresh accumulator each 32-deep step, added to the
//    running sum with round to nearest).  An item's range is long (up to
//    ~7,000 points: ~220 steps), so every TDW32_FLUSH steps the running sum
//    joins a second-level sum in shared memory (64 KB: both consumers'
//    cells, the room a fourth ring slot would take) and starts anew; with
//    one running f32 sum the L2 distance to f64 measured ~1.35x the split
//    sequence's, whose splits are shorter.  db's column sums and the SUM's
//    row sums are compensated (Kahan).
//  * An item writes its partial (128 x 128 and the db row) to the scratch;
//    the last item of a tile to finish (an atomic ticket, which wraps to 0
//    for the next launch and orders no addition) sums the tile's partials
//    in split order and writes out = (acc ? out : 0) + that.  No float
//    atomics: two runs give the same bits.
//
// ops/wgmma_layout.py mirrors the constants (TDW32_*), the work list, the
// transposed split's layout and the sums' order
// (tests/test_torch_trunk_dw_f32_layout.py).

#include "tf32.cuh"

namespace honerf {

constexpr int TDW32_ROWS = 128;                                  // dW rows an item
constexpr int TDW32_NB = 128;                                    // dW columns an item, at most
constexpr int TDW32_BK = 32;                                     // points a K step
constexpr int TDW32_BOX_BYTES = TDW32_BK * 128;                  // 32 points x 32 f32 columns
constexpr int TDW32_X_BYTES = 4 * TDW32_BOX_BYTES;               // two consumers x 64 columns
constexpr int TDW32_Y_BYTES = TDW32_NB / 32 * TDW32_BOX_BYTES;   // the item's columns of Y
constexpr int TDW32_STAGE_BYTES = TDW32_X_BYTES + TDW32_Y_BYTES;
constexpr int TDW32_STAGES = 3;
constexpr int TDW32_RING_BYTES = TDW32_STAGES * TDW32_STAGE_BYTES;
constexpr int TDW32_B_BYTES = TDW32_NB * 128;                    // B's rows: a column x 32 k
constexpr int TDW32_SPLIT_BYTES = 2 * TDW32_B_BYTES;             // [small; big] of a K step
constexpr int TDW32_BUF_BYTES = 2 * TDW32_SPLIT_BYTES;           // two K steps
constexpr int TDW32_ACC_BYTES = 256 * TDW32_NB / 2 * 4;          // the flushed running sums
constexpr int TDW32_RED_BYTES = 256 * 4;                         // db's thread sums
constexpr int TDW32_SMEM_BYTES = 1024 + TDW32_RING_BYTES + TDW32_BUF_BYTES + TDW32_ACC_BYTES +
                                 TDW32_RED_BYTES + 2 * TDW32_STAGES * 8 + 16;
constexpr int TDW32_MAX_MAPS = 12;
constexpr int TDW32_MAX_OUT = 16;
constexpr int TDW32_PART = (TDW32_ROWS + 1) * TDW32_NB;          // floats of an item's partial
constexpr int TDW32_MAX_TILES = 1024;
constexpr int TDW32_ITEM_INTS = 24;
constexpr int TDW32_FLUSH = 32;                                  // K steps a running sum holds

enum TDW32Kind { TDW32_NONE = 0, TDW32_MMA = 1, TDW32_SUM = 2 };

// One item of the work list (ops/wgmma_layout.py: tdw32_item_ints).  x:
// consumer c's source of product p, map + 16 layer + 2048 scale + 4096
// column (-1: no rows); y: product p's Y, map + 16 layer.
struct TDW32Item {
  int out, tile, split, splits, first;  // output slot; ticket; split `split` of `splits`, whose
                                        // partials are first, first + 1, ...
  int r0, c0, nb, rows;                 // dW rows r0 .. r0 + rows, columns c0 .. c0 + nb
  int p0, np;                           // points p0 .. p0 + np
  int db;                               // the item carries db (its tile's first rows)
  int kind[2];
  int x[2][2];
  int y[2];
  int pad[4];
};
static_assert(sizeof(TDW32Item) == TDW32_ITEM_INTS * 4, "one item is TDW32_ITEM_INTS ints");

struct TDW32Args {
  CUtensorMap map[TDW32_MAX_MAPS];      // (M points x cols) planes of f32, boxes of 32 x 32
  const TDW32Item* items;
  int n_items, n_maps, acc;
  float xscale;                         // the skip's f32 1/sqrt2 (x's scale bit)
  float* dw[TDW32_MAX_OUT];             // dW_l (rows ldw[l] apart)
  float* db[TDW32_MAX_OUT];
  int ldw[TDW32_MAX_OUT];
  float* part;                          // a TDW32_PART-float partial an item
};

__device__ unsigned int tdw32_done[TDW32_MAX_TILES];

__device__ __forceinline__ void tdw32_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                           int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tdw32_fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte of a box (32 points x 32 f32 columns, the 128-byte swizzle) that
// holds point p, column col.
__device__ __forceinline__ uint32_t tdw32_box(int p, int col) {
  return (uint32_t)(p * 128 + ((((col >> 2) ^ (p & 7))) << 4) + 4 * (col & 3));
}

__device__ void tdw32_produce(const TDW32Args& p, uint32_t ring, uint32_t full, uint32_t empty) {
  for (int i = 0; i < p.n_maps; ++i) wg::prefetch_map(&p.map[i]);
  int it = 0;
  for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
    const TDW32Item& w = p.items[i];
    for (int pr = 0; pr < 2; ++pr) {
      const int kind = w.kind[pr];
      if (kind == TDW32_NONE) continue;
      const int steps = (w.np + TDW32_BK - 1) / TDW32_BK;
      int bytes = kind == TDW32_MMA ? w.nb / 32 * TDW32_BOX_BYTES : 0;
      for (int c = 0; c < 2; ++c) bytes += w.x[pr][c] >= 0 ? 2 * TDW32_BOX_BYTES : 0;
      for (int k = 0; k < steps; ++k, ++it) {
        const int stage = it % TDW32_STAGES;
        wg::mbar_wait(empty + 8 * stage, ((it / TDW32_STAGES) & 1) ^ 1);
        const uint32_t sb = ring + stage * TDW32_STAGE_BYTES, bar = full + 8 * stage;
        const int pt = w.p0 + TDW32_BK * k;
        wg::mbar_expect_tx(bar, bytes);
        for (int c = 0; c < 2; ++c) {
          const int x = w.x[pr][c];
          if (x < 0) continue;
          for (int j = 0; j < 2; ++j)
            tdw32_load(&p.map[x & 15], sb + (2 * c + j) * TDW32_BOX_BYTES, bar, (x >> 12) + 32 * j,
                       pt, (x >> 4) & 127);
        }
        if (kind == TDW32_MMA)
          for (int j = 0; j < w.nb / 32; ++j)
            tdw32_load(&p.map[w.y[pr] & 15], sb + TDW32_X_BYTES + j * TDW32_BOX_BYTES, bar,
                       w.c0 + 32 * j, pt, (w.y[pr] >> 4) & 127);
      }
    }
  }
}

// The A fragment values of a K step from consumer c's two X boxes (xs):
// x[kk][q] = X[8 kk + t + 4 (q >> 1)][r + 8 (q & 1)].
__device__ __forceinline__ void tdw32_load_a(const unsigned char* xs, int r, int t,
                                             float (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r + 8 * (q & 1), pt = 8 * kk + t + 4 * (q >> 1);
      x[kk][q] = *reinterpret_cast<const float*>(xs + (row >> 5) * TDW32_BOX_BYTES +
                                                 tdw32_box(pt, row & 31));
    }
}

// sum (+ its compensation comp) += v, compensated (Kahan): the long
// sums over a split's points (db, the SUM's row sums) stay within a few
// ulps of the exact one.
__device__ __forceinline__ void tdw32_kahan(float& sum, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// The transposed split of a K step's Y boxes (ys) into buf (small rows,
// then big): B element (n, k) at n * 128 + ((k / 4) ^ (n % 8)) * 16 + 4 (k % 4)
// of each half.  Thread tau (0-255) takes column n = tau % NB and the
// QUADS quads of 4 points from q0 = (tau / NB) QUADS; with db, each quad's
// (v0 + v1) + (v2 + v3) into the compensated sum (dbs, dbc), in point order.
template <int NB>
__device__ __forceinline__ void tdw32_split_b(const unsigned char* ys, unsigned char* buf,
                                              int tau, bool db, float& dbs, float& dbc) {
  constexpr int QUADS = TDW32_BK * NB / 256 / 4;
  const int n = tau % NB, q0 = (tau / NB) * QUADS;
  const unsigned char* col = ys + (n >> 5) * TDW32_BOX_BYTES;
#pragma unroll
  for (int qi = 0; qi < QUADS; ++qi) {
    const int q = q0 + qi;
    float v[4];
    uint32_t big[4], small[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = *reinterpret_cast<const float*>(col + tdw32_box(4 * q + i, n & 31));
      split_tf32(v[i], big[i], small[i]);
    }
    if (db) tdw32_kahan(dbs, dbc, __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])));
    const uint32_t off = n * 128 + ((q ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(buf + off) = make_uint4(small[0], small[1], small[2], small[3]);
    *reinterpret_cast<uint4*>(buf + TDW32_B_BYTES + off) =
        make_uint4(big[0], big[1], big[2], big[3]);
  }
}

// A consumer thread's running sum into its cells of the shared-memory sum
// (acc: float2 i of thread tau at i * 256 + tau, conflict free): written by
// the first flush, added to (round to nearest) by the later ones; run
// starts anew.
template <int NB>
__device__ __forceinline__ void tdw32_flush(float (&run)[NB / 2], float2* acc, int tau,
                                            bool first) {
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) {
    float2 v = make_float2(run[2 * i], run[2 * i + 1]);
    if (!first) {
      const float2 o = acc[i * 256 + tau];
      v = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
    }
    acc[i * 256 + tau] = v;
    run[2 * i] = run[2 * i + 1] = 0.f;
  }
}

// The item's partial (rows 64 c + r (+ 8), the accumulator's columns):
// the shared-memory sum (if any flush was made) + run, to global memory.
template <int NB>
__device__ __forceinline__ void tdw32_partial(const float (&run)[NB / 2], const float2* acc,
                                              float* part, int c, int r, int t, int tau,
                                              bool flushed) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(run[4 * j + 2 * h], run[4 * j + 2 * h + 1]);
      if (flushed) {
        const float2 o = acc[(2 * j + h) * 256 + tau];
        v = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
      }
      *reinterpret_cast<float2*>(part + (size_t)(64 * c + r + 8 * h) * NB + 8 * j + 2 * t) = v;
    }
}

// One product of an item on the consumers: `steps` K steps, each one's
// B split a step ahead into the other buffer (the first before the loop),
// X's A fragments split in registers, the three TF32 products into a fresh
// sum added to run (kMine: the consumer holds dW rows; else it splits B
// and frees the slots only, so no branch sits between its products).
template <int NB, bool kMine>
__device__ __forceinline__ void tdw32_product(float (&run)[NB / 2], int steps, float scale,
                                              bool db, const unsigned char* ring_ptr,
                                              unsigned char* bufp, uint32_t buf, uint32_t full,
                                              uint32_t empty, float2* acc, int tau, int c, int r,
                                              int t, int& it, int& held, int& flushes,
                                              float& dbs, float& dbc) {
  const int lane = threadIdx.x & 31;
  float fresh[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) fresh[i] = 0.f;
  {  // step 0's B
    const int s = it % TDW32_STAGES;
    wg::mbar_wait(full + 8 * s, (it / TDW32_STAGES) & 1);
    tdw32_split_b<NB>(ring_ptr + s * TDW32_STAGE_BYTES + TDW32_X_BYTES, bufp, tau, db, dbs, dbc);
    tdw32_fence_proxy();
    t32_sync();
  }
  for (int k = 0; k < steps; ++k, ++it) {
    const int s = it % TDW32_STAGES;
    uint32_t ab[4][4], as[4][4];
    if (kMine) {
      float v[4][4];
      tdw32_load_a(ring_ptr + s * TDW32_STAGE_BYTES + c * 2 * TDW32_BOX_BYTES, r, t, v);
      t32_split_a(v, scale, ab, as);
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * s);  // X read; Y split a step ago
    const uint32_t bs = buf + (k & 1) * TDW32_SPLIT_BYTES, bb = bs + TDW32_B_BYTES;
    if (kMine) {
      wg::fence_acc(fresh);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        t32_mma<NB>(fresh, ab[kk], wg::smem_desc(bs + 32 * kk, wg::K_MAJOR_LBO, wg::SBO),
                    kk ? 1 : 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        t32_mma<NB>(fresh, as[kk], wg::smem_desc(bb + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        t32_mma<NB>(fresh, ab[kk], wg::smem_desc(bb + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);
      wg::wgmma_commit();
    }
    if (k + 1 < steps) {  // the next step's B, into the other buffer
      const int s2 = (it + 1) % TDW32_STAGES;
      wg::mbar_wait(full + 8 * s2, ((it + 1) / TDW32_STAGES) & 1);
      tdw32_split_b<NB>(ring_ptr + s2 * TDW32_STAGE_BYTES + TDW32_X_BYTES,
                        bufp + ((k + 1) & 1) * TDW32_SPLIT_BYTES, tau, db, dbs, dbc);
      tdw32_fence_proxy();
    }
    if (kMine) {
      wg::wgmma_wait<0>();
      wg::fence_acc(fresh);
      t32_fence(ab);
      t32_fence(as);
      t32_accumulate(run, fresh);
      if (++held == TDW32_FLUSH) {
        tdw32_flush<NB>(run, acc, tau, flushes++ == 0);
        held = 0;
      }
    }
    t32_sync();  // B written for the next step; this step's products are done
  }
}

// One item on the consumers (256 threads): its products into run, flushed
// into the shared-memory sum every TDW32_FLUSH K steps (a two-level sum: no
// running f32 sum adds more than TDW32_FLUSH steps), the item's partial,
// and the tile's sum by the last of its items.
template <int NB>
__device__ __forceinline__ void tdw32_item(const TDW32Args& p, const TDW32Item& w,
                                           const unsigned char* ring_ptr, unsigned char* bufp,
                                           uint32_t buf, float2* acc, float* red, int* last,
                                           uint32_t full, uint32_t empty, int& it) {
  const int tau = threadIdx.x - 128, c = tau >> 7;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // rows r, r + 8 of the consumer's
  const bool mine = w.rows > 64 * c;
  float run[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) run[i] = 0.f;
  float rs0 = 0.f, rs1 = 0.f, rc0 = 0.f, rc1 = 0.f, dbs = 0.f, dbc = 0.f;
  float* part = p.part + (size_t)(w.first + w.split) * TDW32_PART;
  int held = 0, flushes = 0;  // K steps in run; flushes made
  for (int pr = 0; pr < 2; ++pr) {
    const int kind = w.kind[pr];
    if (kind == TDW32_NONE) continue;
    const int steps = (w.np + TDW32_BK - 1) / TDW32_BK;
    const int x = w.x[pr][c];
    if (kind == TDW32_SUM) {  // dm_{n-1}'s column sum: rows r, r + 8 over the step's points
      for (int k = 0; k < steps; ++k, ++it) {
        const int s = it % TDW32_STAGES;
        wg::mbar_wait(full + 8 * s, (it / TDW32_STAGES) & 1);
        if (mine) {
          float v[4][4];
          tdw32_load_a(ring_ptr + s * TDW32_STAGE_BYTES + c * 2 * TDW32_BOX_BYTES, r, t, v);
          // a step's 8 points of each row, (q0 + q2) a k8 step summed in
          // order, into the compensated sums
          float a0 = __fadd_rn(v[0][0], v[0][2]), a1 = __fadd_rn(v[0][1], v[0][3]);
#pragma unroll
          for (int kk = 1; kk < 4; ++kk) {
            a0 = __fadd_rn(a0, __fadd_rn(v[kk][0], v[kk][2]));
            a1 = __fadd_rn(a1, __fadd_rn(v[kk][1], v[kk][3]));
          }
          tdw32_kahan(rs0, rc0, a0);
          tdw32_kahan(rs1, rc1, a1);
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(empty + 8 * s);
      }
      continue;
    }
    const float scale = (x >> 11) & 1 ? p.xscale : 1.f;
    const bool db = w.db && pr == 1;
    if (mine)
      tdw32_product<NB, true>(run, steps, scale, db, ring_ptr, bufp, buf, full, empty, acc, tau,
                              c, r, t, it, held, flushes, dbs, dbc);
    else
      tdw32_product<NB, false>(run, steps, scale, db, ring_ptr, bufp, buf, full, empty, acc,
                               tau, c, r, t, it, held, flushes, dbs, dbc);
  }
  if (w.kind[0] == TDW32_SUM && mine && w.c0 == 0) {  // (l0 + l1) + (l2 + l3) over a row's lanes
    rs0 = __fadd_rn(rs0, __shfl_xor_sync(0xffffffffu, rs0, 1));
    rs0 = __fadd_rn(rs0, __shfl_xor_sync(0xffffffffu, rs0, 2));
    rs1 = __fadd_rn(rs1, __shfl_xor_sync(0xffffffffu, rs1, 1));
    rs1 = __fadd_rn(rs1, __shfl_xor_sync(0xffffffffu, rs1, 2));
    if (t == 0) {
      run[0] = __fadd_rn(run[0], rs0);
      run[2] = __fadd_rn(run[2], rs1);
    }
  }
  if (mine) tdw32_partial<NB>(run, acc, part, c, r, t, tau, flushes > 0);
  if (w.db) {  // db's thread sums in order of their quads: red[n] + red[n + NB] + ...
    red[tau] = dbs;
    t32_sync();
    if (tau < NB) {
      float v = red[tau];
#pragma unroll
      for (int g = 1; g < 256 / NB; ++g) v = __fadd_rn(v, red[tau + g * NB]);
      part[TDW32_ROWS * NB + tau] = v;
    }
  }
  __threadfence();  // the partial is visible before the ticket is taken
  t32_sync();
  if (tau == 0)
    *last = atomicInc(&tdw32_done[w.tile], (unsigned)(w.splits - 1)) == (unsigned)(w.splits - 1);
  t32_sync();
  if (!*last) return;
  __threadfence();
  // the tile's sum in split order: out = (acc ? out : 0) + ((p_0 + p_1) + ...)
  const float* base = p.part + (size_t)w.first * TDW32_PART;
  const int rows = w.rows + (w.db ? 1 : 0), vec = NB / 4;
  for (int i = tau; i < rows * vec; i += 256) {
    const int row = i / vec, col = 4 * (i - row * vec);
    const size_t off = (size_t)(row < w.rows ? row : TDW32_ROWS) * NB + col;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(base + off));
    for (int sp = 1; sp < w.splits; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(base + (size_t)sp * TDW32_PART + off));
      sum = make_float4(__fadd_rn(sum.x, v.x), __fadd_rn(sum.y, v.y), __fadd_rn(sum.z, v.z),
                        __fadd_rn(sum.w, v.w));
    }
    float4* dst = reinterpret_cast<float4*>(
        row < w.rows ? p.dw[w.out] + (size_t)(w.r0 + row) * p.ldw[w.out] + w.c0 + col
                     : p.db[w.out] + w.c0 + col);
    if (p.acc) {
      const float4 o = *dst;
      sum = make_float4(__fadd_rn(o.x, sum.x), __fadd_rn(o.y, sum.y), __fadd_rn(o.z, sum.z),
                        __fadd_rn(o.w, sum.w));
    }
    *dst = sum;
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    trunk_dw_f32_kernel(const __grid_constant__ TDW32Args p) {
  extern __shared__ __align__(128) unsigned char tdw32_smem[];
  const uint32_t raw = wg::smem_u32(tdw32_smem);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* ring_ptr = tdw32_smem + (ring - raw);
  const uint32_t buf = ring + TDW32_RING_BYTES;
  unsigned char* bufp = ring_ptr + TDW32_RING_BYTES;
  float2* acc = reinterpret_cast<float2*>(bufp + TDW32_BUF_BYTES);
  float* red = reinterpret_cast<float*>(bufp + TDW32_BUF_BYTES + TDW32_ACC_BYTES);
  const uint32_t full = buf + TDW32_BUF_BYTES + TDW32_ACC_BYTES + TDW32_RED_BYTES,
                 empty = full + 8 * TDW32_STAGES;
  int* last = reinterpret_cast<int*>(bufp + TDW32_BUF_BYTES + TDW32_ACC_BYTES +
                                     TDW32_RED_BYTES + 2 * TDW32_STAGES * 8);
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TDW32_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == 0) tdw32_produce(p, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  int it = 0;
  for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
    const TDW32Item& w = p.items[i];
    if (w.nb == TDW32_NB)
      tdw32_item<TDW32_NB>(p, w, ring_ptr, bufp, buf, acc, red, last, full, empty, it);
    else
      tdw32_item<64>(p, w, ring_ptr, bufp, buf, acc, red, last, full, empty, it);
    t32_sync();  // the next item reuses red, last and the B buffers
  }
}

// A 3D map of `layers` planes of M rows of `cols` f32 (rows ld floats
// apart, planes `plane` floats apart), boxes of 32 columns x 32 points x 1
// plane with the 128-byte swizzle and zero fill past each extent.
static bool tdw32_map(CUtensorMap* out, const void* ptr, int cols, int M, int ld, int layers,
                      long long plane) {
  if (!ptr || honerf_misaligned16(ptr) || cols <= 0 || M <= 0 || ld < cols || ld % 4 ||
      layers <= 0 || (layers > 1 && (plane % 4 || plane < (long long)ld * M)))
    return false;
  wg::EncodeTiled enc = wg::encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)M, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4,
                                 (cuuint64_t)(layers > 1 ? plane : (long long)ld * M) * 4};
  const cuuint32_t box[3] = {TDW32_BK, TDW32_BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace honerf

// One pass's weight gradients on M points.  Sources (n_maps of them): map i
// is layers[i] planes of M rows of cols[i] f32 at bases[i], rows lds[i]
// floats apart, planes planes[i] floats apart.  items: the work list on the
// device (n_items of TDW32_ITEM_INTS ints, ops/wgmma_layout.py:
// tdw32_plan), whose slots index dw / db (n_out of each: dW_l rows ldw[l]
// floats apart, db_l; 16-byte aligned).  part: n_items x TDW32_PART floats
// of scratch.  acc: add to dw / db (the passes after the first).  Refused
// (cudaErrorInvalidValue): an operand TMA or the float4 stores cannot
// take, too many maps or slots, too little scratch.  xscale: the skip's
// f32 1/sqrt2, which multiplies the X values of a source whose scale bit
// is set before their split.
extern "C" int honerf_trunk_dw_f32(int M, int n_maps, const void* const* bases, const int* cols,
                                   const int* lds, const int* layers, const long long* planes,
                                   const void* items, int n_items, int n_out, void* const* dw,
                                   const int* ldw, void* const* db, float* part,
                                   long long part_floats, int acc, float xscale,
                                   cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (M < 0 || n_maps <= 0 || n_maps > TDW32_MAX_MAPS || n_out <= 0 || n_out > TDW32_MAX_OUT ||
      n_items < 0 || !items || honerf_misaligned16(items) || !part || honerf_misaligned16(part) ||
      part_floats < (long long)n_items * TDW32_PART)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || n_items == 0) return (int)cudaGetLastError();
  TDW32Args p{};
  for (int i = 0; i < n_maps; ++i)
    if (!tdw32_map(&p.map[i], bases[i], cols[i], M, lds[i], layers[i], planes[i]))
      return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_out; ++l) {
    if (!dw[l] || !db[l] || honerf_misaligned16(dw[l]) || honerf_misaligned16(db[l]) ||
        ldw[l] % 4)
      return (int)cudaErrorInvalidValue;
    p.dw[l] = static_cast<float*>(dw[l]);
    p.db[l] = static_cast<float*>(db[l]);
    p.ldw[l] = ldw[l];
  }
  p.items = static_cast<const TDW32Item*>(items);
  p.n_items = n_items;
  p.n_maps = n_maps;
  p.acc = acc;
  p.xscale = xscale;
  p.part = part;
  static bool smem_set = false;
  const cudaError_t err =
      t32_smem_ready((const void*)trunk_dw_f32_kernel, TDW32_SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int grid = n_items < wg::sm_count() ? n_items : wg::sm_count();
  trunk_dw_f32_kernel<<<grid, wg::THREADS, TDW32_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}
