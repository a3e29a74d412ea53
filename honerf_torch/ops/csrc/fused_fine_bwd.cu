// Color-fused hand fine pass, backward (ops/fused_fine_full.py:
// hand_fine_color's autograd backward -> _hand_fine_color_bwd_cuda).
//
// Replaces: the backward Pallas kernel of honerf_tpu/ops/fused_fine_full.py
//   (`_bwd_call` pallas_call, body `_make_bwd_kernel` -> `_fine_bwd_block`,
//   recompute branch, piece layout), the custom VJP of `hand_fine_color`.
//
// Bound on an H100: operations.  Per point ~18.9 MFLOP of bf16 matmul at
//   the flagship width (the forward recomputed: 2x the trunk weights for
//   the trunk and u-chain, 1x the color weights; the backward: the u-chain
//   transposed, the forward transposed and two dW products per trunk
//   layer, 4x the trunk weights; the color net transposed and its dW, 2x
//   the color weights) against 40 bytes in and 12 out per point plus
//   ~7.6 MB of f32 dW/db; the floor is ~19 ms per million points at
//   989 TFLOP/s.
//
// Design: the TPU kernel rematerialised the forward per block in VMEM and
//   accumulated f32 dW across its sequential grid.  Here the backward is a
//   sequence of launches over a bounded global scratch (the wrapper's
//   BWD_CHUNK of points), after K2's forward launches rerun with every
//   activation, sigmoid row, u-chain t (bf16) and c (f32) row kept:
//     color_dz_kernel                  dz = s (1 - s) dcolor
//     gemm (EPI_MASK) x 4, gemm x 1    color net transposed (against the
//                                      transposed color weights); relu
//                                      masks from the kept activations
//     fine_bwd_rev_kernel              grad-PE transposed into dg; the
//                                      reverse chain transposed at dg -> du;
//                                      the trunk's top cotangent [dsdf|dfeat]
//                                      (tiles of points staged in shared
//                                      memory, stored by cp.async.bulk)
//     gemm (EPI_UT) x 8                u-chain transposed, upward: dc, ds
//     gemm (EPI_DZ) x 9                forward transposed, downward, with the
//                                      second-order term dz = da s +
//                                      ds beta s (1 - s) in the epilogue
//     fine_bwd_emb_kernel              embedding forward transposed -> dq,
//                                      dp, and per-point pose rows
//     gemm_tn_kernel + reduce          dW = X^T dY over the point axis,
//                                      split over points into f32 partials
//                                      summed in a fixed order (trunk.cuh)
//     colsum_partial_kernel            db (from the f32 dz), fixed order
//     pose_sum_kernel                  the pose sums drotT / doff in one
//                                      launch, a fixed order of their own
//   So two runs give the same bits: no atomics anywhere.  The GEMMs run
//   on wgmma with a TMA ring (wgmma.cuh); fine_bwd_rev_kernel is staged
//   like the embedding (its note below); fusing the launches is later work.
//
// f32 mode (FineMeta.dtype 'f32': the confs' trunks as written; JAX's
//   FineMeta(dtype='f32')): the per-point kernels' f32 variants (the
//   cotangent rows du_b, du_s in f32); the color net's transpose in one
//   launch (color_fused_f32.cu: color_bwd_f32_kernel, no color_dz_kernel),
//   the trunk's two chains in two (trunk_bwd_f32.cu), every dW and db in
//   one (trunk_dw_f32.cu), all 3xTF32 on wgmma; no gemm_f32_kernel.
//   fine_bwd_emb_kernel reads only f32 rows (u, de, dx) in either mode, so
//   one version serves both.  Bound: operations at 165 TFLOP/s of f32 work
//   (3xTF32), ~18.2 MFLOP a point with the color net (~14.3 without), 110
//   ms per million points.  Frozen (want_dw
//   false: pose fitting, whose nets are constants; JAX's
//   FineMeta(dtype='f32', want_dw=False),
//   honerf_tpu/ops/fused_fine_full.py:1819-1823): no dW/db work at all,
//   no gemm_tn*_kernel, colsum_partial_kernel or reduce_partials_kernel;
//   ~2x K2's products.
//
// No-color mode (`hand_fine_full`'s backward, the same pallas_call without
//   the color net): no color launches; copy_cols_kernel (trunk.cuh) puts
//   the cotangents on e and on the features where the color net's input
//   cotangent went (dx[:, :E] and dx[:, Ep:Ep + F]) and dsdf beside them,
//   and every later launch is the same.

#include "trunk.cuh"

namespace honerf {

// ---------------------------------------------------------------------------
// Per-point kernels
// ---------------------------------------------------------------------------

// dz = s (1 - s) dcolor on the color columns (s: the forward's sigmoid in
// packed[:, 4:7]), zero on the padding up to `width`; dzb in the operand
// type T (bf16, or f32 in the f32 mode).
template <typename T>
__global__ void color_dz_kernel(const float* __restrict__ packed,
                                const float* __restrict__ dcolor, int M,
                                float* __restrict__ dzf, T* __restrict__ dzb,
                                int ld, int width) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * width) return;
  int m = (int)(i / width), c = (int)(i % width);
  float v = 0.f;
  if (c < 3) {
    float s = packed[(size_t)m * 8 + 4 + c];
    v = s * (1.f - s) * dcolor[(size_t)m * 3 + c];
  }
  dzf[(size_t)m * ld + c] = v;
  dzb[(size_t)m * ld + c] = from_f32<T>(v);
}

// The transposed reverse chain's cotangents of bone j at cotangent t on g
// (T12-T5): ca on a_v, cb on b_h (= cd on each d_h3 channel), cc on c_rr,
// and the direct adjoints dq, dv, dsc, dw3.
struct Head {
  float ca, cb, cc[3], cf[3], dq[3], dv, dsc, dw3[3];
};

__device__ __forceinline__ Head transpose_head(const Stages& st, const Chain* ch,
                                               const float* rotT, const float t[3], int j) {
  Head hd;
  float cn = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {                          // T12
    int col = 3 * j + k;
    hd.cf[k] = t[0] * rotT[col] + t[1] * rotT[kLane + col] + t[2] * rotT[2 * kLane + col];
    cn += 2.f * st.q[k] * hd.cf[k];                      // T11
  }
  hd.ca = 0.5f * cn / st.v;                              // T10
  hd.cb = -kTau * st.sc * (1.f - st.sc) * hd.ca;         // T9
  float w3c = st.w3 * st.w3 * st.w3;
#pragma unroll
  for (int k = 0; k < 3; ++k) hd.cc[k] = -0.5f * st.q[k] * w3c * cn + st.w3 * hd.cf[k];  // T7/T6
  if (ch) {
    hd.dv = -0.5f * ch->a_v / (st.v * st.v) * cn;
    hd.dsc = -kTau * (1.f - 2.f * st.sc) * ch->b_h * hd.ca;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      hd.dq[k] = 2.f * ch->n_v2p * hd.cf[k] - 0.5f * ch->c_rr[k] * w3c * cn;
      hd.dw3[k] = -1.5f * ch->c_rr[k] * st.q[k] * st.w3 * st.w3 * cn + ch->c_rr[k] * hd.cf[k];
    }
  }
  return hd;
}

// ---------------------------------------------------------------------------
// The reverse chain transposed at dg (K3's du; in JAX's _fine_bwd_block,
// _gpe_transpose, _transpose_head and _emb_rev_transpose_block at
// honerf_tpu/ops/fused_fine_full.py:792, :396, :432, inside :1650)
// ---------------------------------------------------------------------------
//
// Per point m:
//  * dg_total = dg + the grad-PE transpose of the color input's cotangent
//    (dx columns Ep + Fp ..) -> dgt[m, 0:3];
//  * du = the reverse chain transposed at dg_total (T4-T1), stored as
//    T(du) and T(du / sqrt2) (the u-chain transpose's operands at layer 0
//    and at the skip), zero on the padding up to Ep;
//  * the trunk's top cotangent [dsdf | dfeat (dx columns Ep ..) | 0] into
//    dzf (f32) and dzb (T), Op columns.
// T: bf16, or f32 in the f32 mode.
//
// Bound on an H100: bytes.  A point writes 2 Ep sizeof(T) + Op (4 +
// sizeof(T)) bytes (7,552 in bf16 at the flagship's Ep 1408, Op 320;
// 13,824 in f32) and reads ~1.2 KB (dx's feature and grad-PE columns,
// dsdf, dg, g, the point): ~0.147 ms for a bf16 step's 56,448 points at
// 3.35 TB/s.
//
// Design (hand_embed_kernel's, common.cuh): persistent blocks
// (BWR_BLOCKS_PER_SM a SM, BWR_THREADS threads) walk tiles of P
// consecutive points (BWR_POINTS_BF16 in bf16, half as many in f32),
// each staged in shared memory as four dense sub-tiles (du_b and du_s: P
// x Ep; dzf and dzb: P x Op), double-buffered.  Three passes a tile,
// every thread on units in turn, neighbouring threads on neighbouring
// columns:
//  1. (point, channel): dg_total by the grad-PE transpose's loop as it
//     was, its 2 L cotangents loaded into registers first (one memory
//     latency, not L); (point, bone): the bone stages; both into shared
//     rows;
//  2. (point, bone): transpose_head (bone 0 stores dgt), the v-part
//     columns, and the values the r-part reads (cb, h cc); (point, 8
//     columns): the top cotangent, a one-column shift of dx's feature
//     columns;
//  3. (point, bone, channel): the r-part columns.
// The zero padding [E, Ep) is written into both buffers once; passes 2-3
// write every other column of a tile's rows.  A finished tile leaves by
// cp.async.bulk, one copy a sub-tile (one a row where the rows are not
// dense in global memory); the block computes the next tile in the other
// buffer while they drain, and waits for a buffer's copies to have read
// it before writing it again.  The ragged last tile stores only its rows.
//
// The arithmetic per element is the warp-per-point kernel's it replaced:
// bone_stages, transpose_head, one precise sinf / cosf per argument (no
// fast intrinsics), the double-angle recurrence and the grad-PE sum in
// the same order and the same expressions, stages through shared memory
// as exact f32; bench_gemm.py --perpoint-parent holds the outputs' bits
// to another checkout's.  (The grad-PE sum stays one expression in one
// thread, sinf / cosf inside it: its terms formed by other threads and
// added from shared memory round differently and change dgt's bits.)
constexpr int BWR_THREADS = 256;
constexpr int BWR_BLOCKS_PER_SM = 3;
constexpr int BWR_POINTS_BF16 = 4;            // P in bf16; f32 tiles take half as many
constexpr int BWR_EP_MAX = 1536;              // the widest du row a tile holds (elements)
constexpr int BWR_OP_MAX = 384;               // the widest dz row
constexpr int BWR_L_MAX = 8;                  // grad-PE frequencies (their cotangents in registers)
constexpr int BWR_STAGE_FLOATS = 21 * 10 + 21 + 63 + 3;   // a point's bone stages, cb, h cc, dg_total
constexpr int BWR_TILE_BYTES_MAX = BWR_POINTS_BF16 * (2 * BWR_EP_MAX * 2 + BWR_OP_MAX * (4 + 2));
constexpr int BWR_SMEM_MAX = 2 * BWR_TILE_BYTES_MAX + BWR_POINTS_BF16 * BWR_STAGE_FLOATS * 4;

template <typename T>
__host__ __device__ constexpr int bwr_points() {
  return BWR_POINTS_BF16 * 2 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t bwr_tile_bytes(int Ep, int Op) {
  return (size_t)bwr_points<T>() * (2 * (size_t)Ep * sizeof(T) + (size_t)Op * (4 + sizeof(T)));
}

template <typename T>
__host__ __device__ constexpr size_t bwr_smem_bytes(int Ep, int Op) {
  return 2 * bwr_tile_bytes<T>(Ep, Op) + (size_t)bwr_points<T>() * BWR_STAGE_FLOATS * 4;
}

// du's column col of a staged row pair: T(v) and T(v / sqrt2).
template <typename T>
__device__ __forceinline__ void put_du(T* row_b, T* row_s, int col, float v) {
  row_b[col] = from_f32<T>(v);
  row_s[col] = from_f32<T>(v * kInvSqrt2);
}

// rows x row_bytes of shared memory into rows ld_bytes apart: one bulk
// copy where they are dense, else one a row.
__device__ __forceinline__ void bulk_store_rows(void* gmem, size_t ld_bytes, const void* smem,
                                                unsigned row_bytes, int rows) {
  if (ld_bytes == row_bytes) {
    bulk_store(gmem, smem, row_bytes * (unsigned)rows);
    return;
  }
  for (int r = 0; r < rows; ++r)
    bulk_store(static_cast<char*>(gmem) + r * ld_bytes,
               static_cast<const char*>(smem) + (size_t)r * row_bytes, row_bytes);
}

template <typename T>
__global__ void __launch_bounds__(BWR_THREADS, BWR_BLOCKS_PER_SM)
    fine_bwd_rev_kernel(const float* __restrict__ pts, int M, const float* __restrict__ rotT,
                        const float* __restrict__ off, const float* __restrict__ cut, int vL,
                        int rL, const float* __restrict__ packed, const float* __restrict__ dsdf,
                        const float* __restrict__ dg, const float* __restrict__ dx, int ldx,
                        int Ep, int F, int Fp, int L, T* __restrict__ du_b, T* __restrict__ du_s,
                        int lddu, float* __restrict__ dgt, float* __restrict__ dzf,
                        T* __restrict__ dzb, int lddz, int Op) {
  constexpr int P = bwr_points<T>();
  extern __shared__ __align__(128) unsigned char bwr_smem[];
  const size_t tile_bytes = bwr_tile_bytes<T>(Ep, Op);
  Stages* sst = reinterpret_cast<Stages*>(bwr_smem + 2 * tile_bytes);   // [P][21]
  float* scb = reinterpret_cast<float*>(sst + P * 21);                   // [P][21]: cb
  float* shc = scb + P * 21;                                             // [P][63]: h cc
  float* sgb = shc + P * 63;                                             // [P][3]: dg_total
  const int tid = threadIdx.x;
  const int rb = 21 * (1 + 2 * vL);
  const int E = rb + 63 * (1 + 2 * rL);
  // the zero padding of the du rows (2 P a buffer: du_b's, then du_s's)
  const int pad = Ep - E;
  for (int i = tid; i < 4 * P * pad; i += BWR_THREADS) {
    const int k = i / pad, b = k / (2 * P);
    T* row = reinterpret_cast<T*>(bwr_smem + b * tile_bytes) + (size_t)(k - b * 2 * P) * Ep;
    row[E + i - k * pad] = from_f32<T>(0.f);
  }
  const int n_tiles = (M + P - 1) / P;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int p0 = tile * P, rows = min(P, M - p0);
    T* tb = reinterpret_cast<T*>(bwr_smem + (size_t)(it & 1) * tile_bytes);   // du_b
    T* ts = tb + (size_t)P * Ep;                                               // du_s
    float* tf = reinterpret_cast<float*>(ts + (size_t)P * Ep);                 // dzf
    T* tz = reinterpret_cast<T*>(tf + (size_t)P * Op);                         // dzb
    // pass 1: dg_total, the bone stages
    const int ng = rows * 3, nst = rows * 21;
    for (int u = tid; u < ng + nst; u += BWR_THREADS) {
      if (u < ng) {
        const int pt = u / 3, j = u - pt * 3;
        const size_t m = (size_t)(p0 + pt);
        const float* dgpe = dx + m * ldx + Ep + Fp;
        float ds[BWR_L_MAX], dc[BWR_L_MAX];
#pragma unroll
        for (int l = 0; l < BWR_L_MAX; ++l) {
          ds[l] = l < L ? dgpe[(1 + l) * 8 + j] : 0.f;
          dc[l] = l < L ? dgpe[(1 + L + l) * 8 + j] : 0.f;
        }
        float gv = packed[m * 8 + 1 + j];
        float tj = dg[m * 3 + j] + dgpe[j];
#pragma unroll
        for (int l = 0; l < BWR_L_MAX; ++l) {
          if (l < L) {
            float f = (float)(1 << l);
            tj += f * (cosf(gv * f) * ds[l] - sinf(gv * f) * dc[l]);
          }
        }
        sgb[pt * 3 + j] = tj;
      } else {
        const int w = u - ng, pt = w / 21, j = w - pt * 21;
        const float* pp = pts + 3 * (size_t)(p0 + pt);
        const float p[3] = {pp[0], pp[1], pp[2]};
        sst[w] = bone_stages(p, rotT, off, cut, j);
      }
    }
    if (tid == 0) bulk_wait_read<1>();  // this buffer's copies, two tiles back, have read it
    __syncthreads();
    // pass 2: (point, bone) the head and the v-part; (point, 8 columns) the
    // top cotangent
    const int nh = rows * 21, oc = Op / 8;
    for (int u = tid; u < nh + rows * oc; u += BWR_THREADS) {
      if (u < nh) {
        const int pt = u / 21, j = u - pt * 21;
        float t[3] = {sgb[pt * 3], sgb[pt * 3 + 1], sgb[pt * 3 + 2]};
        if (j == 0) {
          float* d = dgt + (size_t)(p0 + pt) * 4;
          d[0] = t[0];
          d[1] = t[1];
          d[2] = t[2];
        }
        const Stages st = sst[u];
        const Head hd = transpose_head(st, nullptr, rotT, t, j);
        const float cb = hd.cb, hca = st.h * hd.ca;
        T* rowb = tb + (size_t)pt * Ep;
        T* rows_ = ts + (size_t)pt * Ep;
        auto put = [&](int col, float v) { put_du(rowb, rows_, col, v); };
        // T2/T1: v family
        put(j, st.v * cb + hca);
        float s = sinf(st.v), c = cosf(st.v);
        for (int l = 0; l < vL; ++l) {
          if (l) {
            float s2 = 2.f * s * c, c2 = (c - s) * (c + s);
            s = s2;
            c = c2;
          }
          float f = (float)(1 << l);
          put(21 + 21 * l + j, s * cb + f * c * hca);
          put(21 + 21 * (vL + l) + j, c * cb - f * s * hca);
        }
        // what the r family reads: cd = cb on every channel of the bone
        scb[u] = cb;
#pragma unroll
        for (int k = 0; k < 3; ++k) shc[pt * 63 + 3 * j + k] = st.h * hd.cc[k];
      } else {
        const int w = u - nh, pt = w / oc, c0 = (w - pt * oc) * 8;
        const size_t m = (size_t)(p0 + pt);
        const float* dxr = dx + m * ldx;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = c0 + i;
          v[i] = col == 0 ? dsdf[m] : (col <= F ? dxr[Ep + col - 1] : 0.f);
        }
        store_f32x8(tf + (size_t)pt * Op + c0, v);
        store8(tz + (size_t)pt * Op + c0, v);
      }
    }
    __syncthreads();
    // pass 3: (point, bone, channel) T4/T3, the r family
    for (int u = tid; u < rows * 63; u += BWR_THREADS) {
      const int pt = u / 63, k = u - pt * 63, bone = pt * 21 + k / 3;
      const float x = sst[bone].rr[k % 3], hc = shc[u], cb = scb[bone];
      T* rowb = tb + (size_t)pt * Ep;
      T* rows_ = ts + (size_t)pt * Ep;
      auto put = [&](int col, float v) { put_du(rowb, rows_, col, v); };
      put(rb + k, x * cb + hc);
      float sr = sinf(x), cr = cosf(x);
      for (int l = 0; l < rL; ++l) {
        if (l) {
          float s2 = 2.f * sr * cr, c2 = (cr - sr) * (cr + sr);
          sr = s2;
          cr = c2;
        }
        float f = (float)(1 << l);
        put(rb + 63 + 63 * l + k, sr * cb + f * cr * hc);
        put(rb + 63 + 63 * (rL + l) + k, cr * cb - f * sr * hc);
      }
    }
    fence_proxy_async_shared();  // the generic writes, before the bulk copies read them
    __syncthreads();
    if (tid == 0) {
      const size_t m0 = (size_t)p0;
      const unsigned du_row = (unsigned)(Ep * sizeof(T)), dz_row = (unsigned)(Op * sizeof(T));
      bulk_store_rows(du_b + m0 * lddu, (size_t)lddu * sizeof(T), tb, du_row, rows);
      bulk_store_rows(du_s + m0 * lddu, (size_t)lddu * sizeof(T), ts, du_row, rows);
      bulk_store_rows(dzf + m0 * lddz, (size_t)lddz * 4, tf, (unsigned)(Op * 4), rows);
      bulk_store_rows(dzb + m0 * lddz, (size_t)lddz * sizeof(T), tz, dz_row, rows);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// One warp per point, lane j < 21 = bone j: the embedding forward
// transposed at de_total = de (the trunk's) + dx[:, :E] (the color net's),
// merged with the reverse-chain transpose's stage adjoints -> dq of the
// bone's three channels; then dp = dq rotT^T (warp sum) and the pose row
// P[m] = [dg_a f_q + p_a dq (a = 0, 1, 2) | dq], 64 columns each (column
// 63 of each zero), whose column sums are drotT and doff.
__global__ void fine_bwd_emb_kernel(const float* __restrict__ pts, int M,
                                    const float* __restrict__ rotT, const float* __restrict__ off,
                                    const float* __restrict__ cut, int vL, int rL,
                                    const float* __restrict__ u, int ldu,
                                    const float* __restrict__ dgt,
                                    const float* __restrict__ de, int ldde,
                                    const float* __restrict__ dx, int ldx,
                                    float* __restrict__ dp, float* __restrict__ P) {
  int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int j = threadIdx.x & 31;
  if (m >= M) return;
  float p[3] = {pts[3 * m], pts[3 * m + 1], pts[3 * m + 2]};
  float t[3] = {dgt[(size_t)m * 4], dgt[(size_t)m * 4 + 1], dgt[(size_t)m * 4 + 2]};
  float* Pr = P + (size_t)m * 256;
  float acc[3] = {0.f, 0.f, 0.f};
  if (j < 21) {
    const float* ur = u + (size_t)m * ldu;
    const float* der = de + (size_t)m * ldde;
    const float* dxr = dx + (size_t)m * ldx;
    auto e_at = [&](int col) { return der[col] + dxr[col]; };
    Stages st = bone_stages(p, rotT, off, cut, j);
    Chain ch = rev_chain(st, ur, j, vL, rL);
    Head hd = transpose_head(st, &ch, rotT, t, j);
    const float cb = hd.cb, hca = st.h * hd.ca;
    // v family: T2/T1 adjoints merged with the e pieces' cotangents
    float u_vh = ur[j], e_vh = e_at(j);
    float dv = hd.dv + u_vh * cb + st.h * e_vh;
    float dh = ch.phi_v * hd.ca + st.v * e_vh;
    float s = sinf(st.v), c = cosf(st.v);
    for (int l = 0; l < vL; ++l) {
      if (l) {
        float s2 = 2.f * s * c, c2 = (c - s) * (c + s);
        s = s2;
        c = c2;
      }
      float f = (float)(1 << l);
      int cs_ = 21 + 21 * l + j, cc_ = 21 + 21 * (vL + l) + j;
      float usv = ur[cs_], ucv = ur[cc_], esv = e_at(cs_), ecv = e_at(cc_);
      float dsv = usv * cb - f * ucv * hca + st.h * esv;
      float dcv = ucv * cb + f * usv * hca + st.h * ecv;
      dh += s * esv + c * ecv;
      dv += f * (c * dsv - s * dcv);
    }
    // r family, per channel: T4/T3 adjoints merged with the e pieces'
    const int rb = 21 * (1 + 2 * vL);
    float dq[3], dvrep_sum = 0.f;
    float w3c = st.w3 * st.w3 * st.w3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int col = 3 * j + k;
      float x = st.rr[k], hc = st.h * hd.cc[k];
      float u_rh = ur[rb + col], e_rh = e_at(rb + col);
      float drr = u_rh * cb + st.h * e_rh;
      float dh3 = ch.phi_r[k] * hd.cc[k] + x * e_rh;
      float sr = sinf(x), cr = cosf(x);
      for (int l = 0; l < rL; ++l) {
        if (l) {
          float s2 = 2.f * sr * cr, c2 = (cr - sr) * (cr + sr);
          sr = s2;
          cr = c2;
        }
        float f = (float)(1 << l);
        int cs_ = rb + 63 + 63 * l + col, cc_ = rb + 63 + 63 * (rL + l) + col;
        float usr = ur[cs_], ucr = ur[cc_], esr = e_at(cs_), ecr = e_at(cc_);
        float dsr = usr * cb - f * ucr * hc + st.h * esr;
        float dcr = ucr * cb + f * usr * hc + st.h * ecr;
        dh3 += sr * esr + cr * ecr;
        drr += f * (cr * dsr - sr * dcr);
      }
      dh += dh3;                                           // h3 = repeat(h)
      dq[k] = hd.dq[k] + st.w3 * drr;                      // rr = q w3
      float dw3 = hd.dw3[k] + st.q[k] * drr;
      dvrep_sum += -0.5f * w3c * dw3;                      // w3 = rsqrt(v2p + eps)
    }
    float dsc = hd.dsc - dh;                               // h = 1 - sc
    dv += kTau * st.sc * (1.f - st.sc) * dsc;              // sc = sigmoid(tau (v - cut))
    float dv2p = dvrep_sum + 0.5f * dv / st.v;             // v = sqrt(v2p)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int col = 3 * j + k;
      dq[k] += 2.f * st.q[k] * dv2p;                       // v2p = sum q^2 + eps
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] += dq[k] * rotT[a * kLane + col];
        Pr[a * 64 + col] = t[a] * ch.f_q[k] + p[a] * dq[k];
      }
      Pr[192 + col] = dq[k];
    }
  } else if (j < 25) {
    Pr[(j - 21) * 64 + 63] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], o);
  if (j == 0) {
    dp[(size_t)m * 3] = acc[0];
    dp[(size_t)m * 3 + 1] = acc[1];
    dp[(size_t)m * 3 + 2] = acc[2];
  }
}

// ---------------------------------------------------------------------------
// The pose sums drotT / doff (drotT_blk / doff_blk inside K3's pallas_call,
// honerf_tpu/ops/fused_fine_full.py:1129-1131, summed over its grid at
// :1384-1392): the column sums of the per-point pose rows P (M, 256) that
// fine_bwd_emb_kernel writes
// ---------------------------------------------------------------------------
//
// out[:256] (+)= sum over rows of P[:M, :256], f32, in a fixed order.
//
// Bound on an H100: bytes, P read once (1 KB a row): a bf16 step's 56,448
// rows are 57.8 MB, 17.3 us at 3.35 TB/s.  P has just been written by
// fine_bwd_emb_kernel and may still sit in the 50 MB L2, so a share of the
// bound near or above 1 is L2, not an error.
//
// Design: one launch of ceil(M / split) blocks, split chosen by the host
// from M and the SM count (ops/perpoint_layout.py: pose_split) for about
// PS_BLOCKS_PER_SM blocks a SM whatever M is (and at least PS_ROW_STEP
// rows a block, so a small M takes few blocks).  Thread t owns the float4
// column group c = t % PS_GROUPS and the row lane r = t / PS_GROUPS, and
// PS_ACC accumulators; with the step loop unrolled four ways, up to 4 x
// PS_ACC independent 16-byte loads a thread are in flight: in the rows [s split, min(M, (s+1) split)) of block s,
// accumulator k adds the rows s split + PS_ROW_STEP i + PS_LANES k + r, i =
// 0, 1, ...  Then, in order: a thread's sum ((a0 + a1) + (a2 + a3)) + ((a4
// + a5) + (a6 + a7)); the block's partial t0 + t1 + t2 + t3 over the row
// lanes (through shared memory) into ws[s]; the last block to finish (an
// atomic ticket of its own, pose_done, which wraps to 0 for the next
// launch) sums the S partials with the same map, partial s in the place
// of row s (every warp of the block), and out = (acc ? out : 0) + that.
// No atomic orders an addition: two runs give the same bits.  A kernel of
// its own name, apart from trunk.cuh's column sum: a frozen backward (pose
// fitting) launches no dW / db kernel.  ops/fused_fine_full.py:
// pose_sum_ordered_plain states the order.  Preconditions: 16-byte-aligned
// P and ws, P's rows 256 floats apart; launches of one process run on one
// stream at a time (the ticket is the library's).
constexpr int PS_THREADS = 256;
constexpr int PS_COLS = 256;
constexpr int PS_GROUPS = PS_COLS / 4;
constexpr int PS_LANES = PS_THREADS / PS_GROUPS;
constexpr int PS_ACC = 8;
constexpr int PS_ROW_STEP = PS_LANES * PS_ACC;
constexpr int PS_BLOCKS_PER_SM = 2;

__device__ unsigned int pose_done;

// A thread's sum, in the order above, over the rows [r0, r1) of X (PS_COLS
// floats a row): rows of P through the read-only path, or (PARTIALS) the
// partials in ws through L2, where the other blocks' stores are seen.
template <bool PARTIALS>
__device__ __forceinline__ float4 pose_thread_sum(const float* __restrict__ X, int r0, int r1,
                                                  int r, int c) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* xc = X + 4 * c;
  float4 a[PS_ACC];
#pragma unroll
  for (int k = 0; k < PS_ACC; ++k) a[k] = zero;
  // the loads of four steps in flight before their adds, which keep their
  // order: a fit step's call is three steps a thread, its last block's nine
#pragma unroll 4
  for (int base = r0; base < r1; base += PS_ROW_STEP) {
    float4 v[PS_ACC];
#pragma unroll
    for (int k = 0; k < PS_ACC; ++k) {
      const int row = base + PS_LANES * k + r;
      const float4* p = reinterpret_cast<const float4*>(xc + (size_t)row * PS_COLS);
      v[k] = row < r1 ? (PARTIALS ? __ldcg(p) : __ldg(p)) : zero;
    }
#pragma unroll
    for (int k = 0; k < PS_ACC; ++k) a[k] = add4(a[k], v[k]);
  }
  return add4(add4(add4(a[0], a[1]), add4(a[2], a[3])), add4(add4(a[4], a[5]), add4(a[6], a[7])));
}

__global__ void __launch_bounds__(PS_THREADS, PS_BLOCKS_PER_SM)
    pose_sum_kernel(const float* __restrict__ P, int M, int split, float* __restrict__ ws,
                    float* __restrict__ out, int acc) {
  __shared__ float4 red[PS_LANES][PS_GROUPS];
  __shared__ bool last;
  const int c = threadIdx.x % PS_GROUPS, r = threadIdx.x / PS_GROUPS;
  const int S = gridDim.x, s = blockIdx.x;
  const int r0 = s * split, r1 = min(M, r0 + split);
  red[r][c] = pose_thread_sum<false>(P, r0, r1, r, c);
  __syncthreads();
  if (r == 0) {
    float4 t = red[0][c];
#pragma unroll
    for (int w = 1; w < PS_LANES; ++w) t = add4(t, red[w][c]);
    *reinterpret_cast<float4*>(ws + (size_t)s * PS_COLS + 4 * c) = t;
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(&pose_done, (unsigned)(S - 1)) == (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  red[r][c] = pose_thread_sum<true>(ws, 0, S, r, c);
  __syncthreads();
  if (r == 0) {
    float4 tot = red[0][c];
#pragma unroll
    for (int w = 1; w < PS_LANES; ++w) tot = add4(tot, red[w][c]);
    float* o = out + 4 * c;
    if (acc) {
      o[0] += tot.x;
      o[1] += tot.y;
      o[2] += tot.z;
      o[3] += tot.w;
    } else {
      o[0] = tot.x;
      o[1] = tot.y;
      o[2] = tot.z;
      o[3] = tot.w;
    }
  }
}

}  // namespace honerf

// ---------------------------------------------------------------------------
// Plain C entry points (loaded with ctypes); each returns cudaGetLastError().
// ---------------------------------------------------------------------------

template <typename T>
static int honerf_color_dz_t(const float* packed, const float* dcolor, int M, float* dzf, T* dzb,
                             int ld, int width, cudaStream_t stream) {
  size_t n = (size_t)M * width;
  if (n)
    honerf::color_dz_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        packed, dcolor, M, dzf, dzb, ld, width);
  return (int)cudaGetLastError();
}

extern "C" int honerf_color_dz(const float* packed, const float* dcolor, int M, float* dzf,
                               __nv_bfloat16* dzb, int ld, int width, cudaStream_t stream) {
  return honerf_color_dz_t(packed, dcolor, M, dzf, dzb, ld, width, stream);
}

extern "C" int honerf_color_dz_f32(const float* packed, const float* dcolor, int M, float* dzf,
                                   float* dzb, int ld, int width, cudaStream_t stream) {
  return honerf_color_dz_t(packed, dcolor, M, dzf, dzb, ld, width, stream);
}

// Refused (cudaErrorInvalidValue) where the tiles' bulk copies or shared
// memory do not fit: du_b, du_s, dzf, dzb 16-byte aligned, their rows
// and row strides multiples of 16 bytes (Op and lddz multiples of 8), E
// <= Ep <= BWR_EP_MAX <= lddu, Op <= BWR_OP_MAX <= lddz, L <= BWR_L_MAX.
template <typename T>
static int honerf_fine_bwd_rev_t(const float* pts, int M, const float* rotT, const float* off,
                                 const float* cut, int vL, int rL, const float* packed,
                                 const float* dsdf, const float* dg, const float* dx, int ldx,
                                 int Ep, int F, int Fp, int L, T* du_b, T* du_s, int lddu,
                                 float* dgt, float* dzf, T* dzb, int lddz, int Op,
                                 cudaStream_t stream) {
  const int E = 21 * (1 + 2 * vL) + 63 * (1 + 2 * rL);
  if (vL < 0 || rL < 0 || L < 0 || L > honerf::BWR_L_MAX || Ep < E ||
      Ep > honerf::BWR_EP_MAX || lddu < Ep || (Ep * (int)sizeof(T)) % 16 ||
      (lddu * (int)sizeof(T)) % 16 || Op <= 0 || Op % 8 || Op > honerf::BWR_OP_MAX ||
      lddz < Op || lddz % 8 || honerf_misaligned16(du_b) || honerf_misaligned16(du_s) ||
      honerf_misaligned16(dzf) || honerf_misaligned16(dzb))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  static bool smem_set = false;  // raise the dynamic shared-memory cap once per process
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(honerf::fine_bwd_rev_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           honerf::BWR_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int tiles = (M + honerf::bwr_points<T>() - 1) / honerf::bwr_points<T>();
  const int slots = honerf::BWR_BLOCKS_PER_SM * honerf::wg::sm_count();
  honerf::fine_bwd_rev_kernel<T><<<tiles < slots ? tiles : slots, honerf::BWR_THREADS,
                                   honerf::bwr_smem_bytes<T>(Ep, Op), stream>>>(
      pts, M, rotT, off, cut, vL, rL, packed, dsdf, dg, dx, ldx, Ep, F, Fp, L, du_b, du_s, lddu,
      dgt, dzf, dzb, lddz, Op);
  return (int)cudaGetLastError();
}

extern "C" int honerf_fine_bwd_rev(const float* pts, int M, const float* rotT, const float* off,
                                   const float* cut, int vL, int rL, const float* packed,
                                   const float* dsdf, const float* dg, const float* dx, int ldx,
                                   int Ep, int F, int Fp, int L, __nv_bfloat16* du_b,
                                   __nv_bfloat16* du_s, int lddu, float* dgt, float* dzf,
                                   __nv_bfloat16* dzb, int lddz, int Op, cudaStream_t stream) {
  return honerf_fine_bwd_rev_t(pts, M, rotT, off, cut, vL, rL, packed, dsdf, dg, dx, ldx, Ep, F,
                               Fp, L, du_b, du_s, lddu, dgt, dzf, dzb, lddz, Op, stream);
}

extern "C" int honerf_fine_bwd_rev_f32(const float* pts, int M, const float* rotT,
                                       const float* off, const float* cut, int vL, int rL,
                                       const float* packed, const float* dsdf, const float* dg,
                                       const float* dx, int ldx, int Ep, int F, int Fp, int L,
                                       float* du_b, float* du_s, int lddu, float* dgt,
                                       float* dzf, float* dzb, int lddz, int Op,
                                       cudaStream_t stream) {
  return honerf_fine_bwd_rev_t(pts, M, rotT, off, cut, vL, rL, packed, dsdf, dg, dx, ldx, Ep, F,
                               Fp, L, du_b, du_s, lddu, dgt, dzf, dzb, lddz, Op, stream);
}

// out[:256] (+)= the column sums of the pose rows P[:M, :256] in
// pose_sum_kernel's order, one launch of ceil(M / split) blocks; ws holds
// their partial rows (the wrapper checks its size).  Refused
// (cudaErrorInvalidValue): split <= 0, P or ws off a 16-byte boundary.
extern "C" int honerf_pose_sum(const float* P, int M, int split, float* ws, float* out, int acc,
                               cudaStream_t stream) {
  if (split <= 0 || honerf_misaligned16(P) || honerf_misaligned16(ws))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  honerf::pose_sum_kernel<<<(M + split - 1) / split, honerf::PS_THREADS, 0, stream>>>(
      P, M, split, ws, out, acc);
  return (int)cudaGetLastError();
}

extern "C" int honerf_fine_bwd_emb(const float* pts, int M, const float* rotT, const float* off,
                                   const float* cut, int vL, int rL, const float* u, int ldu,
                                   const float* dgt, const float* de, int ldde, const float* dx,
                                   int ldx, float* dp, float* P, cudaStream_t stream) {
  if (M > 0)
    honerf::fine_bwd_emb_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
        pts, M, rotT, off, cut, vL, rL, u, ldu, dgt, de, ldde, dx, ldx, dp, P);
  return (int)cudaGetLastError();
}
