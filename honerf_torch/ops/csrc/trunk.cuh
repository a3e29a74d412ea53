// Device code of the 9-layer hand trunk shared by the fine-pass kernels
// (fused_fine_full.cu K2, fused_fine_bwd.cu K3, fused_trunk.cu K5/K6):
//
//  * uchain_seed_kernel: the u-chain's first step, against the one-hot sdf
//    column: persistent blocks, each thread on 8 consecutive columns of a
//    row (16-byte loads and stores), the column's coefficients read once;
//  * gemm_tn_kernel + reduce_partials_kernel: dW = X^T Y over the point
//    axis, split over points into f32 partials summed in a fixed order
//    (the mainloop: wgmma.cuh, both operands MN-major);
//  * gemm_tn_f32_kernel: the same split product on f32 operands (the f32
//    trunk mode), 3xTF32 on the tensor cores with gemm_f32_kernel's
//    mainloop and cp.async ring (common.cuh: why three TF32 products are
//    the f32 function within ~1e-6 and one is not);
//  * colsum_partial_kernel: column sums (db), in one launch: each block
//    sums a row range of a 128-column tile into an f32 partial, and the
//    tile's last block to finish sums the partials, each step in a fixed
//    order (ops/fused_fine.py: colsum_ordered_plain states it);
//  * copy_cols_kernel: the first `width` columns of a padded scratch row
//    into an unpadded f32 output row, a warp a row: a scalar head up to
//    the destination's first 16-byte boundary, a body of 16-byte stores
//    with loads as wide as the source's alignment allows, a scalar tail.
//
// No atomics in any sum: two runs give the same bits.  (The column sum's
// last-block counter is an atomic increment that picks which block sums
// the partials; it orders no addition.)

#pragma once

#include "common.cuh"

namespace honerf {

constexpr float kInvSqrt2 = 0.70710678118654752f;

// ---------------------------------------------------------------------------
// The u-chain's seed (the first step of the u-chain in the bodies of K5,
// honerf_tpu/ops/fused_fine.py:452, and of K2 / K3 / K6)
// ---------------------------------------------------------------------------
//
// t[m, j] = T(W_last[j, 0] * s[m, j]) for j < width: the first u-chain step,
// whose input is the one-hot sdf column; the f32 trunk's (T = f32: the
// bf16 trunk seeds its chain in hand_uchain_kernel's prologue,
// csrc/trunk_fused.cu).
//
// Bound on an H100: bytes, s read once (4 B) and t written once
// (sizeof(T)) an element: an f32 request's 16 launches of 32,768 x 256
// are 0.320 ms at 3.35 TB/s.
//
// Design: each thread owns US_VEC = 8 consecutive columns of a row (two
// float4 loads of s, two float4 stores of t) and holds their 8
// coefficients W_last[j, 0] in registers, read
// once; a block covers US_THREADS / (width / 8) rows a step and walks the
// rows in a grid-stride loop over a persistent grid (US_BLOCKS_PER_SM
// blocks a SM).  No integer division in the loop.  One f32 product
// rounded once to T, as before the redesign: t keeps its bits.
// Preconditions (the C entry point and the wrapper refuse the rest):
// 16-byte-aligned s and t, width and ldt multiples of 8, width <=
// US_WIDTH_MAX; s's rows are `width` apart.
constexpr int US_THREADS = 256;
constexpr int US_BLOCKS_PER_SM = 8;
constexpr int US_VEC = 8;
constexpr int US_WIDTH_MAX = US_VEC * US_THREADS;

template <typename T>
__global__ void __launch_bounds__(US_THREADS)
    uchain_seed_kernel(const T* __restrict__ w, int ldw, const float* __restrict__ s, int width,
                       int M, T* __restrict__ t, int ldt) {
  const int vecs = width / US_VEC;           // threads a row
  const int rows = US_THREADS / vecs;        // rows a block step
  const int r = threadIdx.x / vecs, j0 = (threadIdx.x - r * vecs) * US_VEC;
  if (r >= rows) return;
  float c[US_VEC];
#pragma unroll
  for (int i = 0; i < US_VEC; ++i) c[i] = to_f32(w[(size_t)(j0 + i) * ldw]);
  for (int m = blockIdx.x * rows + r; m < M; m += gridDim.x * rows) {
    float v[US_VEC];
    load_f32x8(s + (size_t)m * width + j0, v);
#pragma unroll
    for (int i = 0; i < US_VEC; ++i) v[i] = c[i] * v[i];
    store8(t + (size_t)m * ldt + j0, v);
  }
}

// ---------------------------------------------------------------------------
// dW = X^T Y over the point axis (TN GEMM), split over points
// ---------------------------------------------------------------------------

// Work unit (tile, s): the BM x BN_TN tile of rows ti*BM.. of X's columns
// and columns to*BN_TN.. of Y's, summed over points [s*split, (s+1)*split), into
// its own f32 partial ws[s] (Kpad x Npad, row stride ldws).  The point axis
// is the K of the product: X and Y land as [point][column] boxes and are
// read as MN-major wgmma operands (wgmma.cuh), so neither is transposed.
struct TnArgs {
  const __nv_bfloat16* X; int ldx; int K;   // X (M, K)
  float x_scale;                            // != 0: X -> bf16(X * x_scale)
  const __nv_bfloat16* Y; int ldy; int N;   // Y (M, N)
  int M, split;
  float* ws; int ldws; size_t ws_stride;
};

// The whole 128 x 128 tile into the split's partial, straight from the
// accumulators (acc[4j + q]: row g + 8 (q >> 1), column 8j + 2t + (q & 1)).
struct TnEpilogue {
  const TnArgs& p;
  __device__ __forceinline__ void operator()(float (&acc)[wg::BN_TN / 2], const wg::Unit& w,
                                             int c, float*) const {
    const int lane = threadIdx.x & 31;
    const int row = w.r0 + 64 * c + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    float* out = p.ws + (size_t)w.s * p.ws_stride + (size_t)row * p.ldws + w.c0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < wg::BN_TN / 8; ++j) {
      *reinterpret_cast<float2*>(out + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(out + 8 * (size_t)p.ldws + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

__global__ void __launch_bounds__(wg::THREADS, 1)
    gemm_tn_kernel(const __grid_constant__ wg::GemmMaps maps, const TnArgs p) {
  wg::mainloop<true>(maps, p.x_scale, TnEpilogue{p});
}

// The f32 mode's dW: gemm_tn_kernel's split over points and partials on f32
// operands, in 128 x 128 blocks (block (ti, to, s) is the tile at rows
// ti*128.., columns to*128.., points [s*split, (s+1)*split)), 3xTF32 on
// the tensor cores (common.cuh: mma_step_3xtf32).  Point steps of F_BK
// through gemm_f32_kernel's cp.async ring (f32_ring): X's 32 x 128 and Y's
// 32 x 128 slices land as [point][i] and [point][o], read as a [k][m] A
// tile and a [k][n] B tile.  x_scale != 0 multiplies X's fragment elements by it
// before the split (the skip concat's f32 1/sqrt2, no other rounding).
struct TnF32Args {
  const float* X; int ldx; int K;   // X (M, K)
  float x_scale;
  const float* Y; int ldy; int N;   // Y (M, N)
  int M, split;
  float* ws; int ldws; size_t ws_stride;
};

__device__ __forceinline__ void tn_f32_load_stage(const TnF32Args& p, float* Xs, float* Ys,
                                                  int i0, int o0, int mk, int m_end, int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    int c = tid + it * THREADS;
    int row = c >> 5, col = (c & 31) * 4;
    int gm = mk + row;
    bool vx = gm < m_end && i0 + col < p.K;
    bool vy = gm < m_end && o0 + col < p.N;
    cp_async16(&Xs[row * FK_LD + col], vx ? p.X + (size_t)gm * p.ldx + i0 + col : p.X, vx);
    cp_async16(&Ys[row * FK_LD + col], vy ? p.Y + (size_t)gm * p.ldy + o0 + col : p.Y, vy);
  }
}

__global__ void __launch_bounds__(THREADS, 1) gemm_tn_f32_kernel(TnF32Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [F_STAGES][F_BK][FK_LD]
  float* Ys = Xs + F_STAGES * FK_STAGE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * BM, o0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * p.split;
  const int m_end = min(p.M, m0 + p.split);
  const int KT = m_end > m0 ? (m_end - m0 + F_BK - 1) / F_BK : 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto load = [&](int kt, int slot) {
    tn_f32_load_stage(p, Xs + slot * FK_STAGE, Ys + slot * FK_STAGE, i0, o0, m0 + kt * F_BK,
                      m_end, tid);
  };
  const float* x = Xs + t * FK_LD + wm * 64 + g;
  const float* y = Ys + t * FK_LD + wn * 32 + g;
  if (p.x_scale != 0.f)
    f32_ring(KT, load, [&](int slot) {
      mma_step_3xtf32<1, FK_LD, true>(acc, x + slot * FK_STAGE, y + slot * FK_STAGE, p.x_scale);
    });
  else
    f32_ring(KT, load, [&](int slot) {
      mma_step_3xtf32<1, FK_LD, false>(acc, x + slot * FK_STAGE, y + slot * FK_STAGE, 1.f);
    });
  // the whole 128 x 128 tile into this split's partial (Kpad x Npad)
  float* out = p.ws + blockIdx.z * p.ws_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (size_t)(i0 + wm * 64 + i * 16 + g + h * 8) * p.ldws +
                                   o0 + wn * 32 + j * 8 + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// out[i, o] = (acc ? out[i, o] : 0) + sum_s ws[s][i, o] in order s = 0, 1, ...
__global__ void reduce_partials_kernel(const float* __restrict__ ws, int S, size_t ws_stride,
                                       int ldws, int K, int N, float* __restrict__ out,
                                       int ldo, int acc) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)K * N) return;
  int i = (int)(idx / N), o = (int)(idx % N);
  const float* src = ws + (size_t)i * ldws + o;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += src[s * ws_stride];
  float* dst = out + (size_t)i * ldo + o;
  *dst = acc ? *dst + sum : sum;
}

// ---------------------------------------------------------------------------
// Column sums: db = sum over the points of dz (K3's and K6's db,
// honerf_tpu/ops/fused_fine_full.py:1650 and honerf_tpu/ops/fused_fine.py:488)
// ---------------------------------------------------------------------------
//
// out[:N] (+)= sum over rows of Z[:M, :N], f32, in a fixed order.
//
// Bound on an H100: bytes, M x N x 4 read once (a bf16 step's 56,448 x 256
// launch: 57.8 MB, ~17 us at 3.35 TB/s).
//
// Design: a block of CS_THREADS (8 warps) owns CS_COLS = 128 columns (a
// warp reads a row's 512 bytes as 32 float4) and `split` rows, a multiple
// of CS_ROW_STEP.  Each thread owns 4 adjacent columns and CS_ACC row
// accumulators, so four loads a thread are in flight: in the rows
// [s*split, min(M, (s+1)*split)) of block s, step i, accumulator k of warp
// w adds row s*split + CS_ROW_STEP i + CS_WARPS k + w.  Then, in order: a
// thread's sum (a0 + a1) + (a2 + a3); the block's partial t0 + t1 + ... +
// t7 over the warps (through shared memory) into ws[s]; the tile's last
// block (an atomic ticket, colsum_done, which wraps to 0 for the next
// launch) sums the S partials, warp w those with s = w mod 8 in order,
// then the eight warp sums in order, and out = (acc ? out : 0) + that.
// The host picks split for ~CS_BLOCKS blocks (two a SM).  Preconditions:
// N and ldz multiples of 4, a 16-byte-aligned Z, N <= CS_COLS x
// CS_MAX_TILES; launches of one process run on one stream at a time (the
// tickets are the library's).
constexpr int CS_THREADS = 256;
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_COLS = 128;
constexpr int CS_ACC = 4;
constexpr int CS_ROW_STEP = CS_WARPS * CS_ACC;
constexpr int CS_BLOCKS = 264;
constexpr int CS_MAX_TILES = 64;

__device__ unsigned int colsum_done[CS_MAX_TILES];

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(CS_THREADS)
    colsum_partial_kernel(const float* __restrict__ Z, int ldz, int N, int M, int split,
                          float* __restrict__ ws, float* __restrict__ out, int acc) {
  __shared__ float4 red[CS_WARPS][32];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = gridDim.x, s = blockIdx.x, tile = blockIdx.y;
  const int col = tile * CS_COLS + 4 * lane;
  const bool live = col < N;
  const int r0 = s * split, r1 = min(M, r0 + split);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a[CS_ACC];
#pragma unroll
  for (int k = 0; k < CS_ACC; ++k) a[k] = zero;
  if (live) {
    const float* zc = Z + col;
#pragma unroll 2
    for (int base = r0; base < r1; base += CS_ROW_STEP) {
      float4 v[CS_ACC];
#pragma unroll
      for (int k = 0; k < CS_ACC; ++k) {
        const int r = base + CS_WARPS * k + warp;
        v[k] = r < r1 ? __ldg(reinterpret_cast<const float4*>(zc + (size_t)r * ldz)) : zero;
      }
#pragma unroll
      for (int k = 0; k < CS_ACC; ++k) a[k] = add4(a[k], v[k]);
    }
  }
  red[warp][lane] = add4(add4(a[0], a[1]), add4(a[2], a[3]));
  __syncthreads();
  if (warp == 0 && live) {
    float4 t = red[0][lane];
#pragma unroll
    for (int w = 1; w < CS_WARPS; ++w) t = add4(t, red[w][lane]);
    *reinterpret_cast<float4*>(ws + (size_t)s * N + col) = t;
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&colsum_done[tile], (unsigned)(S - 1)) == (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  float4 q = zero;
  if (live) {
#pragma unroll 4
    for (int t = warp; t < S; t += CS_WARPS)
      q = add4(q, __ldcg(reinterpret_cast<const float4*>(ws + (size_t)t * N + col)));
  }
  red[warp][lane] = q;
  __syncthreads();
  if (warp == 0 && live) {
    float4 tot = red[0][lane];
#pragma unroll
    for (int w = 1; w < CS_WARPS; ++w) tot = add4(tot, red[w][lane]);
    float* o = out + col;
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

// ---------------------------------------------------------------------------
// The padded-row copy (no TPU kernel: the port's glue where the Pallas
// bodies of K2 / K3 no-color, honerf_tpu/ops/fused_fine_full.py:1556 and
// :1650, and of K5 / K6, honerf_tpu/ops/fused_fine.py:452 and :488, write
// these columns themselves)
// ---------------------------------------------------------------------------
//
// dst[m, c] = f32(src[m, c]) for c < width (src f32 or bf16, dst f32).
//
// Bound on an H100: bytes, each source element read once and each f32
// written once: a 'full_nocolor' step's four calls (e 1386 bf16 -> f32,
// de 1386 f32, dfeat 256 f32, dsdf 1, 56,448 rows each) move 1.21 GB,
// 0.36 ms at 3.35 TB/s.
//
// Design: rows are handed whole to warps in a grid-stride loop over a
// persistent grid (as many blocks as are resident), with no integer
// division per element.  The row strides are odd (lds 1386, 257; ldd
// 1386), so each row has its own alignment: copy_plan takes, per row, a
// scalar head of h < 4 columns up to the destination's first 16-byte
// boundary, then a body of 4-column vectors, lane i on vector i % 32:
// each stored as one 16-byte f32 store (a warp's stores are 512
// contiguous bytes) and loaded in pieces as wide as the source's
// alignment at column h allows (f32: 16, 8 or 4 bytes; bf16: 8, 4 or 2;
// the pieces of a warp's load are contiguous too), CP_UNROLL vectors in
// flight a lane before their stores; then a scalar tail of fewer than 4.
// Rows of at most CP_NARROW columns (dsdf, width 1) take a thread a row.
// A copy, so the output keeps every bit.  ops/perpoint_layout.py
// (copy_plan, copy_columns) mirrors the plan; the C entry point refuses
// elements off their own alignment and strides below the width.
constexpr int CP_THREADS = 256;
constexpr int CP_WARPS = CP_THREADS / 32;
constexpr int CP_NARROW = 8;
constexpr int CP_UNROLL = 8;

// The row's plan: h, the head's columns up to the destination's first
// 16-byte boundary (-1 where no whole vector follows it), and lb, the
// bytes of each piece the source's alignment at column h allows.
template <typename T>
__device__ __forceinline__ void copy_plan(uintptr_t s, uintptr_t d, int width, int& h, int& lb) {
  h = (int)((16 - d % 16) % 16 / 4);
  if (h + 4 > width) {
    h = -1;
    lb = (int)sizeof(T);
    return;
  }
  const uintptr_t sh = s + sizeof(T) * (uintptr_t)h;
  lb = 4 * (int)sizeof(T);
  while (lb > (int)sizeof(T) && sh % lb) lb /= 2;
}

// 4 columns from s in pieces of LB bytes, as f32.
template <typename T, int LB>
__device__ __forceinline__ float4 copy_load4(const T* __restrict__ s) {
  if constexpr (sizeof(T) == 4 && LB == 16) {
    return *reinterpret_cast<const float4*>(s);
  } else if constexpr (sizeof(T) == 4 && LB == 8) {
    const float2 a = reinterpret_cast<const float2*>(s)[0], b = reinterpret_cast<const float2*>(s)[1];
    return make_float4(a.x, a.y, b.x, b.y);
  } else if constexpr (sizeof(T) == 2 && LB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(s);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
  } else if constexpr (sizeof(T) == 2 && LB == 4) {
    const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(s)[0];
    const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(s)[1];
    return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
  } else {
    return make_float4(to_f32(s[0]), to_f32(s[1]), to_f32(s[2]), to_f32(s[3]));
  }
}

// The body: nb vectors of 4 columns, s in LB-byte pieces, d 16-byte
// aligned, vector i on lane i % 32, in batches of CP_UNROLL vectors a
// lane whose loads are all issued before the first store (the row's last
// batch predicated, so that it too keeps its loads in flight together).
template <typename T, int LB>
__device__ __forceinline__ void copy_body(const T* __restrict__ s, float* __restrict__ d, int nb,
                                          int lane) {
  float4* dv = reinterpret_cast<float4*>(d);
  for (int i0 = lane; i0 < nb; i0 += 32 * CP_UNROLL) {
    float4 x[CP_UNROLL];
#pragma unroll
    for (int u = 0; u < CP_UNROLL; ++u)
      if (i0 + 32 * u < nb) x[u] = copy_load4<T, LB>(s + 4 * (size_t)(i0 + 32 * u));
#pragma unroll
    for (int u = 0; u < CP_UNROLL; ++u) {
      if (i0 + 32 * u >= nb) break;
      dv[i0 + 32 * u] = x[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CP_THREADS) copy_cols_kernel(const T* __restrict__ src, int lds,
                                                               int M, int width,
                                                               float* __restrict__ dst, int ldd) {
  if (width <= CP_NARROW) {  // a thread a row
    for (int m = blockIdx.x * CP_THREADS + threadIdx.x; m < M; m += gridDim.x * CP_THREADS) {
      const T* s = src + (size_t)m * lds;
      float* d = dst + (size_t)m * ldd;
      for (int c = 0; c < width; ++c) d[c] = to_f32(s[c]);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x * CP_WARPS + (threadIdx.x >> 5); m < M; m += gridDim.x * CP_WARPS) {
    const T* s = src + (size_t)m * lds;
    float* d = dst + (size_t)m * ldd;
    int h, lb;
    copy_plan<T>(reinterpret_cast<uintptr_t>(s), reinterpret_cast<uintptr_t>(d), width, h, lb);
    if (h < 0) {  // no whole vector: all scalar
      for (int c = lane; c < width; c += 32) d[c] = to_f32(s[c]);
      continue;
    }
    if (lane < h) d[lane] = to_f32(s[lane]);
    const int nb = (width - h) / 4, t0 = h + 4 * nb;
    if (lb == 4 * (int)sizeof(T))
      copy_body<T, 4 * sizeof(T)>(s + h, d + h, nb, lane);
    else if (lb == 2 * (int)sizeof(T))
      copy_body<T, 2 * sizeof(T)>(s + h, d + h, nb, lane);
    else
      copy_body<T, sizeof(T)>(s + h, d + h, nb, lane);
    if (lane < width - t0) d[t0 + lane] = to_f32(s[t0 + lane]);
  }
}

}  // namespace honerf

// ---------------------------------------------------------------------------
// Plain C entry points (loaded with ctypes); each returns cudaGetLastError().
// ---------------------------------------------------------------------------

// t[:M, :width] = T(w[:width, 0] * s[:M, :width]); refused
// (cudaErrorInvalidValue) where the vector loads and stores do not fit.
template <typename T>
static int honerf_uchain_seed_t(const T* w, int ldw, const float* s, int width, int M, T* t,
                                int ldt, cudaStream_t stream) {
  if (width <= 0 || width % honerf::US_VEC || width > honerf::US_WIDTH_MAX ||
      ldt % honerf::US_VEC || ldt < width || honerf_misaligned16(s) || honerf_misaligned16(t))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaGetLastError();
  const int rows = honerf::US_THREADS / (width / honerf::US_VEC);
  const int steps = (M + rows - 1) / rows;
  const int slots = honerf::US_BLOCKS_PER_SM * honerf::wg::sm_count();
  honerf::uchain_seed_kernel<T><<<steps < slots ? steps : slots, honerf::US_THREADS, 0, stream>>>(
      w, ldw, s, width, M, t, ldt);
  return (int)cudaGetLastError();
}

extern "C" int honerf_uchain_seed_f32(const float* w, int ldw, const float* s, int width, int M,
                                      float* t, int ldt, cudaStream_t stream) {
  return honerf_uchain_seed_t(w, ldw, s, width, M, t, ldt, stream);
}

static inline int honerf_round_up(int x, int m) { return (x + m - 1) / m * m; }

// out[:K, :N] (+)= X[:M, :K]^T Y[:M, :N] in f32; ws holds the partials of
// ceil(M / split) point ranges (Kpad x Npad each, Kpad = K rounded up to
// wg::BM, Npad = N to wg::BN_TN).  The wrapper checks ws's size.
extern "C" int honerf_gemm_tn(const __nv_bfloat16* X, int ldx, int K, float x_scale,
                              const __nv_bfloat16* Y, int ldy, int N, int M, int split,
                              float* ws, float* out, int ldo, int acc, cudaStream_t stream) {
  namespace wg = honerf::wg;
  if (ldx % 8 || ldy % 8 || K % 8 || N % 8 || split % wg::BK || split <= 0 ||
      honerf_misaligned16(X) || honerf_misaligned16(Y))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaGetLastError();
  wg::GemmMaps g{};
  if (!wg::tma_map(&g.a1, X, K, M, ldx, wg::MN_CHUNK, wg::BK) ||
      !wg::tma_map(&g.b1, Y, N, M, ldy, wg::MN_CHUNK, wg::BK))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(honerf::gemm_tn_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wg::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int S = (M + split - 1) / split;
  const int Kp = honerf_round_up(K, wg::BM), Np = honerf_round_up(N, wg::BN_TN);
  g.tiles_n = Np / wg::BN_TN;
  g.tiles = Kp / wg::BM * g.tiles_n;
  g.units = g.tiles * S;
  g.M = M;
  g.split = split;
  honerf::TnArgs p{X, ldx, K, x_scale, Y, ldy, N, M, split, ws, Np, (size_t)Kp * Np};
  const int grid = g.units < wg::sm_count() ? g.units : wg::sm_count();
  honerf::gemm_tn_kernel<<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(g, p);
  size_t n = (size_t)K * N;
  honerf::reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ws, S, (size_t)Kp * Np, Np, K, N, out, ldo, acc);
  return (int)cudaGetLastError();
}

// The f32 mode's honerf_gemm_tn: out[:K, :N] (+)= (x_scale X)[:M, :K]^T
// Y[:M, :N], 3xTF32 products summed in f32, the same partials and
// fixed-order sum (16-byte aligned X and Y, split a multiple of F_BK).
extern "C" int honerf_gemm_tn_f32(const float* X, int ldx, int K, float x_scale, const float* Y,
                                  int ldy, int N, int M, int split, float* ws, float* out,
                                  int ldo, int acc, cudaStream_t stream) {
  if (ldx % 4 || ldy % 4 || K % 4 || N % 4 || split % honerf::F_BK || split <= 0 ||
      honerf_misaligned16(X) || honerf_misaligned16(Y))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaGetLastError();
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(honerf::gemm_tn_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           honerf::TN_F_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int S = (M + split - 1) / split;
  const int Kp = honerf_round_up(K, honerf::BM), Np = honerf_round_up(N, honerf::BN);
  honerf::TnF32Args p{X, ldx, K, x_scale, Y, ldy, N, M, split, ws, Np, (size_t)Kp * Np};
  dim3 grid(Kp / honerf::BM, Np / honerf::BN, S);
  honerf::gemm_tn_f32_kernel<<<grid, honerf::THREADS, honerf::TN_F_SMEM_BYTES, stream>>>(p);
  size_t n = (size_t)K * N;
  honerf::reduce_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      ws, S, (size_t)Kp * Np, Np, K, N, out, ldo, acc);
  return (int)cudaGetLastError();
}

// out[:N] (+)= the column sums of Z[:M, :N] (f32), in colsum_partial_kernel's
// order; ws holds the ceil(M / split) partials (N floats each; the wrapper
// checks its size), split a positive multiple of CS_ROW_STEP.
extern "C" int honerf_colsum(const float* Z, int ldz, int N, int M, int split, float* ws,
                             float* out, int acc, cudaStream_t stream) {
  if (N < 0 || N % 4 || ldz % 4 || ldz < N || N > honerf::CS_COLS * honerf::CS_MAX_TILES ||
      split <= 0 || split % honerf::CS_ROW_STEP || honerf_misaligned16(Z) ||
      honerf_misaligned16(ws))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N == 0) return (int)cudaGetLastError();
  dim3 grid((M + split - 1) / split, (N + honerf::CS_COLS - 1) / honerf::CS_COLS);
  honerf::colsum_partial_kernel<<<grid, honerf::CS_THREADS, 0, stream>>>(Z, ldz, N, M, split, ws,
                                                                         out, acc);
  return (int)cudaGetLastError();
}

// dst[:M, :width] = src[:M, :width] (f32 or bf16 source, f32 destination);
// refused (cudaErrorInvalidValue) where an element is off its own
// alignment or a row stride is below the width.
template <typename T>
static int honerf_copy_cols_t(const T* src, int lds, int M, int width, float* dst, int ldd,
                              cudaStream_t stream) {
  if (M < 0 || width < 0 || lds < width || ldd < width ||
      reinterpret_cast<uintptr_t>(src) % sizeof(T) || reinterpret_cast<uintptr_t>(dst) % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || width == 0) return (int)cudaGetLastError();
  static int resident = 0;  // blocks of the kernel an SM holds, asked once
  if (!resident) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, honerf::copy_cols_kernel<T>, honerf::CP_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) resident = 1;
  }
  const int per = width <= honerf::CP_NARROW ? honerf::CP_THREADS : honerf::CP_WARPS;
  const int need = (M + per - 1) / per, slots = resident * honerf::wg::sm_count();
  honerf::copy_cols_kernel<T><<<need < slots ? need : slots, honerf::CP_THREADS, 0, stream>>>(
      src, lds, M, width, dst, ldd);
  return (int)cudaGetLastError();
}

extern "C" int honerf_copy_cols(const float* src, int lds, int M, int width, float* dst,
                                int ldd, cudaStream_t stream) {
  return honerf_copy_cols_t(src, lds, M, width, dst, ldd, stream);
}

extern "C" int honerf_copy_cols_bf16(const __nv_bfloat16* src, int lds, int M, int width,
                                     float* dst, int ldd, cudaStream_t stream) {
  return honerf_copy_cols_t(src, lds, M, width, dst, ldd, stream);
}
