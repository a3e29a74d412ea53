// Device code of the 9-layer hand trunk shared by the fine-pass kernels
// (fused_fine_full.cu K2, fused_fine_bwd.cu K3, fused_trunk.cu K5/K6):
//
//  * uchain_seed_kernel: the u-chain's first step, against the one-hot sdf
//    column;
//  * gemm_tn_kernel + reduce_partials_kernel: dW = X^T Y over the point
//    axis, split over points into f32 partials summed in a fixed order
//    (the mainloop: wgmma.cuh, both operands MN-major);
//  * gemm_tn_f32_kernel: the same split product on f32 operands (the f32
//    trunk mode), 3xTF32 on the tensor cores with gemm_f32_kernel's
//    mainloop and cp.async ring (common.cuh: why three TF32 products are
//    the f32 function within ~1e-6 and one is not);
//  * colsum_partial_kernel: column sums (db, the pose sums), fixed order;
//  * copy_cols_kernel: the first `width` columns of a padded scratch row
//    into an unpadded f32 output row.
//
// No atomics: two runs give the same bits.

#pragma once

#include "common.cuh"

namespace honerf {

constexpr float kInvSqrt2 = 0.70710678118654752f;

// t[m, j] = T(W_last[j, 0] * s[m, j]): the first u-chain step, whose
// input is the one-hot sdf column (T: bf16, or f32 in the f32 mode).
template <typename T>
__global__ void uchain_seed_kernel(const T* __restrict__ w, int ldw,
                                   const float* __restrict__ s, int width, int M,
                                   T* __restrict__ t, int ldt) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * width) return;
  int m = (int)(i / width), j = (int)(i % width);
  float c = to_f32(w[(size_t)j * ldw]);
  t[(size_t)m * ldt + j] = from_f32<T>(c * s[(size_t)m * width + j]);
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

// ws[s, col] = sum of Z[row, col] over rows [s*split, (s+1)*split), in order.
__global__ void colsum_partial_kernel(const float* __restrict__ Z, int ldz, int N, int M,
                                      int split, float* __restrict__ ws) {
  int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= N) return;
  int r0 = blockIdx.x * split, r1 = min(M, r0 + split);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) sum += Z[(size_t)r * ldz + col];
  ws[(size_t)blockIdx.x * N + col] = sum;
}

// dst[m, c] = f32(src[m, c]) for c < width: a padded scratch row out into
// an unpadded output row.
template <typename T>
__global__ void copy_cols_kernel(const T* __restrict__ src, int lds, int M, int width,
                                 float* __restrict__ dst, int ldd) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * width) return;
  int m = (int)(i / width), c = (int)(i % width);
  dst[(size_t)m * ldd + c] = to_f32(src[(size_t)m * lds + c]);
}

}  // namespace honerf

// ---------------------------------------------------------------------------
// Plain C entry points (loaded with ctypes); each returns cudaGetLastError().
// ---------------------------------------------------------------------------

template <typename T>
static int honerf_uchain_seed_t(const T* w, int ldw, const float* s, int width, int M, T* t,
                                int ldt, cudaStream_t stream) {
  size_t n = (size_t)M * width;
  if (n) {
    honerf::uchain_seed_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        w, ldw, s, width, M, t, ldt);
  }
  return (int)cudaGetLastError();
}

extern "C" int honerf_uchain_seed(const __nv_bfloat16* w, int ldw, const float* s, int width,
                                  int M, __nv_bfloat16* t, int ldt, cudaStream_t stream) {
  return honerf_uchain_seed_t(w, ldw, s, width, M, t, ldt, stream);
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

// out[:N] (+)= the column sums of Z[:M, :N] (f32), in a fixed order.
extern "C" int honerf_colsum(const float* Z, int ldz, int N, int M, int split, float* ws,
                             float* out, int acc, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int S = (M + split - 1) / split;
  dim3 grid(S, (N + 127) / 128);
  honerf::colsum_partial_kernel<<<grid, 128, 0, stream>>>(Z, ldz, N, M, split, ws);
  honerf::reduce_partials_kernel<<<(N + 255) / 256, 256, 0, stream>>>(ws, S, (size_t)N, N, 1,
                                                                      N, out, N, acc);
  return (int)cudaGetLastError();
}

// dst[:M, :width] = src[:M, :width] (f32 or bf16 source, f32 destination).
extern "C" int honerf_copy_cols(const float* src, int lds, int M, int width, float* dst,
                                int ldd, cudaStream_t stream) {
  size_t n = (size_t)M * width;
  if (n)
    honerf::copy_cols_kernel<float><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        src, lds, M, width, dst, ldd);
  return (int)cudaGetLastError();
}

extern "C" int honerf_copy_cols_bf16(const __nv_bfloat16* src, int lds, int M, int width,
                                     float* dst, int ldd, cudaStream_t stream) {
  size_t n = (size_t)M * width;
  if (n)
    honerf::copy_cols_kernel<__nv_bfloat16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        src, lds, M, width, dst, ldd);
  return (int)cudaGetLastError();
}
