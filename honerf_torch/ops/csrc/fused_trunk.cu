// Hand trunk + u-chain from a given embedding, forward (K5) and its
// second-order VJP (K6) (ops/fused_fine.py: hand_trunk_sdf_u).
//
// Replaces: the two Pallas kernels of honerf_tpu/ops/fused_fine.py that
//   `hand_trunk_sdf_u` runs (`_fwd_call` pallas_call, line 452, body
//   `_kernel_fwd_body`; `_bwd_call` pallas_call, line 488, body
//   `_trunk_bwd_block`), the fine pass of `train.fused_fine = 'pallas'`.
//
// Bound on an H100: operations, narrowly.  K5 does ~4.8 MFLOP of bf16
//   matmul a point at the flagship width (the trunk and the transposed
//   u-chain) against ~12.1 KB a point of f32 in and out (e and u, 1386
//   columns each, and the 257 outputs): ~400 FLOP/B against the card's
//   ~295, a floor of ~4.9 ms per million points.  K6 does ~12.9 MFLOP a
//   point: each product's transpose and dW (twice K5's operations), and
//   the forward recomputed without the products whose outputs it is given
//   the cotangents of (the last layer; the u-chain's embedding columns, at
//   layer 0 and the skip), against ~17.7 KB a point (e, dout, du in, de
//   out): ~13.0 ms per million points.
//
// Design: the TPU kernels kept a block's activations, sigmoid rows and
//   u-chain in VMEM.  Here, as for K2 and K3, the op is a sequence of
//   launches over a bounded global scratch (the wrapper's CHUNK of points),
//   and it is K2's and K3's trunk launches with other inputs and outputs:
//     trunk_pack_e_kernel          f32 e -> the bf16 GEMM operand, rounded
//                                  once and zero-padded to Ep columns (a
//                                  warp a row, 16-byte stores; its note)
//     hand_trunk_fwd_kernel (K5)   the whole trunk, the sigmoid rows out; the
//                                  last layer stores z whole into `out`
//     hand_uchain_kernel           the whole u-chain -> u (scratch), then
//                                  (both in csrc/trunk_fused.cu: a tile's
//                                  activations and t rows in shared memory)
//     copy_cols_kernel             u out at E columns
//   K6 reruns the forward keeping every activation, sigmoid, t and c row
//   (without the last layer and the u-chain's embedding columns, whose
//   outputs it does not read: the same two launches), then
//     trunk_bwd_seed_kernel        dout -> the top dz (f32 and bf16); du ->
//                                  bf16(du) and bf16(du / sqrt2), rounded
//                                  once from f32 as the JAX kernel does
//     gemm (EPI_UT) x 8            u-chain transposed, upward
//     gemm (EPI_DZ) x 9            forward transposed, downward, with the
//                                  second-order term ds beta s (1 - s)
//     gemm_tn_kernel, colsum       dW, db split over points, fixed-order sums
//     copy_cols_kernel             de out at E columns
//   The scratch traffic is that of K2/K3's trunk; K6's backward GEMMs bound
//   it (PERF.md).
//
// f32 mode (TrunkMeta.dtype 'f32', the confs' trunks as written; JAX's
//   e_dtype f32): the same launches on f32 operands, the forward and the
//   u-chain split as one gemm_f32_kernel a layer after uchain_seed_kernel
//   (trunk.cuh): the pack and seed kernels' f32 variants (a zero-padded
//   copy of e; dzb, du_b, du_s in f32), every product by gemm_f32_kernel
//   (common.cuh) and every dW by
//   gemm_tn_f32_kernel (trunk.cuh), 3xTF32 on the tensor cores at 165
//   TFLOP/s of f32 work: K5 ~29 ms and K6 ~78 ms per million points at
//   that peak.  A pass takes at most half the bf16 chunk's points, so the
//   scratch's bytes stay the same; dW accumulates across passes in f32 as
//   in bf16.

#include "trunk.cuh"

namespace honerf {

// ---------------------------------------------------------------------------
// The pack of e: K5 / K6's GEMM operand, jnp.pad(e, ...).astype(_cast(meta))
// (honerf_tpu/ops/fused_fine.py:527 for the forward, :550 for the VJP), the
// operand of the pallas_calls at :452 and :488
// ---------------------------------------------------------------------------
//
// out[m, c] = T(e[m, c]) for c < E, 0 for E <= c < width (T: bf16, or f32
// in the f32 mode: a zero-padded copy).
//
// Bound on an H100: bytes, e read once (4 E bytes a row) and out written
// once (width x sizeof(T)): a bf16 'pallas' step's two launches of 56,448
// rows (E 1386, width 1408) move 0.94 GB, 0.28 ms at 3.35 TB/s.
//
// Design: rows are handed whole to warps in a grid-stride loop over a
// persistent grid (as many blocks as are resident), with no integer
// division in the loop.  A row is a run of vectors of one 16-byte store
// each (8 bf16 columns, or 4 f32), vector i on lane i % 32, so a warp's
// stores are 512 contiguous bytes: each lane converts its vector's f32
// columns and stores them at once.  The source rows are 4 E bytes apart
// (5,544 at E 1386: every other row only 8-byte aligned), so each row
// loads in pieces as wide as its own alignment allows (16, 8 or 4 bytes:
// copy_load4), a batch of vectors in flight a lane before their stores
// (one batch covers a row of up to PK_BATCH columns).  The vector that
// straddles E loads its columns below E one by one and zeros the rest;
// the vectors past it are zeros, written by the same stores.  One f32 ->
// T rounding an element, as before the redesign: out keeps its bits.
// ops/perpoint_layout.py (pack_plan, pack_columns) mirrors the plan; the
// C entry point refuses a misaligned out, rows of out not a multiple of 16
// bytes apart, a width not a multiple of PK_VEC, strides or a width below
// E.
constexpr int PK_THREADS = 256;
constexpr int PK_WARPS = PK_THREADS / 32;
constexpr int PK_VEC = 8;
constexpr int PK_BATCH = 1536;

// The columns of a lane's vector: one 16-byte store of the type.
template <typename T>
struct PackVec {
  static constexpr int value = 16 / (int)sizeof(T);
};

// The widest load piece (bytes) that a row starting at address a allows.
__device__ __forceinline__ int pack_load_bytes(uintptr_t a) {
  return a % 16 == 0 ? 16 : (a % 8 == 0 ? 8 : 4);
}

// A vector at d (16-byte aligned) in one 16-byte store: 8 bf16, or 4 f32.
__device__ __forceinline__ void pack_store(__nv_bfloat16* __restrict__ d, const float (&x)[8]) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __halves2bfloat162(from_f32<__nv_bfloat16>(x[2 * j]),
                                                from_f32<__nv_bfloat16>(x[2 * j + 1]));
    w[j] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void pack_store(float* __restrict__ d, const float (&x)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
}

// One row of `width` columns: vectors of V columns, s in LB-byte pieces,
// vector i on lane i % 32, in batches of U vectors a lane whose loads are
// all in flight before the first store.
template <typename T, int LB>
__device__ __forceinline__ void pack_row(const float* __restrict__ s, T* __restrict__ d, int E,
                                         int width, int lane) {
  constexpr int V = PackVec<T>::value, U = PK_BATCH / (32 * V);
  const int nfull = E / V, nv = width / V;   // vectors wholly below E, in the row
  for (int i0 = lane; i0 < nv; i0 += 32 * U) {
    float x[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = i0 + 32 * u;
      if (v < nfull) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 a = copy_load4<float, LB>(s + V * (size_t)v + 4 * q);
          x[u][4 * q] = a.x, x[u][4 * q + 1] = a.y, x[u][4 * q + 2] = a.z, x[u][4 * q + 3] = a.w;
        }
      } else {   // the vector that straddles E, the padding, past the row
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = V * v + j;
          x[u][j] = c < E ? s[c] : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = i0 + 32 * u;
      if (v >= nv) break;
      pack_store(d + V * (size_t)v, x[u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(PK_THREADS)
    trunk_pack_e_kernel(const float* __restrict__ e, int lde, int M, int E, T* __restrict__ out,
                        int ldo, int width) {
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x * PK_WARPS + (threadIdx.x >> 5); m < M; m += gridDim.x * PK_WARPS) {
    const float* s = e + (size_t)m * lde;
    T* d = out + (size_t)m * ldo;
    const int lb = pack_load_bytes(reinterpret_cast<uintptr_t>(s));
    if (lb == 16)
      pack_row<T, 16>(s, d, E, width, lane);
    else if (lb == 8)
      pack_row<T, 8>(s, d, E, width, lane);
    else
      pack_row<T, 4>(s, d, E, width, lane);
  }
}

// Columns c < Op of a row: dzf = dout (0 past d_out), dzb = T(dzf);
// columns Op + c, c < Ep: du_b = T(du), du_s = T(du * (1/sqrt2)) (0 past
// E), each rounded once from f32 as the JAX kernel does.
template <typename T>
__global__ void trunk_bwd_seed_kernel(const float* __restrict__ dout, int ld_dout, int d_out,
                                      const float* __restrict__ du, int ld_du, int E, int M,
                                      float* __restrict__ dzf, T* __restrict__ dzb,
                                      int lddz, int Op, T* __restrict__ du_b,
                                      T* __restrict__ du_s, int lddu, int Ep) {
  const int width = Op + Ep;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * width) return;
  int m = (int)(i / width), c = (int)(i % width);
  if (c < Op) {
    float v = c < d_out ? dout[(size_t)m * ld_dout + c] : 0.f;
    dzf[(size_t)m * lddz + c] = v;
    dzb[(size_t)m * lddz + c] = from_f32<T>(v);
  } else {
    c -= Op;
    float v = c < E ? du[(size_t)m * ld_du + c] : 0.f;
    du_b[(size_t)m * lddu + c] = from_f32<T>(v);
    du_s[(size_t)m * lddu + c] = from_f32<T>(v * kInvSqrt2);
  }
}

}  // namespace honerf

// out[:M, :width] = T(e[:M, :E]) zero-padded to width; refused
// (cudaErrorInvalidValue) where the vector stores or the row plan do not
// fit: out off a 16-byte boundary, ldo x sizeof(T) not a multiple of 16,
// width not a multiple of PK_VEC, ldo below width, lde or width below E,
// e off its own alignment.
template <typename T>
static int honerf_trunk_pack_e_t(const float* e, int lde, int M, int E, T* out, int ldo,
                                 int width, cudaStream_t stream) {
  if (M < 0 || E < 0 || lde < E || width < E || width % honerf::PK_VEC || ldo < width ||
      (ldo * (int)sizeof(T)) % 16 || honerf_misaligned16(out) ||
      reinterpret_cast<uintptr_t>(e) % sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || width == 0) return (int)cudaGetLastError();
  static int resident = 0;  // blocks of the kernel an SM holds, asked once
  if (!resident) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, honerf::trunk_pack_e_kernel<T>, honerf::PK_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (resident < 1) resident = 1;
  }
  const int need = (M + honerf::PK_WARPS - 1) / honerf::PK_WARPS;
  const int slots = resident * honerf::wg::sm_count();
  honerf::trunk_pack_e_kernel<T><<<need < slots ? need : slots, honerf::PK_THREADS, 0, stream>>>(
      e, lde, M, E, out, ldo, width);
  return (int)cudaGetLastError();
}

extern "C" int honerf_trunk_pack_e(const float* e, int lde, int M, int E, __nv_bfloat16* out,
                                   int ldo, int width, cudaStream_t stream) {
  return honerf_trunk_pack_e_t(e, lde, M, E, out, ldo, width, stream);
}

extern "C" int honerf_trunk_pack_e_f32(const float* e, int lde, int M, int E, float* out,
                                       int ldo, int width, cudaStream_t stream) {
  return honerf_trunk_pack_e_t(e, lde, M, E, out, ldo, width, stream);
}

template <typename T>
static int honerf_trunk_bwd_seed_t(const float* dout, int ld_dout, int d_out, const float* du,
                                   int ld_du, int E, int M, float* dzf, T* dzb, int lddz, int Op,
                                   T* du_b, T* du_s, int lddu, int Ep, cudaStream_t stream) {
  size_t n = (size_t)M * (Op + Ep);
  if (n)
    honerf::trunk_bwd_seed_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        dout, ld_dout, d_out, du, ld_du, E, M, dzf, dzb, lddz, Op, du_b, du_s, lddu, Ep);
  return (int)cudaGetLastError();
}

extern "C" int honerf_trunk_bwd_seed(const float* dout, int ld_dout, int d_out, const float* du,
                                     int ld_du, int E, int M, float* dzf, __nv_bfloat16* dzb,
                                     int lddz, int Op, __nv_bfloat16* du_b, __nv_bfloat16* du_s,
                                     int lddu, int Ep, cudaStream_t stream) {
  return honerf_trunk_bwd_seed_t(dout, ld_dout, d_out, du, ld_du, E, M, dzf, dzb, lddz, Op, du_b,
                                 du_s, lddu, Ep, stream);
}

extern "C" int honerf_trunk_bwd_seed_f32(const float* dout, int ld_dout, int d_out,
                                         const float* du, int ld_du, int E, int M, float* dzf,
                                         float* dzb, int lddz, int Op, float* du_b, float* du_s,
                                         int lddu, int Ep, cudaStream_t stream) {
  return honerf_trunk_bwd_seed_t(dout, ld_dout, d_out, du, ld_du, E, M, dzf, dzb, lddz, Op, du_b,
                                 du_s, lddu, Ep, stream);
}
