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
//                                  once and zero-padded to Ep columns
//     gemm_kernel x 9 (K5)         trunk, softplus/sigmoid epilogue; the last
//                                  layer stores z whole into `out`
//     uchain_seed_kernel + gemm x 8  u-chain -> u (scratch), then
//     copy_cols_kernel             u out at E columns
//   K6 reruns the forward keeping every activation, sigmoid, t and c row
//   (without the last layer and the u-chain's embedding columns, whose
//   outputs it does not read), then
//     trunk_bwd_seed_kernel        dout -> the top dz (f32 and bf16); du ->
//                                  bf16(du) and bf16(du / sqrt2), rounded
//                                  once from f32 as the JAX kernel does
//     gemm (EPI_UT) x 8            u-chain transposed, upward
//     gemm (EPI_DZ) x 9            forward transposed, downward, with the
//                                  second-order term ds beta s (1 - s)
//     gemm_tn_kernel, colsum       dW, db split over points, fixed-order sums
//     copy_cols_kernel             de out at E columns
//   The scratch traffic is that of K2/K3's trunk; the GEMMs bound both
//   (PERF.md).  Right first: wgmma/TMA and fused launches are later work.
//
// f32 mode (TrunkMeta.dtype 'f32', the confs' trunks as written; JAX's
//   e_dtype f32): the same launches on f32 operands: the pack and seed
//   kernels' f32 variants (a zero-padded copy of e; dzb, du_b, du_s in
//   f32), every product by gemm_f32_kernel (common.cuh) and every dW by
//   gemm_tn_f32_kernel (trunk.cuh), 3xTF32 on the tensor cores at 165
//   TFLOP/s of f32 work: K5 ~29 ms and K6 ~78 ms per million points at
//   that peak.  A pass takes at most half the bf16 chunk's points, so the
//   scratch's bytes stay the same; dW accumulates across passes in f32 as
//   in bf16.

#include "trunk.cuh"

namespace honerf {

// out[m, c] = T(e[m, c]) for c < E, 0 for E <= c < width (T: bf16, or
// f32 in the f32 mode: a zero-padded copy).
template <typename T>
__global__ void trunk_pack_e_kernel(const float* __restrict__ e, int lde, int M, int E,
                                    T* __restrict__ out, int ldo, int width) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * width) return;
  int m = (int)(i / width), c = (int)(i % width);
  float v = c < E ? e[(size_t)m * lde + c] : 0.f;
  out[(size_t)m * ldo + c] = from_f32<T>(v);
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

template <typename T>
static int honerf_trunk_pack_e_t(const float* e, int lde, int M, int E, T* out, int ldo,
                                 int width, cudaStream_t stream) {
  size_t n = (size_t)M * width;
  if (n)
    honerf::trunk_pack_e_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
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
