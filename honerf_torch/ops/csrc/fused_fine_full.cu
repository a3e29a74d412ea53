// Color-fused hand fine pass, forward (ops/fused_fine_full.py:
// hand_fine_color).
//
// Replaces: the forward Pallas kernel of honerf_tpu/ops/fused_fine_full.py
//   (`_fwd_call` pallas_call, body `_make_fwd_kernel` -> `_fine_fwd_block`)
//   that `hand_fine_color` runs for the bf16 fine pass.
//
// Bound on an H100: operations.  Per point ~6.1 MFLOP of bf16 matmul (the
//   trunk, the transposed u-chain matmuls and the color net) against 12
//   bytes in and 28 out; the floor is ~6.1 ms per million points at
//   989 TFLOP/s.
//
// Design: the TPU kernel held a block's embedding, eight f32 sigmoid rows
//   (8 KB/pt) and the u-chain in VMEM.  On Hopper a fused tile would hold
//   only ~16 points in 227 KB of shared memory, so the op runs as a short
//   sequence of launches over a bounded global scratch (the wrapper's
//   CHUNK, ~23 KB/pt):
//     hand_embed_kernel (common.cuh)   e, bf16
//     gemm_kernel x 9                  trunk; the epilogue writes the bf16
//                                      activation and s = sigmoid(beta z)
//     uchain_seed_kernel + gemm x 8    u-chain against the transposed
//                                      weights; the epilogue forms
//                                      t = bf16(c * s) and the u columns
//     fine_rev_kernel                  embedding reverse chain -> g, the
//                                      sdf, and the color net's feature and
//                                      grad-PE columns
//     gemm_kernel x 5                  color net (relu, then sigmoid into
//                                      the packed output)
//   The scratch traffic (~50 KB/pt) stays below the byte/FLOP balance of
//   the card at these widths; the GEMMs bound it (PERF.md).  Right first:
//   TMA/wgmma and fusing the launches are later work.
//
// f32 mode (FineMeta.dtype 'f32': the fitting stage's f32 trunks, JAX's
//   e_dtype f32 at honerf_tpu/ops/fused_fine_full.py:1532): e and every
//   activation, t row and color input row in f32; the trunk and u-chain in
//   two fused launches (trunk_fused_f32.cu), the color net in one
//   (color_fused_f32.cu: color_fwd_f32_kernel), all 3xTF32 on wgmma, the
//   f32 product within ~1e-6; no gemm_f32_kernel.  Bound: operations,
//   ~6.05 MFLOP a point at 165 TFLOP/s of f32 work (three TF32 products at
//   495 TFLOP/s), ~37 ms per million points; the scratch (~46 KB/pt) is
//   twice bf16's, so the wrapper passes at most half as many points
//   (balanced passes).  With and without the color net.
//
// No-color mode (`hand_fine_full`, the same pallas_call without the color
//   net): the same launches up to fine_rev_kernel, which then writes only
//   [sdf | g]; the last trunk layer stores z whole into the output and
//   copy_cols_kernel (trunk.cuh) copies e out at E columns.

#include "trunk.cuh"

namespace honerf {

// Reverse chain: g = (d e / d p)^T u, one warp per point, lane = bone.
// Writes packed[m] = [sdf | g | . . . | 0] (the color columns come from
// the last color layer) and x2[m] = [feat (Fp) | grad-PE blocks] in the
// operand type T (bf16, or f32 in the f32 mode).
template <typename T>
__global__ void fine_rev_kernel(const float* __restrict__ pts, int M,
                                const float* __restrict__ rotT, const float* __restrict__ off,
                                const float* __restrict__ cut, int vL, int rL,
                                const float* __restrict__ u, int ldu,
                                const float* __restrict__ z, int ldz, int F,
                                T* __restrict__ x2, int ldx, int Fp, int L,
                                float* __restrict__ packed) {
  int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int j = threadIdx.x & 31;
  if (m >= M) return;  // whole warps leave together
  float g[3] = {0.f, 0.f, 0.f};
  if (j < 21) {
    float p[3] = {pts[3 * m], pts[3 * m + 1], pts[3 * m + 2]};
    Stages st = bone_stages(p, rotT, off, cut, j);
    Chain c = rev_chain(st, u + (size_t)m * ldu, j, vL, rL);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {                        // R12
      int col = 3 * j + ch;
      g[0] += c.f_q[ch] * rotT[col];
      g[1] += c.f_q[ch] * rotT[kLane + col];
      g[2] += c.f_q[ch] * rotT[2 * kLane + col];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) g[a] += __shfl_xor_sync(0xffffffffu, g[a], o);
  const float* zr = z + (size_t)m * ldz;
  if (j == 0) {
    float* out = packed + (size_t)m * 8;
    out[0] = zr[0];
    out[1] = g[0];
    out[2] = g[1];
    out[3] = g[2];
    out[7] = 0.f;
  }
  if (!x2) return;  // the no-color mode has no color net to feed
  T* xr = x2 + (size_t)m * ldx;
  for (int col = j; col < Fp; col += 32) xr[col] = from_f32<T>(col < F ? zr[1 + col] : 0.f);
  const int nblk = 1 + 2 * L;
  for (int i = j; i < ldx - Fp; i += 32) {
    int blk = i >> 3, ch = i & 7;
    float val = 0.f;
    if (blk < nblk) {
      float gv = ch < 3 ? g[ch] : 0.f;
      if (blk == 0) val = gv;
      else if (blk <= L) val = sinf(gv * (float)(1 << (blk - 1)));
      else val = cosf(gv * (float)(1 << (blk - 1 - L)));
    }
    xr[Fp + i] = from_f32<T>(val);
  }
}

}  // namespace honerf

template <typename T>
static int honerf_fine_rev_t(const float* pts, int M, const float* rotT, const float* off,
                             const float* cut, int vL, int rL, const float* u, int ldu,
                             const float* z, int ldz, int F, T* x2, int ldx, int Fp, int L,
                             float* packed, cudaStream_t stream) {
  if (M > 0) {
    honerf::fine_rev_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(
        pts, M, rotT, off, cut, vL, rL, u, ldu, z, ldz, F, x2, ldx, Fp, L, packed);
  }
  return (int)cudaGetLastError();
}

extern "C" int honerf_fine_rev(const float* pts, int M, const float* rotT, const float* off,
                               const float* cut, int vL, int rL, const float* u, int ldu,
                               const float* z, int ldz, int F, __nv_bfloat16* x2, int ldx,
                               int Fp, int L, float* packed, cudaStream_t stream) {
  return honerf_fine_rev_t(pts, M, rotT, off, cut, vL, rL, u, ldu, z, ldz, F, x2, ldx, Fp, L,
                           packed, stream);
}

extern "C" int honerf_fine_rev_f32(const float* pts, int M, const float* rotT, const float* off,
                                   const float* cut, int vL, int rL, const float* u, int ldu,
                                   const float* z, int ldz, int F, float* x2, int ldx, int Fp,
                                   int L, float* packed, cudaStream_t stream) {
  return honerf_fine_rev_t(pts, M, rotT, off, cut, vL, rL, u, ldu, z, ldz, F, x2, ldx, Fp, L,
                           packed, stream);
}
