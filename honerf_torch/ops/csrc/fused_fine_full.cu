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

#include "common.cuh"

namespace honerf {

// t[m, j] = bf16(W_last[j, 0] * s[m, j]): the first u-chain step, whose
// input is the one-hot sdf column.
__global__ void uchain_seed_kernel(const __nv_bfloat16* __restrict__ w, int ldw,
                                   const float* __restrict__ s, int width, int M,
                                   __nv_bfloat16* __restrict__ t, int ldt) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * width) return;
  int m = (int)(i / width), j = (int)(i % width);
  float c = __bfloat162float(w[(size_t)j * ldw]);
  t[(size_t)m * ldt + j] = __float2bfloat16_rn(c * s[(size_t)m * width + j]);
}

// Reverse chain: g = (d e / d p)^T u, one warp per point, lane = bone.
// Writes packed[m] = [sdf | g | . . . | 0] (the color columns come from
// the last color layer) and x2[m] = [bf16 feat (Fp) | grad-PE blocks].
__global__ void fine_rev_kernel(const float* __restrict__ pts, int M,
                                const float* __restrict__ rotT, const float* __restrict__ off,
                                const float* __restrict__ cut, int vL, int rL,
                                const float* __restrict__ u, int ldu,
                                const float* __restrict__ z, int ldz, int F,
                                __nv_bfloat16* __restrict__ x2, int ldx, int Fp, int L,
                                float* __restrict__ packed) {
  int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int j = threadIdx.x & 31;
  if (m >= M) return;  // whole warps leave together
  float g[3] = {0.f, 0.f, 0.f};
  if (j < 21) {
    float p[3] = {pts[3 * m], pts[3 * m + 1], pts[3 * m + 2]};
    Stages st = bone_stages(p, rotT, off, cut, j);
    const float* ur = u + (size_t)m * ldu;
    // R1/R2: v-piece adjoints
    float u_vh = ur[j];
    float s = sinf(st.v), c = cosf(st.v);
    float phi = 0.f, bsum = 0.f;
    for (int l = 0; l < vL; ++l) {
      if (l) {
        float s2 = 2.f * s * c, c2 = (c - s) * (c + s);
        s = s2;
        c = c2;
      }
      float usv = ur[21 + 21 * l + j], ucv = ur[21 + 21 * (vL + l) + j];
      phi += (float)(1 << l) * (c * usv - s * ucv);
      bsum += s * usv + c * ucv;
    }
    float phi_v = u_vh + phi;
    float a_v = st.h * phi_v;
    float b_h = st.v * u_vh + bsum;
    // R3/R4: r-piece adjoints, per channel
    const int rb = 21 * (1 + 2 * vL);
    float c_rr[3], d_h3_sum = 0.f, n_v2p = 0.f;
    float w3c = st.w3 * st.w3 * st.w3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      int k = 3 * j + ch;
      float x = st.rr[ch];
      float urh = ur[rb + k];
      float sr = sinf(x), cr = cosf(x);
      float phr = 0.f, dsum = 0.f;
      for (int l = 0; l < rL; ++l) {
        if (l) {
          float s2 = 2.f * sr * cr, c2 = (cr - sr) * (cr + sr);
          sr = s2;
          cr = c2;
        }
        float usr = ur[rb + 63 + 63 * l + k], ucr = ur[rb + 63 + 63 * (rL + l) + k];
        phr += (float)(1 << l) * (cr * usr - sr * ucr);
        dsum += sr * usr + cr * ucr;
      }
      c_rr[ch] = st.h * (urh + phr);
      d_h3_sum += x * urh + dsum;
      n_v2p += -0.5f * c_rr[ch] * st.q[ch] * w3c;  // R6-R8
    }
    b_h += d_h3_sum;                                        // R5
    a_v = a_v - kTau * st.sc * (1.f - st.sc) * b_h;         // R9
    n_v2p += 0.5f * a_v / st.v;                             // R10
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {                        // R11/R12
      int col = 3 * j + ch;
      float f_q = c_rr[ch] * st.w3 + 2.f * st.q[ch] * n_v2p;
      g[0] += f_q * rotT[col];
      g[1] += f_q * rotT[kLane + col];
      g[2] += f_q * rotT[2 * kLane + col];
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
  __nv_bfloat16* xr = x2 + (size_t)m * ldx;
  for (int col = j; col < Fp; col += 32)
    xr[col] = __float2bfloat16_rn(col < F ? zr[1 + col] : 0.f);
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
    xr[Fp + i] = __float2bfloat16_rn(val);
  }
}

}  // namespace honerf

extern "C" int honerf_uchain_seed(const __nv_bfloat16* w, int ldw, const float* s, int width,
                                  int M, __nv_bfloat16* t, int ldt, cudaStream_t stream) {
  size_t n = (size_t)M * width;
  if (n) {
    honerf::uchain_seed_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(w, ldw, s,
                                                                              width, M, t, ldt);
  }
  return (int)cudaGetLastError();
}

extern "C" int honerf_fine_rev(const float* pts, int M, const float* rotT, const float* off,
                               const float* cut, int vL, int rL, const float* u, int ldu,
                               const float* z, int ldz, int F, __nv_bfloat16* x2, int ldx,
                               int Fp, int L, float* packed, cudaStream_t stream) {
  if (M > 0) {
    honerf::fine_rev_kernel<<<(M + 7) / 8, 256, 0, stream>>>(pts, M, rotT, off, cut, vL, rL, u,
                                                             ldu, z, ldz, F, x2, ldx, Fp, L,
                                                             packed);
  }
  return (int)cudaGetLastError();
}
