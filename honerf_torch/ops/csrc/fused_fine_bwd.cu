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
//     pose_partial/pose_reduce_kernel  the pose sums drotT / doff, in a
//                                      fixed order of their own
//   So two runs give the same bits: no atomics anywhere.  Right first:
//   wgmma/TMA and fusing the launches are later work.
//
// f32 mode (FineMeta.dtype 'f32': the confs' trunks as written; JAX's
//   FineMeta(dtype='f32')): the same launches on f32 operands
//   (gemm_f32_kernel, the per-point kernels' f32 variants; the cotangent
//   rows dzb, du_b, du_s in f32) and every dW by gemm_tn_f32_kernel
//   (trunk.cuh: the same split partials and fixed-order sum), both 3xTF32
//   on the tensor cores (common.cuh), db by the same colsum.
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

// One warp per point, lane j < 21 = bone j:
//  * dg_total = dg + the grad-PE transpose of the color input's cotangent
//    (dx columns Ep + Fp ..) -> dgt[m, 0:3];
//  * du = the reverse chain transposed at dg_total (T4-T1), stored as
//    T(du) and T(du / sqrt2) (the u-chain transpose's operands at layer 0
//    and at the skip), zero on the padding up to Ep;
//  * the trunk's top cotangent [dsdf | dfeat (dx columns Ep ..) | 0] into
//    dzf (f32) and dzb (T), Op columns.
// T: bf16, or f32 in the f32 mode.
template <typename T>
__global__ void fine_bwd_rev_kernel(const float* __restrict__ pts, int M,
                                    const float* __restrict__ rotT, const float* __restrict__ off,
                                    const float* __restrict__ cut, int vL, int rL,
                                    const float* __restrict__ packed,
                                    const float* __restrict__ dsdf,
                                    const float* __restrict__ dg,
                                    const float* __restrict__ dx, int ldx, int Ep, int F, int Fp,
                                    int L, T* __restrict__ du_b, T* __restrict__ du_s,
                                    int lddu, float* __restrict__ dgt, float* __restrict__ dzf,
                                    T* __restrict__ dzb, int lddz, int Op) {
  int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int j = threadIdx.x & 31;
  if (m >= M) return;  // whole warps leave together
  const float* dxr = dx + (size_t)m * ldx;
  // grad-PE transpose, channel j < 3 on lane j
  float tj = 0.f;
  if (j < 3) {
    const float* dgpe = dxr + Ep + Fp;
    float gv = packed[(size_t)m * 8 + 1 + j];
    tj = dg[(size_t)m * 3 + j] + dgpe[j];
    for (int l = 0; l < L; ++l) {
      float f = (float)(1 << l);
      tj += f * (cosf(gv * f) * dgpe[(1 + l) * 8 + j] - sinf(gv * f) * dgpe[(1 + L + l) * 8 + j]);
    }
    dgt[(size_t)m * 4 + j] = tj;
  }
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) t[a] = __shfl_sync(0xffffffffu, tj, a);
  // trunk top cotangent
  for (int col = j; col < Op; col += 32) {
    float v = col == 0 ? dsdf[m] : (col <= F ? dxr[Ep + col - 1] : 0.f);
    dzf[(size_t)m * lddz + col] = v;
    dzb[(size_t)m * lddz + col] = from_f32<T>(v);
  }
  T* rb_ = du_b + (size_t)m * lddu;
  T* rs_ = du_s + (size_t)m * lddu;
  const int E = 21 * (1 + 2 * vL) + 63 * (1 + 2 * rL);
  for (int col = E + j; col < Ep; col += 32) {
    rb_[col] = from_f32<T>(0.f);
    rs_[col] = from_f32<T>(0.f);
  }
  if (j >= 21) return;
  float p[3] = {pts[3 * m], pts[3 * m + 1], pts[3 * m + 2]};
  Stages st = bone_stages(p, rotT, off, cut, j);
  Head hd = transpose_head(st, nullptr, rotT, t, j);
  const float cb = hd.cb, hca = st.h * hd.ca;
  auto put = [&](int col, float v) {
    rb_[col] = from_f32<T>(v);
    rs_[col] = from_f32<T>(v * kInvSqrt2);
  };
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
  // T4/T3: r family, cd = cb on every channel of the bone
  const int rb = 21 * (1 + 2 * vL);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int col = 3 * j + k;
    float x = st.rr[k], hc = st.h * hd.cc[k];
    put(rb + col, x * cb + hc);
    float sr = sinf(x), cr = cosf(x);
    for (int l = 0; l < rL; ++l) {
      if (l) {
        float s2 = 2.f * sr * cr, c2 = (cr - sr) * (cr + sr);
        sr = s2;
        cr = c2;
      }
      float f = (float)(1 << l);
      put(rb + 63 + 63 * l + col, sr * cb + f * cr * hc);
      put(rb + 63 + 63 * (rL + l) + col, cr * cb - f * sr * hc);
    }
  }
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

// The pose sums drotT / doff: the column sums of the per-point pose rows
// P (M, 256), in a fixed order (no atomics).  pose_partial_kernel: block s
// sums rows [s*split, (s+1)*split) in order, one thread a column;
// pose_reduce_kernel: out (+)= the partials in order s = 0, 1, ...  (Kernels
// of their own, apart from trunk.cuh's column sum, whose order differs: the
// dW/db kernels are the ones a frozen backward must not launch.)
__global__ void pose_partial_kernel(const float* __restrict__ P, int M, int split,
                                    float* __restrict__ ws) {
  int col = threadIdx.x;
  int r0 = blockIdx.x * split, r1 = min(M, r0 + split);
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) sum += P[(size_t)r * 256 + col];
  ws[(size_t)blockIdx.x * 256 + col] = sum;
}

__global__ void pose_reduce_kernel(const float* __restrict__ ws, int S, float* __restrict__ out,
                                   int acc) {
  int col = threadIdx.x;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += ws[(size_t)s * 256 + col];
  out[col] = acc ? out[col] + sum : sum;
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

template <typename T>
static int honerf_fine_bwd_rev_t(const float* pts, int M, const float* rotT, const float* off,
                                 const float* cut, int vL, int rL, const float* packed,
                                 const float* dsdf, const float* dg, const float* dx, int ldx,
                                 int Ep, int F, int Fp, int L, T* du_b, T* du_s, int lddu,
                                 float* dgt, float* dzf, T* dzb, int lddz, int Op,
                                 cudaStream_t stream) {
  if (M > 0)
    honerf::fine_bwd_rev_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(
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

// out[:256] (+)= the column sums of the pose rows P[:M, :256], fixed order;
// ws holds ceil(M / split) partial rows.
extern "C" int honerf_pose_sum(const float* P, int M, int split, float* ws, float* out, int acc,
                               cudaStream_t stream) {
  if (M <= 0 || split <= 0) return (int)cudaGetLastError();
  const int S = (M + split - 1) / split;
  honerf::pose_partial_kernel<<<S, 256, 0, stream>>>(P, M, split, ws);
  honerf::pose_reduce_kernel<<<1, 256, 0, stream>>>(ws, S, out, acc);
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
