// Object SDF, forward only (ops/fused_sdf.py: fused_obj_sdf).
//
// Replaces: the Pallas kernel of honerf_tpu/ops/fused_sdf.py (`_run_kernel`
//   pallas_call, body `_make_kernel`), which the JAX package calls through
//   FusedObjSDF for mesh extraction (OfflineRunner.validate_mesh and the
//   fitting stage's result meshes).
//
// Bound on an H100: operations.  Per point the trunk does 0.918 MFLOP of
//   bf16 matmul for the sdf column (63 -> 256 x 3 -> 193 | skip 256 -> 256
//   x 4 -> 1) against 12 bytes of input and 4 of output: a 256^3 grid
//   (16.8 M points) is 15.4 TFLOP, 15.6 ms at 989 TFLOP/s, and 0.08 ms of
//   HBM traffic.
//
// Design: the TPU kernel kept a 512-point block's activations in VMEM
//   through all nine layers.  This version reuses the hand kernels' split
//   launches over a bounded global scratch: obj_embed_kernel writes the
//   positional encoding e (bf16, 63 channels padded to 64) and the skip's
//   copy bf16(e / sqrt2) once, one thread per element; then one
//   gemm_kernel per layer (common.cuh) applies softplus in its epilogue.
//   The layer before the skip stores bf16(softplus(y) / sqrt2)
//   (EPI_SP_SCALE), so both halves of the skip operand are rounded once
//   from f32 with the f32 scale, as in the JAX kernel; the last layer
//   stores the sdf column times 1/scale only (EPI_F32_SCALE).  sin and cos
//   are the accurate sinf/cosf: grid points reach |x| ~ 0.4, so 2^9 x
//   reaches ~200 rad, where the fast intrinsics' error passes bf16's.
//   Split launches move ~1 KB a point per layer through the scratch (~9
//   KB/pt against 0.92 MFLOP/pt, ~100 FLOP/B, under the card's ~295), so
//   from HBM a 256^3 grid would take ~45 ms.  The wrapper's CHUNK of
//   32,768 points keeps the two ping-pong activation buffers at 2 x 32,768
//   x 512 B = 33.5 MB, inside the 50 MB L2.  A fused kernel that keeps a
//   block's activations in shared memory through all nine layers (the TPU
//   kernel's design) is later work; PERF.md has this version's times.

#include "common.cuh"

namespace honerf {

// e[row, col] for col < lde: [x, y, z, sin(2^k x) k < L, cos(2^k x) k < L,
// the same for y and z], zero past 3 + 6L; es = bf16(e * skip_scale).
__global__ void obj_embed_kernel(const float* __restrict__ pts, int M, int L, float skip_scale,
                                 __nv_bfloat16* __restrict__ e, __nv_bfloat16* __restrict__ es,
                                 int lde) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)M * lde) return;
  const int row = (int)(idx / lde), col = (int)(idx % lde);
  const int E = 3 + 6 * L;
  float v = 0.f;
  if (col < 3) {
    v = pts[3 * row + col];
  } else if (col < E) {
    const int c = (col - 3) / (2 * L), r = (col - 3) % (2 * L);
    const float x = pts[3 * row + c] * (float)(1 << (r % L));  // exact: a power of 2
    v = r < L ? sinf(x) : cosf(x);
  }
  e[idx] = __float2bfloat16_rn(v);
  es[idx] = __float2bfloat16_rn(v * skip_scale);
}

}  // namespace honerf

extern "C" int honerf_obj_embed(const float* pts, int M, int L, float skip_scale,
                                __nv_bfloat16* e, __nv_bfloat16* es, int lde,
                                cudaStream_t stream) {
  if (M > 0) {
    const int threads = 256;
    const long n = (long)M * lde;
    honerf::obj_embed_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
        pts, M, L, skip_scale, e, es, lde);
  }
  return (int)cudaGetLastError();
}
