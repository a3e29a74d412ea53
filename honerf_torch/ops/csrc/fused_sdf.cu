// Object SDF, forward only (ops/fused_sdf.py: fused_obj_sdf), in one launch.
//
// Replaces: the Pallas kernel of honerf_tpu/ops/fused_sdf.py (`_run_kernel`
//   pallas_call, body `_make_kernel`, PE `_pe_block`), which the JAX package
//   calls through FusedObjSDF for mesh extraction (OfflineRunner.validate_mesh
//   and the fitting stage's result meshes).
//
// What bounds it on an H100: both the tensor cores and the special-function
//   units.  Per point the trunk does 0.918 MFLOP of bf16 matmul for the sdf
//   column (63 -> 256 x 3 -> 193 | skip 256 -> 256 x 4 -> 1): a 65,536-point
//   call is 0.061 ms at 989 TFLOP/s.  Softplus takes two MUFU operations
//   (ex2, lg2) an element over 7 x 256 + 193 = 1,985 hidden columns a point:
//   ~2.6e8 a call, ~0.07 ms at 16 a clock an SM.  The bytes are nothing: 12
//   in and 4 out a point, the ~1.2 MB of weights read from L2.
//
// Design (the TPU kernel's, a block's activations on chip through all nine
//   layers, rebuilt on wgmma): one persistent block an SM walks tiles of
//   K4_TILE = 128 points.  Warpgroup 0 is the producer: one thread streams
//   each layer's bf16 weights (K x 256, row-major as packed) by TMA into a
//   ring of K4_STAGES stages of 64 k-rows (wgmma.cuh's MN-major B boxes,
//   128-byte swizzle; the ~1.2 MB of weights stay in L2), one stage ahead of
//   the consumers through the layers and into the next tile.  Warpgroups 1
//   and 2 each own 64 of the tile's points:
//    * prologue: the PE straight into shared memory, the accurate sinf /
//      cosf of x 2^k (grid points reach |x| ~ 0.4, so 2^9 x reaches ~200
//      rad, where the fast intrinsics' error passes bf16's) and one
//      rounding to bf16: e into the activation tile's first 64 columns,
//      es = bf16(f32(e) / sqrt2) into a 64-column tile of its own that
//      stays until the skip layer;
//    * each layer: wgmma m64n256k16 with A = the activation tile in shared
//      memory (K-major, 128-byte swizzle: 4 chunks of 64 columns, each
//      gemm_kernel's A stage layout), B = the ring's stage, the f32 sums in
//      registers; the skip layer runs two K ranges, the activation then es,
//      as gemm_kernel's concat did;
//    * epilogue, once the layer's last wgmma has retired: bias, softplus
//      with epilogue8's bf16 arithmetic (__expf, __logf; the layer before
//      the skip times 1/sqrt2), the padding columns zeroed,
//      rounded to bf16 and written in place over the activation tile (the
//      write address: ops/wgmma_layout.py k4_store_offset), then
//      fence.proxy.async and a warpgroup barrier before the next wgmma;
//    * the last layer stores one f32 a point, (z + b) * 1/scale.
//   Shared memory: the 64 KB activation tile, the 16 KB es tile and the
//   128 KB ring (K4_SMEM_BYTES, 214 KB).  Every sum runs in the order the
//   split launches used (the same instruction, K steps, epilogue and PE),
//   so the sdf is expected to keep the parent's bits.  The two consumers
//   share the weight stream and take turns at the tensor cores (named
//   barriers 3 and 4): consumer 1 runs a layer's products while
//   consumer 0 runs that layer's epilogue, and the other way round.  A
//   consumer hands the turn over when its products are done, or, on a
//   layer of more K steps than the ring holds (the skip layer's five),
//   before the first step the other consumer has to free, so that the
//   shared ring cannot deadlock them.

#include "common.cuh"

namespace honerf {

constexpr int K4_TILE = 128;
constexpr int K4_EP = 64;
constexpr int K4_WIDTH = 256;
constexpr int K4_CHUNK_BYTES = K4_TILE * 128;
constexpr int K4_ACT_BYTES = K4_WIDTH / 64 * K4_CHUNK_BYTES;
constexpr int K4_ES_BYTES = K4_CHUNK_BYTES;
constexpr int K4_STAGES = 4;
constexpr int K4_STAGE_BYTES = 64 * K4_WIDTH * 2;
constexpr int K4_RING_BYTES = K4_STAGES * K4_STAGE_BYTES;
constexpr int K4_SMEM_BYTES = 1024 + K4_ACT_BYTES + K4_ES_BYTES + K4_RING_BYTES + 2 * K4_STAGES * 8;
constexpr int K4_MAX_LAYERS = 12;

struct ObjLayer {
  const float* bias;  // (n,) f32
  int kt;             // K steps of 64 over the activation
  int skip;           // 1: one more K step, over es
  int n;              // padded output columns, a multiple of 64, <= K4_WIDTH
  int width;          // unpadded output columns: the rest are stored as 0
  float hscale;       // != 0: the next layer is a skip, bf16(softplus * hscale)
};

struct ObjArgs {
  CUtensorMap w[K4_MAX_LAYERS];  // each layer's (K, n) weights, boxes of 64 x 64
  ObjLayer layer[K4_MAX_LAYERS];
  const float* pts;
  float* out;
  int M, tiles, n_layers, L;
  float skip_scale, inv_scale;
};

// Byte offset of element (row, col) of a tile stored as chunks of 64
// columns, each 128 rows of 128 bytes with the 128-byte swizzle (the
// K-major A layout wgmma reads; row < K4_TILE).
__device__ __forceinline__ uint32_t k4_offset(int row, int col) {
  const int b = 2 * (col & 63);
  return (uint32_t)((col >> 6) * K4_CHUNK_BYTES + row * 128 + ((((b >> 4) ^ (row & 7))) << 4) +
                    (b & 15));
}

// The producer thread: each tile's layers' K steps into the ring.
__device__ __forceinline__ void k4_produce(const ObjArgs& p, uint32_t ring, uint32_t full,
                                           uint32_t empty) {
  for (int l = 0; l < p.n_layers; ++l) wg::prefetch_map(&p.w[l]);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    for (int l = 0; l < p.n_layers; ++l) {
      const int steps = p.layer[l].kt + p.layer[l].skip;
      for (int k = 0; k < steps; ++k, ++it) {
        const int stage = it % K4_STAGES;
        wg::mbar_wait(empty + 8 * stage, ((it / K4_STAGES) & 1) ^ 1);
        const uint32_t b = ring + stage * K4_STAGE_BYTES, bar = full + 8 * stage;
        // the last layer (64 columns, m64n64k16) one box; a hidden layer four,
        // columns past its n out of the map's bounds (TMA fills them with zeros)
        const int boxes = l + 1 == p.n_layers ? 1 : K4_WIDTH / wg::MN_CHUNK;
        wg::mbar_expect_tx(bar, boxes * wg::B_CHUNK_BYTES);
        for (int j = 0; j < boxes; ++j)
          wg::tma_load(&p.w[l], b + j * wg::B_CHUNK_BYTES, bar, j * wg::MN_CHUNK, 64 * k);
      }
    }
  }
}

// A consumer's prologue: e and es of its 64 points (rows 64c.. of the tile
// starting at point r0); zeros past M.  Column 3 + 2 L cc + k holds
// sin(2^k x_cc) and column 3 + 2 L cc + L + k its cosine: a thread takes
// one (row, cc, k), a warp 32 rows of one (cc, k); then the points and
// the padding columns.
__device__ __forceinline__ void k4_pe(const ObjArgs& p, unsigned char* act, unsigned char* es,
                                      int c, int r0) {
  const int tid = threadIdx.x & 127, L = p.L, E = 3 + 6 * L;
  auto put = [&](int r, int col, float v) {
    const uint32_t off = k4_offset(64 * c + r, col);
    *reinterpret_cast<__nv_bfloat16*>(act + off) = __float2bfloat16_rn(v);
    *reinterpret_cast<__nv_bfloat16*>(es + off) = __float2bfloat16_rn(v * p.skip_scale);
  };
  for (int i = tid; i < 64 * 3 * L; i += 128) {
    const int r = i & 63, u = i >> 6, cc = u / L, k = u - cc * L, row = r0 + r;
    float s = 0.f, co = 0.f;
    if (row < p.M) {
      const float x = p.pts[3 * row + cc] * (float)(1 << k);  // exact: a power of 2
      s = sinf(x);
      co = cosf(x);
    }
    put(r, 3 + 2 * L * cc + k, s);
    put(r, 3 + 2 * L * cc + L + k, co);
  }
  for (int i = tid; i < 64 * (3 + K4_EP - E); i += 128) {
    const int r = i & 63, u = i >> 6, col = u < 3 ? u : E + u - 3, row = r0 + r;
    put(r, col, u < 3 && row < p.M ? p.pts[3 * row + u] : 0.f);
  }
}

// softplus(z + b) with beta 100 in epilogue8's bf16 arithmetic (common.cuh),
// times hscale when it is not 0.
__device__ __forceinline__ float k4_softplus(float z, float hscale) {
  const float bz = kBeta * z;
  const float t = __expf(-fabsf(bz));
  float sp = (fmaxf(bz, 0.f) + __logf(1.f + t)) * (1.f / kBeta);
  if (hscale != 0.f) sp *= hscale;
  return sp;
}

// A hidden layer's epilogue: bias, softplus (times hscale when kScale),
// the columns past the layer's width zeroed (kPad), one rounding to bf16,
// written in place over the activation tile.  acc[4j + q] holds row
// ra + 8 (q >> 1), column 8j + 2t + (q & 1).
template <bool kScale, bool kPad>
__device__ __forceinline__ void k4_epilogue(const float (&acc)[128], const ObjLayer& ly,
                                            unsigned char* act_ptr, int ra, int t) {
#pragma unroll
  for (int j = 0; j < K4_WIDTH / 8; ++j) {
    const int col = 8 * j + 2 * t;
    float2 bias = make_float2(0.f, 0.f);
    if (!kPad || col < ly.n) bias = *reinterpret_cast<const float2*>(ly.bias + col);
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = k4_softplus(acc[4 * j + q] + ((q & 1) ? bias.y : bias.x), kScale ? ly.hscale : 0.f);
      if (kPad && col + (q & 1) >= ly.width) v[q] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(act_ptr + k4_offset(ra + 8 * h, col)) =
          __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
  }
}

// One layer's products for consumer c into fresh accumulators: its K
// steps over the activation tile, then es on a skip layer; each stage freed
// once the next step's products are issued and the previous ones retired.
// R 128: m64n256k16 (a hidden layer); R 32: m64n64k16 (the last).
// hand_off() is called once: before the wait for a step past the ring's
// depth (the other consumer has to free that stage first), else after the
// last step.
template <int R, class HandOff>
__device__ __forceinline__ void k4_mma(float (&acc)[R], const ObjLayer& ly, uint32_t act,
                                       uint32_t es, uint32_t ring, uint32_t full,
                                       uint32_t empty, int c, int& it, const HandOff& hand_off) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  int prev = -1;
  const int steps = ly.kt + ly.skip;
  for (int k = 0; k < steps; ++k, ++it) {
    if (k == K4_STAGES) hand_off();
    const int stage = it % K4_STAGES;
    wg::mbar_wait(full + 8 * stage, (it / K4_STAGES) & 1);
    const uint32_t a = (k < ly.kt ? act + k * K4_CHUNK_BYTES : es) + c * (K4_CHUNK_BYTES / 2);
    const uint32_t b = ring + stage * K4_STAGE_BYTES;
    wg::fence_acc(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg::smem_desc(a + kk * wg::K_MAJOR_K16, wg::K_MAJOR_LBO, wg::SBO);
      const uint64_t db = wg::smem_desc(b + kk * wg::MN_MAJOR_K16, wg::MN_MAJOR_LBO, wg::SBO);
      if constexpr (R == 128)
        wg::wgmma_m64n256k16<0, 1>(acc, da, db, 1);
      else
        wg::wgmma_m64n64k16<0, 1>(acc, da, db, 1);
    }
    wg::wgmma_commit();
    wg::fence_acc(acc);
    wg::wgmma_wait<1>();  // the previous step's products are done: free its stage
    wg::fence_acc(acc);
    if (prev >= 0 && lane == 0) wg::mbar_arrive(empty + 8 * prev);
    prev = stage;
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(acc);
  if (lane == 0) wg::mbar_arrive(empty + 8 * prev);
  if (steps <= K4_STAGES) hand_off();
}

__global__ void __launch_bounds__(wg::THREADS, 1) obj_sdf_fused_kernel(const __grid_constant__ ObjArgs p) {
  extern __shared__ __align__(128) unsigned char k4_smem[];
  const uint32_t raw = wg::smem_u32(k4_smem);
  const uint32_t act = (raw + 1023) & ~1023u;
  unsigned char* act_ptr = k4_smem + (act - raw);
  unsigned char* es_ptr = act_ptr + K4_ACT_BYTES;
  const uint32_t es = act + K4_ACT_BYTES, ring = es + K4_ES_BYTES;
  const uint32_t full = ring + K4_RING_BYTES, empty = full + 8 * K4_STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K4_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == 0) k4_produce(p, ring, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  const int c = warpgroup - 1;  // rows 64c..64c+63 of each tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = 64 * c + 16 * ((threadIdx.x >> 5) & 3) + g;  // this thread's rows: ra, ra + 8
  int it = 0;
  // consumer c's turn at the tensor cores is named barrier 3 + c: it syncs
  // there before a layer's products and, once its products no longer need
  // the ring to itself, arrives at the other's (every phase but
  // consumer 1's very last); consumer 0 takes the first turn
  if (c == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    k4_pe(p, act_ptr, es_ptr, c, tile * K4_TILE + 64 * c);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    const bool last_tile = tile + (int)gridDim.x >= p.tiles;
    for (int l = 0; l < p.n_layers; ++l) {
      const ObjLayer& ly = p.layer[l];
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
      const bool final_phase = last_tile && l + 1 == p.n_layers;
      auto hand_off = [&]() {
        if (!(c == 1 && final_phase))
          asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
      };
      if (l + 1 == p.n_layers) {
        // the sdf column: m64n64k16; acc[0] is (ra, 0), acc[2] (ra + 8, 0) on lanes t == 0
        float acc[32];
        k4_mma(acc, ly, act, es, ring, full, empty, c, it, hand_off);
        if (t == 0) {
          const float b0 = ly.bias[0];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = tile * K4_TILE + ra + 8 * h;
            if (row < p.M) p.out[row] = (acc[2 * h] + b0) * p.inv_scale;
          }
        }
        break;
      }
      float acc[128];
      k4_mma(acc, ly, act, es, ring, full, empty, c, it, hand_off);
      // the pre-skip scale and the padding's zeros only where a layer has them
      if (ly.hscale != 0.f) {
        if (ly.width < K4_WIDTH)
          k4_epilogue<true, true>(acc, ly, act_ptr, ra, t);
        else
          k4_epilogue<true, false>(acc, ly, act_ptr, ra, t);
      } else {
        if (ly.width < K4_WIDTH)
          k4_epilogue<false, true>(acc, ly, act_ptr, ra, t);
        else
          k4_epilogue<false, false>(acc, ly, act_ptr, ra, t);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    }
  }
}

}  // namespace honerf

// out[:M] = the object sdf of pts[:M] (f32, (M, 3)); layer l's bf16
// weights ws[l] are (rows[l], cols[l]) row-major (a skip layer's rows:
// [activation | K4_EP of es]), its f32 biases bs[l] (cols[l],), its
// unpadded outputs widths[l]; skips[l] != 0 marks a skip layer.  Refused
// (cudaErrorInvalidValue): more than K4_MAX_LAYERS layers, a PE wider than
// K4_EP, a width not a multiple of 64 or past K4_WIDTH, rows that do not
// match the layer's input, a last layer of other than 64 columns, operands
// TMA cannot take.
extern "C" int honerf_obj_sdf(const float* pts, int M, int L, float skip_scale, float inv_scale,
                              int n_layers, const void* const* ws, const int* rows,
                              const int* cols, const int* widths, const int* skips,
                              const void* const* bs, float* out, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using honerf::K4_EP;
  using honerf::K4_WIDTH;
  if (n_layers < 1 || n_layers > honerf::K4_MAX_LAYERS || L < 1 || 3 + 6 * L > K4_EP || M < 0 ||
      skips[0] || cols[n_layers - 1] != 64)
    return (int)cudaErrorInvalidValue;
  honerf::ObjArgs p{};
  int in = K4_EP;
  for (int l = 0; l < n_layers; ++l) {
    const int kt_rows = rows[l] - (skips[l] ? K4_EP : 0);
    if (cols[l] <= 0 || cols[l] % 64 || cols[l] > K4_WIDTH || kt_rows != in || widths[l] <= 0 ||
        widths[l] > cols[l] || honerf_misaligned16(ws[l]) || honerf_misaligned16(bs[l]) ||
        !wg::tma_map(&p.w[l], ws[l], cols[l], rows[l], cols[l], wg::MN_CHUNK, wg::BK))
      return (int)cudaErrorInvalidValue;
    const bool before_skip = l + 1 < n_layers && skips[l + 1];
    p.layer[l] = honerf::ObjLayer{static_cast<const float*>(bs[l]), kt_rows / 64,
                                  skips[l] ? 1 : 0, cols[l], widths[l],
                                  before_skip ? skip_scale : 0.f};
    in = cols[l];
  }
  if (M == 0) return (int)cudaGetLastError();
  p.pts = pts;
  p.out = out;
  p.M = M;
  p.tiles = (M + honerf::K4_TILE - 1) / honerf::K4_TILE;
  p.n_layers = n_layers;
  p.L = L;
  p.skip_scale = skip_scale;
  p.inv_scale = inv_scale;
  static bool smem_set = false;  // raise the dynamic shared-memory cap once per process
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(honerf::obj_sdf_fused_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           honerf::K4_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int grid = p.tiles < wg::sm_count() ? p.tiles : wg::sm_count();
  honerf::obj_sdf_fused_kernel<<<grid, wg::THREADS, honerf::K4_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}
