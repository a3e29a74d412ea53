// The f32 hand trunk in two launches: its forward (hand_trunk_fwd_f32_kernel)
// and its u-chain (hand_uchain_f32_kernel) (ops/fused_fine.py: trunk_fwd,
// trunk_uchain on an f32 trunk; cuda_trunk_forward calls them for K2, K5
// and the recompute of K3 and K6).
//
// Replaces: the f32 mode of `_kernel_fwd_body` (honerf_tpu/ops/fused_fine.py:
//   275-323: the forward and the u-chain) inside K5's pallas_call (:452) and
//   K2's (`_fine_fwd_block`, honerf_tpu/ops/fused_fine_full.py:920,
//   pallas_call at :1556) with FineMeta(dtype='f32'), whose recompute K3
//   (:1650) and K6 (fused_fine.py:488) repeat.  The split launches they
//   replace (one gemm_f32_kernel a layer, then uchain_seed_kernel) stay
//   callable for comparison only (fused_fine.cuda_trunk_forward_split).
//
// What bounds them on an H100: operations.  Each f32 product runs as
//   three TF32 products (split-precision 3xTF32, common.cuh), so the card's
//   495 TF32 TFLOP/s give 165 TFLOP/s of f32 work: the forward's ~2.4 MFLOP
//   a point (1408 -> 256 x 3 -> [256 | 1408] -> 256 x 3 -> 320) and the
//   u-chain's ~2.4 (256 -> 256 x 7 and the two 1408-wide embedding
//   products) are ~14.6 ms per million points each, K5 f32's 56,448 points
//   1.644 ms for the pair.  Their bytes: e read twice (5.6 KB each in f32),
//   the sigmoid rows written once and read once (8 x 1 KB), z (1.3 KB) and
//   u (5.6 KB) written: ~34 KB a point, ~10 ms per million points at 3.35
//   TB/s.  The weights (the tf32 split's two copies, ~10 MB a kernel) stay
//   in L2; a tile re-reads them from there, ~160 KB a point at 64 points a
//   tile.
//
// Design (hand_trunk_fwd_kernel's, csrc/trunk_fused.cu, rethought for
//   TF32): one persistent block an SM walks tiles of TF32_TILE = 64 points.
//   Warpgroup 0 is the producer: one thread streams each phase's K steps
//   by TMA into a ring.  Warpgroups 1 and 2 are the consumers: both read
//   all 64 rows of A and each computes half of the phase's columns
//   (wgmma m64nNk8 .tf32, N = 128 for a 256-wide layer), so a consumer
//   holds a fresh and a running accumulator of N / 2 = 64 registers each;
//   the m64n256 pair (256 registers) does not fit in 255.
//
//  * 3xTF32 on wgmma.  TF32 wgmma reads B only K-major from shared memory
//   and A K-major from shared memory or from registers.  A comes from
//   registers: each consumer loads its fragments from the f32 tile (or
//   e's box) and splits each value there, big = tf32(x) (cvt.rna's
//   rounding) and small = tf32(x - big), after the skip's f32 scale.  B is
//   split once per weight snapshot (fused_fine.tf32_operands: [big; small]
//   rows of one f32 tensor, K-major: W^T for the forward, W for the
//   u-chain).  A K step of 32 is two ring slots: B's small rows, then its
//   big rows; e's box (64 x 32 f32, 8 KB) rides in the first.  Into a
//   fresh accumulator go the four k8 products big.small, then small.big,
//   then big.big (the small terms first, so they are not lost against
//   the large ones), and the fresh sum is added to the running one with
//   round to nearest: the tensor core's adds truncate, and a 1408-deep sum
//   straight into one accumulator drifts by ~1e-5 of its norm
//   (gemm_f32_kernel's order, tests/test_torch_trunk_f32_layout.py's model).
//  * Shared memory.  Both tiles keep gemm_kernel's K-major bytes: 32 f32
//   columns a 128-byte row, 128-byte swizzle, SBO 1024, a k8 step 32
//   bytes on.  The forward: the 64 KB activation tile and four 40 KB slots
//   (e's box + up to 256 rows x 32 k of B), 225 KB; the u-chain: two 64 KB
//   t tiles (the chain's, and the skip's t kept to layer 0) and three 32
//   KB slots, 225 KB.
//  * The forward's phases are honerf_trunk_fwd's: layer 0 over e's boxes,
//   the hidden layers over the tile, the skip over the tile then e's boxes
//   (both times x * f32(1/sqrt2) before the split: the f32 mode's concat),
//   the last layer's n_store columns in pieces of 256, 128 or 64.
//   Epilogues from the accumulators, epilogue8's f32 arithmetic (expf,
//   log1pf, __frcp_rn's bits by tf_rcp12): softplus in place over the tile
//   once both consumers are done reading it (named barrier 1), the f32
//   sigmoid row to ss[l], with keep softplus to acts[l].
//  * The u-chain: the seed t = W_last[:, 0] * s_{n-2} (uchain_seed_kernel's
//   function) in the prologue; layers n-2 .. 1: c = (t W_l^T) * hscale,
//   t <- c * s_{l-1} (s from HBM, f32); with keep c to cs[l], t to
//   ts[l-1]; then u in pieces of 256 columns (128 a consumer), each two
//   phases: the skip's part m_skip over t tile 0, stored as f32(m_skip *
//   1/sqrt2), then layer 0's m_0 over t tile 1, u = that + m_0, read back
//   from L2 by the thread that stored it (EPI_UCHAIN's u_acc order: 128
//   columns a consumer leave no registers to hold the skip's part beside
//   the two sums; pieces of 128 columns, held in registers, measured the
//   same with twice the phases).
//
//   The two consumers share the weight stream in lockstep through the
//   ring; a consumer frees both slots of a K step once that step's products
//   are done.  ops/wgmma_layout.py: ring_schedule(pairs=True) models the
//   barriers on the phase tables (tests/test_torch_trunk_f32_layout.py).
//
//   New bits are expected against the split launches: wgmma's internal
//   order is not mma.sync's.

#include "tf32.cuh"

namespace honerf {

enum T32Kind { T32_HIDDEN = 0, T32_Z = 1 };

struct T32Phase {
  int act_steps;  // K steps over the activation tile
  int e_steps;    // then K steps over e's boxes
  int e_row0;     // B's k of e's first step (0 at layer 0, Hp at the skip)
  int scale;      // A is multiplied by skip_scale before the split (the skip)
  int layer;      // the trunk layer: weight map, bias, ss and acts row
  int n0;         // the phase's first output column
  int width;      // its columns (both consumers): 256, 128 or 64
  int kind;       // T32Kind
};

struct T32Args {
  CUtensorMap e;                    // (M, Ep) f32, boxes of 32 x 64
  CUtensorMap w[TF32_MAX_LAYERS];   // [big; small] of W_l^T: (2 out_pad, in_pad), boxes 32 x 64
  T32Phase ph[TF32_MAX_PHASES];
  const float* bias[TF32_MAX_LAYERS];
  float* acts[TF32_MAX_LAYERS];     // keep: softplus of layer l, or null
  int out_rows[TF32_MAX_LAYERS];    // out_pad of layer l: the first small row
  float* ss;                        // ss[l] = ss + l * ss_layer, rows lds apart
  long long ss_layer;
  int lds, ldact;
  float* z;                         // the last layer's first n_store columns, or null
  int ldz, n_store;
  int M, tiles, n_phases;
  float skip_scale;
};

// softplus(z) and sigmoid(beta z) in epilogue8's f32 arithmetic
// (common.cuh, EPI_SOFTPLUS with kF32: nothing rounds after them).
__device__ __forceinline__ void t32_softplus(float z, float& sp, float& sg) {
  const float bz = kBeta * z;
  const float t = expf(-fabsf(bz));
  const float r = tf_rcp12(1.f + t);  // __frcp_rn's bits on [1, 2] (common.cuh)
  sp = (fmaxf(bz, 0.f) + log1pf(t)) * (1.f / kBeta);
  sg = bz >= 0.f ? r : t * r;
}

// ---------------------------------------------------------------------------
// hand_trunk_fwd_f32_kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ void t32_produce(const T32Args& p, uint32_t ring, uint32_t full,
                                            uint32_t empty) {
  wg::prefetch_map(&p.e);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    for (int q = 0; q < p.n_phases; ++q) {
      const T32Phase& ph = p.ph[q];
      const int steps = ph.act_steps + ph.e_steps;
      for (int k = 0; k < steps; ++k) {
        const bool e_step = k >= ph.act_steps;
        const int ke = k - ph.act_steps;
        const int kc = e_step ? ph.e_row0 + TF32_BK * ke : TF32_BK * k;  // B's k
        for (int half = 0; half < 2; ++half, ++it) {  // 0: B's small rows, 1: its big rows
          const int stage = it % TF32_STAGES;
          wg::mbar_wait(empty + 8 * stage, ((it / TF32_STAGES) & 1) ^ 1);
          const uint32_t sb = ring + stage * TF32_STAGE_BYTES, bar = full + 8 * stage;
          const bool with_a = e_step && half == 0;
          wg::mbar_expect_tx(bar, ph.width / TF32_BOX_ROWS * TF32_BOX_BYTES +
                                      (with_a ? TF32_A_BYTES : 0));
          if (with_a) wg::tma_load(&p.e, sb, bar, TF32_BK * ke, tile * TF32_TILE);
          const int row0 = (half == 0 ? p.out_rows[ph.layer] : 0) + ph.n0;
          for (int j = 0; j < ph.width / TF32_BOX_ROWS; ++j)
            wg::tma_load(&p.w[ph.layer], sb + TF32_A_BYTES + j * TF32_BOX_BYTES, bar, kc,
                         row0 + TF32_BOX_ROWS * j);
        }
      }
    }
  }
}

// One phase's products: consumer c's NW columns (from n0 + c NW) into run;
// A from the tile's chunks, then e's boxes in the slots.
template <int NW>
__device__ __forceinline__ void t32_phase(float (&run)[NW / 2], const T32Phase& ph,
                                          const unsigned char* act_ptr,
                                          const unsigned char* ring_ptr, uint32_t ring,
                                          uint32_t full, uint32_t empty, int c, float skip_scale,
                                          int r, int t, int& it) {
  const auto src = [&](int k, int s1) {
    return k < ph.act_steps ? act_ptr + k * TF32_CHUNK_BYTES : ring_ptr + s1 * TF32_STAGE_BYTES;
  };
  t32_steps<NW>(run, ph.act_steps + ph.e_steps, src, ph.scale ? skip_scale : 1.f, ring, full,
                empty, TF32_STAGES, TF32_STAGE_BYTES, TF32_A_BYTES + c * NW * 128, r, t, it);
}

// A hidden layer's epilogue: bias, softplus in place over the tile, the
// sigmoid row to ss[l] and with kKeep softplus to acts[l].  acc[4j + q]
// holds tile row r + 8 (q >> 1), column c NW + 8j + 2t + (q & 1); grow0 is
// row r's point.
template <bool kKeep, int NW>
__device__ __forceinline__ void t32_hidden_epilogue(const float (&acc)[NW / 2], const T32Args& p,
                                                    const T32Phase& ph, unsigned char* act_ptr,
                                                    int c, int r, int t, int grow0) {
  const float* bias = p.bias[ph.layer];
  float* ss = p.ss + ph.layer * p.ss_layer;
  float* ag = kKeep ? p.acts[ph.layer] : nullptr;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sp0, sg0, sp1, sg1;
      t32_softplus(acc[4 * j + 2 * h] + b.x, sp0, sg0);
      t32_softplus(acc[4 * j + 2 * h + 1] + b.y, sp1, sg1);
      *reinterpret_cast<float2*>(act_ptr + t32_offset(r + 8 * h, col)) = make_float2(sp0, sp1);
      const int grow = grow0 + 8 * h;
      if (grow < p.M) {
        *reinterpret_cast<float2*>(ss + (size_t)grow * p.lds + col) = make_float2(sg0, sg1);
        if (kKeep)
          *reinterpret_cast<float2*>(ag + (size_t)grow * p.ldact + col) = make_float2(sp0, sp1);
      }
    }
  }
}

// The last layer's piece: z + bias at its columns below n_store (ldz may
// be odd: scalar stores).
template <int NW>
__device__ __forceinline__ void t32_last_epilogue(const float (&acc)[NW / 2], const T32Args& p,
                                                  const T32Phase& ph, int c, int t, int grow0) {
  const float* bias = p.bias[ph.layer];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = ph.n0 + c * NW + 8 * j + 2 * t;  // even: the bias pair is 8-byte aligned
    if (col >= p.n_store) continue;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow >= p.M) continue;
      float* zr = p.z + (size_t)grow * p.ldz + col;
      zr[0] = acc[4 * j + 2 * h] + b.x;
      if (col + 1 < p.n_store) zr[1] = acc[4 * j + 2 * h + 1] + b.y;
    }
  }
}

template <int NW>
__device__ __forceinline__ void t32_run_phase(const T32Args& p, const T32Phase& ph,
                                              unsigned char* act_ptr,
                                              const unsigned char* ring_ptr, uint32_t ring,
                                              uint32_t full, uint32_t empty, int c, int r, int t,
                                              int grow0, int& it) {
  float acc[NW / 2];
  t32_phase<NW>(acc, ph, act_ptr, ring_ptr, ring, full, empty, c, p.skip_scale, r, t, it);
  if (ph.kind == T32_Z) {
    t32_last_epilogue<NW>(acc, p, ph, c, t, grow0);
    return;
  }
  t32_sync();  // both consumers are done reading the tile
  if (p.acts[ph.layer])
    t32_hidden_epilogue<true, NW>(acc, p, ph, act_ptr, c, r, t, grow0);
  else
    t32_hidden_epilogue<false, NW>(acc, p, ph, act_ptr, c, r, t, grow0);
  t32_sync();  // the next layer reads the whole tile
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    hand_trunk_fwd_f32_kernel(const __grid_constant__ T32Args p) {
  extern __shared__ __align__(128) unsigned char t32_smem[];
  const uint32_t raw = wg::smem_u32(t32_smem);
  const uint32_t act = (raw + 1023) & ~1023u;
  unsigned char* act_ptr = t32_smem + (act - raw);
  const unsigned char* ring_ptr = act_ptr + TF32_ACT_BYTES;
  const uint32_t ring = act + TF32_ACT_BYTES;
  const uint32_t full = ring + TF32_RING_BYTES, empty = full + 8 * TF32_STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF32_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int l = 0; l < TF32_MAX_LAYERS; ++l)
        if (p.bias[l]) wg::prefetch_map(&p.w[l]);
      t32_produce(p, ring, full, empty);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  const int c = warpgroup - 1;  // columns c NW .. of each phase
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // rows r, r + 8 of the tile
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int grow0 = tile * TF32_TILE + r;
    for (int q = 0; q < p.n_phases; ++q) {
      const T32Phase& ph = p.ph[q];
      if (ph.width == 256)
        t32_run_phase<128>(p, ph, act_ptr, ring_ptr, ring, full, empty, c, r, t, grow0, it);
      else if (ph.width == 128)
        t32_run_phase<64>(p, ph, act_ptr, ring_ptr, ring, full, empty, c, r, t, grow0, it);
      else
        t32_run_phase<32>(p, ph, act_ptr, ring_ptr, ring, full, empty, c, r, t, grow0, it);
    }
  }
}

// ---------------------------------------------------------------------------
// hand_uchain_f32_kernel
// ---------------------------------------------------------------------------

enum U32Kind { U32_CHAIN = 0, U32_SKIP = 1, U32_ZERO = 2 };

// A phase of a tile: a chain layer (A = t tile src, B = W_l's first Hp
// rows), or a part of a piece of u: the skip's (A = t tile 0, the skip's
// t; B = W_skip's rows from Hp + n0), then layer 0's (A = t tile 1; B =
// W_0's rows from n0).
struct U32Phase {
  int layer, row0, width, kind;  // row0: B's first row; width: its columns (both consumers)
};

struct U32Args {
  CUtensorMap w[TF32_MAX_LAYERS];  // [big; small] of W_l: (2 in_pad, Hp), boxes 32 x 64
  U32Phase ph[TF32_UC_MAX_PHASES];
  int in_rows[TF32_MAX_LAYERS];    // in_pad of layer l: the first small row
  const float* w_last;             // ws[n-1] (Hp, Op): column 0 is the seed's
  int ldw;
  const float* ss;                 // ss[l] = ss + l * ss_layer, rows lds apart
  long long ss_layer;
  int lds;
  float* u;                        // (M, Ep) f32, rows ldu apart, or null
  int ldu;
  float* ts[TF32_MAX_LAYERS];      // keep: t_l, l < n - 1, or null
  int ldt;
  float* cs[TF32_MAX_LAYERS];      // keep: c_l, 1 <= l < n - 1, or null
  int ldc;
  int M, tiles, n_layers, skip, Hp, Ep, kt, n_phases;
  float hscale, escale;
};

__device__ __forceinline__ void u32_produce(const U32Args& p, uint32_t ring, uint32_t full,
                                            uint32_t empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    for (int q = 0; q < p.n_phases; ++q) {
      const U32Phase& ph = p.ph[q];
      for (int k = 0; k < p.kt; ++k) {
        for (int half = 0; half < 2; ++half, ++it) {  // 0: B's small rows, 1: its big rows
          const int stage = it % TF32_UC_STAGES;
          wg::mbar_wait(empty + 8 * stage, ((it / TF32_UC_STAGES) & 1) ^ 1);
          const uint32_t sb = ring + stage * TF32_UC_STAGE_BYTES, bar = full + 8 * stage;
          wg::mbar_expect_tx(bar, ph.width / TF32_BOX_ROWS * TF32_BOX_BYTES);
          const int row0 = (half == 0 ? p.in_rows[ph.layer] : 0) + ph.row0;
          for (int j = 0; j < ph.width / TF32_BOX_ROWS; ++j)
            wg::tma_load(&p.w[ph.layer], sb + j * TF32_BOX_BYTES, bar, TF32_BK * k,
                         row0 + TF32_BOX_ROWS * j);
        }
      }
    }
  }
}

// The seed t = W_last[:, 0] * s_{n-2} of the tile into t tile 0 (zeros
// past M) and, with keep, ts[n-2]: the 256 consumer threads on float4
// columns, each thread's 4 coefficients read once.
__device__ __forceinline__ void u32_seed(const U32Args& p, unsigned char* t0, int tile) {
  const int tid = threadIdx.x - 128, per_row = p.Hp / 4;
  const int col = 4 * (tid % per_row);
  const float* s = p.ss + (p.n_layers - 2) * p.ss_layer;
  float* tg = p.ts[p.n_layers - 2];
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = p.w_last[(size_t)(col + i) * p.ldw];
  for (int row = tid / per_row; row < TF32_TILE; row += 256 / per_row) {
    const int grow = tile * TF32_TILE + row;
    const float4 sv = grow < p.M ? *reinterpret_cast<const float4*>(s + (size_t)grow * p.lds + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 tv = make_float4(w[0] * sv.x, w[1] * sv.y, w[2] * sv.z, w[3] * sv.w);
    *reinterpret_cast<float4*>(t0 + t32_offset(row, col)) = tv;
    if (tg && grow < p.M) *reinterpret_cast<float4*>(tg + (size_t)grow * p.ldt + col) = tv;
  }
}

// One phase's products: consumer c's NW columns over t tile `src`.
template <int NW>
__device__ __forceinline__ void u32_phase_mma(float (&run)[NW / 2], const unsigned char* src,
                                              uint32_t ring, uint32_t full, uint32_t empty,
                                              int c, int kt, int r, int t, int& it) {
  const auto chunk = [&](int k, int) { return src + k * TF32_CHUNK_BYTES; };
  t32_steps<NW>(run, kt, chunk, 1.f, ring, full, empty, TF32_UC_STAGES, TF32_UC_STAGE_BYTES,
                c * NW * 128, r, t, it);
}

// The rows of s_{l-1} that a chain layer's epilogue reads, all at once
// (0 past M): their loads are issued before the consumers' barrier.
template <int NW>
__device__ __forceinline__ void u32_load_s(float2 (&sv)[NW / 8][2], const U32Args& p, int l,
                                           int c, int t, int grow0) {
  const float* s = p.ss + (l - 1) * p.ss_layer;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      sv[j][h] = grow < p.M ? __ldg(reinterpret_cast<const float2*>(
                                  s + (size_t)grow * p.lds + c * NW + 8 * j + 2 * t))
                            : make_float2(0.f, 0.f);
    }
}

// A chain layer's epilogue (EPI_UCHAIN's arithmetic): c = m * hscale, with
// keep to cs[l]; t = c * s_{l-1} into tile dst and, with keep, ts[l-1].
template <bool kKeep, int NW>
__device__ __forceinline__ void u32_chain_epilogue(const float (&acc)[NW / 2],
                                                   const float2 (&sv)[NW / 8][2],
                                                   const U32Args& p, int l, unsigned char* dst,
                                                   int c, int r, int t, int grow0) {
  const float hscale = l == p.skip ? p.hscale : 1.f;
  float* cg = p.cs[l];
  float* tg = p.ts[l - 1];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      const float c0 = acc[4 * j + 2 * h] * hscale, c1 = acc[4 * j + 2 * h + 1] * hscale;
      const float2 tv = make_float2(c0 * sv[j][h].x, c1 * sv[j][h].y);
      *reinterpret_cast<float2*>(dst + t32_offset(r + 8 * h, col)) = tv;
      if (kKeep && grow < p.M) {
        *reinterpret_cast<float2*>(cg + (size_t)grow * p.ldc + col) = make_float2(c0, c1);
        *reinterpret_cast<float2*>(tg + (size_t)grow * p.ldt + col) = tv;
      }
    }
  }
}

// A chain layer: its products, then its rows of s loaded, then (both
// consumers done reading the source tile) its epilogue.  (A bulk prefetch
// of the tile's rows of s_{l-1} into L2 while the products run measured no
// faster.)
template <int NW>
__device__ __forceinline__ void u32_chain(const U32Args& p, int l, const unsigned char* src,
                                          unsigned char* dst, uint32_t ring, uint32_t full,
                                          uint32_t empty, int c, int r, int t, int grow0,
                                          int& it) {
  float acc[NW / 2];
  u32_phase_mma<NW>(acc, src, ring, full, empty, c, p.kt, r, t, it);
  float2 sv[NW / 8][2];
  u32_load_s<NW>(sv, p, l, c, t, grow0);
  t32_sync();  // both consumers are done reading the source tile
  if (p.ts[0])
    u32_chain_epilogue<true, NW>(acc, sv, p, l, dst, c, r, t, grow0);
  else
    u32_chain_epilogue<false, NW>(acc, sv, p, l, dst, c, r, t, grow0);
  t32_sync();
}

// A part of a piece of u (EPI_UCHAIN's U and u_acc): the skip's part
// stores u = f32(m_skip * escale); layer 0's, which the same thread runs
// next on the same cells, u = u + m_0 (the skip's part rounded first, then
// layer 0's added).
template <int NW>
__device__ __forceinline__ void u32_piece(const U32Args& p, const U32Phase& ph,
                                          const unsigned char* src, uint32_t ring, uint32_t full,
                                          uint32_t empty, int c, int r, int t, int grow0,
                                          int& it) {
  float acc[NW / 2];
  u32_phase_mma<NW>(acc, src, ring, full, empty, c, p.kt, r, t, it);
  const bool skip = ph.kind == U32_SKIP;
  const int n0 = skip ? ph.row0 - p.Hp : ph.row0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = n0 + c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow >= p.M) continue;
      float2* u = reinterpret_cast<float2*>(p.u + (size_t)grow * p.ldu + col);
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      if (skip) {
        *u = make_float2(__fmul_rn(a0, p.escale), __fmul_rn(a1, p.escale));
      } else {
        const float2 us = *u;
        *u = make_float2(__fadd_rn(us.x, a0), __fadd_rn(us.y, a1));
      }
    }
  }
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    hand_uchain_f32_kernel(const __grid_constant__ U32Args p) {
  extern __shared__ __align__(128) unsigned char u32_smem[];
  const uint32_t raw = wg::smem_u32(u32_smem);
  const uint32_t t0 = (raw + 1023) & ~1023u;
  unsigned char* t0_ptr = u32_smem + (t0 - raw);
  unsigned char* t1_ptr = t0_ptr + TF32_ACT_BYTES;
  const uint32_t ring = t0 + 2 * TF32_ACT_BYTES;
  const uint32_t full = ring + TF32_UC_RING_BYTES, empty = full + 8 * TF32_UC_STAGES;
  const int warpgroup = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF32_UC_STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, wg::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int l = 0; l + 1 < p.n_layers; ++l) wg::prefetch_map(&p.w[l]);
      u32_produce(p, ring, full, empty);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg::CONSUMER_REGS));
  const int c = warpgroup - 1;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const bool with_u = p.u != nullptr;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int grow0 = tile * TF32_TILE + r;
    u32_seed(p, t0_ptr, tile);
    t32_sync();
    for (int q = 0; q < p.n_phases; ++q) {
      const U32Phase& ph = p.ph[q];
      if (ph.kind == U32_CHAIN) {
        // with u the skip writes t tile 1 and tile 0 keeps the skip's t
        const int l = ph.layer;
        const unsigned char* src = with_u && l < p.skip ? t1_ptr : t0_ptr;
        unsigned char* dst = with_u && l <= p.skip ? t1_ptr : t0_ptr;
        if (ph.width == 256)
          u32_chain<128>(p, l, src, dst, ring, full, empty, c, r, t, grow0, it);
        else if (ph.width == 128)
          u32_chain<64>(p, l, src, dst, ring, full, empty, c, r, t, grow0, it);
        else
          u32_chain<32>(p, l, src, dst, ring, full, empty, c, r, t, grow0, it);
        continue;
      }
      const unsigned char* src = ph.kind == U32_SKIP ? t0_ptr : t1_ptr;
      if (ph.width == 256)
        u32_piece<128>(p, ph, src, ring, full, empty, c, r, t, grow0, it);
      else if (ph.width == 128)
        u32_piece<64>(p, ph, src, ring, full, empty, c, r, t, grow0, it);
      else
        u32_piece<32>(p, ph, src, ring, full, empty, c, r, t, grow0, it);
    }
  }
}

}  // namespace honerf

// The f32 trunk forward on the first M rows of e (f32, rows lde apart, Ep
// columns): layer l's split weights wsplit[l] = [big; small] of W_l^T
// (2 cols[l] rows of rows[l] f32: fused_fine.tf32_operands), f32 biases
// bs[l] (of the skip, rows [Hp | Ep]).  Outputs: ss[l] = sigmoid(beta z_l)
// (f32, ss + l ss_layer, rows lds apart), with acts (optional) acts[l] =
// softplus(z_l) (rows ldact apart) for l < n - 1; with z (optional) the
// last layer z + b into z's first n_store columns (rows ldz apart), else
// the last layer is not formed.  Refused (cudaErrorInvalidValue): shapes
// the tiles do not hold (Hp not 64, 128 or 256, Ep not a multiple of 64,
// rows that do not chain), operands TMA or the vector stores cannot take.
extern "C" int honerf_trunk_fwd_f32(const float* e, int lde, int M, int Ep, int Hp, int n_layers,
                                    int skip, const void* const* wsplit, const int* rows,
                                    const int* cols, const void* const* bs, float skip_scale,
                                    float* ss, long long ss_layer, int lds, void* const* acts,
                                    int ldact, float* z, int ldz, int n_store,
                                    cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (n_layers < 3 || n_layers > TF32_MAX_LAYERS || skip <= 0 || skip >= n_layers - 1 ||
      (Hp != 64 && Hp != 128 && Hp != 256) || Ep <= 0 || Ep % 64 || M < 0 || lde % 4 ||
      honerf_misaligned16(e) || !ss || honerf_misaligned16(ss) || lds % 4 || ss_layer % 4 ||
      (acts && ldact % 2) || (z && (n_store <= 0 || n_store > cols[n_layers - 1])))
    return (int)cudaErrorInvalidValue;
  T32Args p{};
  int n_ph = 0;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l + 1 == n_layers;
    const int want_rows = l == 0 ? Ep : (l == skip ? Hp + Ep : Hp);
    if (rows[l] != want_rows || (!last && cols[l] != Hp) || cols[l] % 64 ||
        honerf_misaligned16(bs[l]) ||
        (acts && !last && (!acts[l] || honerf_misaligned16(acts[l]))) ||
        !wg::tma_map(&p.w[l], wsplit[l], rows[l], 2 * cols[l], rows[l], TF32_BK, TF32_BOX_ROWS,
                     4))
      return (int)cudaErrorInvalidValue;
    p.bias[l] = static_cast<const float*>(bs[l]);
    p.out_rows[l] = cols[l];
    if (!last) {
      p.acts[l] = acts ? static_cast<float*>(acts[l]) : nullptr;
      if (n_ph >= TF32_MAX_PHASES) return (int)cudaErrorInvalidValue;
      p.ph[n_ph++] = T32Phase{l == 0 ? 0 : Hp / TF32_BK,
                              (l == 0 || l == skip) ? Ep / TF32_BK : 0, l == 0 ? 0 : Hp,
                              l == skip ? 1 : 0, l, 0, Hp, T32_HIDDEN};
    } else if (z) {
      for (int n0 = 0; n0 < n_store;) {
        const int rem = cols[l] - n0;
        const int width = rem >= 256 ? 256 : (rem >= 128 ? 128 : 64);
        if (n_ph >= TF32_MAX_PHASES) return (int)cudaErrorInvalidValue;
        p.ph[n_ph++] = T32Phase{Hp / TF32_BK, 0, 0, 0, l, n0, width, T32_Z};
        n0 += width;
      }
    }
  }
  if (M == 0) return (int)cudaGetLastError();
  if (!wg::tma_map(&p.e, e, Ep, M, lde, TF32_BK, TF32_TILE, 4)) return (int)cudaErrorInvalidValue;
  p.ss = ss;
  p.ss_layer = ss_layer;
  p.lds = lds;
  p.ldact = ldact;
  p.z = z;
  p.ldz = ldz;
  p.n_store = n_store;
  p.M = M;
  p.tiles = (M + TF32_TILE - 1) / TF32_TILE;
  p.n_phases = n_ph;
  p.skip_scale = skip_scale;
  static bool smem_set = false;
  const cudaError_t err = t32_smem_ready((const void*)hand_trunk_fwd_f32_kernel, TF32_SMEM_BYTES,
                                         smem_set);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < wg::sm_count() ? p.tiles : wg::sm_count();
  hand_trunk_fwd_f32_kernel<<<grid, wg::THREADS, TF32_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// The f32 u-chain of the same M points from the forward's sigmoid rows (ss,
// f32, ss + l ss_layer, rows lds apart): wsplit[l] = [big; small] of W_l
// (2 in_cols[l] rows of Hp f32) for l < n - 1; w_last = ws[n-1] (Hp rows
// ldw apart: column 0 seeds the chain); hscale and escale the skip's two
// scales.  Outputs, each optional: u (M, Ep) f32 rows ldu apart (null:
// layer 0 and the skip's embedding columns are not formed); with keep,
// ts[l] (l < n - 1, rows ldt apart) and cs[l] (1 <= l < n - 1, rows ldc
// apart), both f32.  Refused: as honerf_trunk_fwd_f32.
extern "C" int honerf_trunk_uchain_f32(int M, int Ep, int Hp, int n_layers, int skip,
                                       const void* const* wsplit, const int* in_cols,
                                       const float* w_last, int ldw, const float* ss,
                                       long long ss_layer, int lds, float hscale, float escale,
                                       float* u, int ldu, void* const* ts, int ldt,
                                       void* const* cs, int ldc, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (n_layers < 3 || n_layers > TF32_MAX_LAYERS || skip <= 0 || skip >= n_layers - 1 ||
      (Hp != 64 && Hp != 128 && Hp != 256) || Ep <= 0 || Ep % 64 || M < 0 || !ss ||
      honerf_misaligned16(ss) || lds % 4 || ss_layer % 4 ||
      (u && (ldu % 2 || honerf_misaligned16(u))) || (ts && ldt % 4) || (cs && ldc % 2) ||
      !ts != !cs)
    return (int)cudaErrorInvalidValue;
  U32Args p{};
  for (int l = 0; l + 1 < n_layers; ++l) {
    const int want = l == 0 ? Ep : (l == skip ? Hp + Ep : Hp);
    if (in_cols[l] != want || (ts && (!ts[l] || honerf_misaligned16(ts[l]))) ||
        (cs && l > 0 && (!cs[l] || honerf_misaligned16(cs[l]))) ||
        !wg::tma_map(&p.w[l], wsplit[l], Hp, 2 * in_cols[l], Hp, TF32_BK, TF32_BOX_ROWS, 4))
      return (int)cudaErrorInvalidValue;
    p.in_rows[l] = in_cols[l];
    p.ts[l] = ts ? static_cast<float*>(ts[l]) : nullptr;
    p.cs[l] = cs && l > 0 ? static_cast<float*>(cs[l]) : nullptr;
  }
  if (M == 0) return (int)cudaGetLastError();
  p.w_last = w_last;
  p.ldw = ldw;
  p.ss = ss;
  p.ss_layer = ss_layer;
  p.lds = lds;
  p.u = u;
  p.ldu = ldu;
  p.ldt = ldt;
  p.ldc = ldc;
  p.M = M;
  p.tiles = (M + TF32_TILE - 1) / TF32_TILE;
  p.n_layers = n_layers;
  p.skip = skip;
  p.Hp = Hp;
  p.Ep = Ep;
  p.kt = Hp / TF32_BK;
  int n_ph = 0;
  for (int l = n_layers - 2; l > 0; --l) p.ph[n_ph++] = U32Phase{l, 0, Hp, U32_CHAIN};
  for (int n0 = 0; u && n0 < Ep;) {
    const int rem = Ep - n0;
    const int width = rem >= TF32_PIECE ? TF32_PIECE : (rem >= 128 ? 128 : 64);
    if (n_ph + 2 > TF32_UC_MAX_PHASES) return (int)cudaErrorInvalidValue;
    p.ph[n_ph++] = U32Phase{skip, Hp + n0, width, U32_SKIP};
    p.ph[n_ph++] = U32Phase{0, n0, width, U32_ZERO};
    n0 += width;
  }
  p.n_phases = n_ph;
  p.hscale = hscale;
  p.escale = escale;
  static bool smem_set = false;
  const cudaError_t err = t32_smem_ready((const void*)hand_uchain_f32_kernel, TF32_UC_SMEM_BYTES,
                                         smem_set);
  if (err != cudaSuccess) return (int)err;
  const int grid = p.tiles < wg::sm_count() ? p.tiles : wg::sm_count();
  hand_uchain_f32_kernel<<<grid, wg::THREADS, TF32_UC_SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}
