// The f32 color net in two launches: its forward (color_fwd_f32_kernel)
// and its transpose (color_bwd_f32_kernel) (ops/fused_fine_full.py:
// color_fwd_f32, color_bwd_f32; K2's passes and K3's recompute call the
// forward, K3's passes the transpose).
//
// Replaces: the f32 mode of `_color_fwd_block` (honerf_tpu/ops/
//   fused_fine_full.py:854-869, called from `_fine_fwd_block` :959) inside
//   K2's pallas_call (:1556) and K3's recompute, and of `_color_bwd_block`
//   (:872-913, with res_stash: the sigmoid read back, the relu masks from
//   the kept activations) inside K3's pallas_call (:1650), with
//   FineMeta(dtype='f32').  The split launches they replace (one
//   gemm_f32_kernel a layer; color_dz_kernel before the transpose's) stay
//   callable for comparison only (fused_fine_full._color_fwd_split,
//   _color_bwd_split).
//
// What bounds them on an H100: operations.  The forward's products, [e
//   1408 | feat 256 | grad-PE 128] -> 256 -> 256 -> 256 -> 256 -> 64, are
//   ~1.24 MFLOP a point, the transpose's the same; as 3xTF32 (tf32.cuh) the
//   card's 495 TF32 TFLOP/s give 165 of f32 work: ~7.5 ms per million
//   points each, an f32 step's 56,448 points 0.42 ms.  Their bytes: e and
//   [feat | grad-PE] read (7 KB a point), with keep the four relu rows
//   written (4 KB); the transpose reads those rows and writes dx (7 KB)
//   and with dW the five dz rows (4.3 KB): ~0.2-0.3 of the operation bound.
//   The weights' [big; small] rows (~4.5 MB a kernel) stay in L2.
//
// Design (the f32 trunk's, csrc/trunk_fused_f32.cu and trunk_bwd_f32.cu,
//   whose ring shell tf32.cuh holds for both sources): one persistent
//   block an SM walks tiles of TF32_TILE = 64 points;
//   warpgroup 0's first thread streams each phase's K steps of B (and A's
//   boxes where A is not the tile) by TMA into a 4-slot ring, two slots a
//   K step (B's small rows with the box, then B's big rows); warpgroups 1
//   and 2 read all 64 rows of A and each computes half of the phase's
//   columns into a fresh accumulator a 32-deep step, added to the running
//   sum with round to nearest (t32_steps).  B is split once per weight
//   snapshot (fused_fine.tf32_operands), A in registers.  Shared memory:
//   the 64 KB activation tile and four 40 KB slots, 225 KB.
//
//  * The forward: layer 0 over two K ranges of boxes, e's Ep / 32 (box map
//    0) then [feat | grad-PE]'s (map 1, cx2), B's k running on across both;
//    layers 1 .. n-2 over the tile; each epilogue relu(acc + b) in place
//    into the tile (once both consumers are done reading it), with keep
//    also to acts[l] for the transpose's masks and the dW launch; the last
//    layer (64 columns, m64n32k8 a consumer) stores sigmoid(acc + b) of its
//    3 real columns into packed[:, 4:7] (rows 8 apart: scalar stores).
//  * The transpose: a tile's prologue forms dz = s (1 - s) dcolor (s read
//    back from packed) on the last layer's 64 columns into the tile, with dW
//    also to dz[n-1]; then for layers n-1 .. 1 da = dz W_l^T over the tile
//    (B = [big; small] of W_l: tf32_operands(w, False)), masked by acts[l-1]
//    > 0 (the rows loaded before the consumers' barrier) in place into the
//    tile, with dW to dz[l-1]; then dx = dz_0 W_0^T over the tile in pieces
//    of 256 columns (CF32_PIECE; 128 or 64 for the rest), each stored
//    straight to dx: no tile or slot holds dx's 1792 columns.
//
//   ops/wgmma_layout.py: cf32_fwd_phases / cf32_bwd_phases / cf32_loads
//   model the tables; ring_schedule(pairs=True) the barriers
//   (tests/test_torch_color_f32_layout.py).  New bits are expected against
//   the split launches: wgmma's internal order is not mma.sync's.

#include "tf32.cuh"

namespace honerf {

constexpr int CF32_MAX_PHASES = 24;
constexpr int CF32_PIECE = 256;                    // dx columns a piece
constexpr int CF32_SMEM_BYTES = TF32_SMEM_BYTES;   // the tile and the 4-slot ring
constexpr int CF32_COLORS = 3;                     // the real columns of the last layer

enum CF32Kind { CF32_RELU = 0, CF32_SIGMOID = 1, CF32_MASK = 2, CF32_DX = 3 };

// The phases of a tile (tf32.cuh's ring shell).
using CF32Phase = T32RingPhase;
using CF32Ring = T32Ring<CF32_MAX_PHASES>;

// ---------------------------------------------------------------------------
// color_fwd_f32_kernel
// ---------------------------------------------------------------------------

struct CF32FwdArgs {
  CF32Ring q;                           // boxes: e, cx2; w: [big; small] of W_l^T
  const float* bias[TF32_MAX_LAYERS];
  float* acts[TF32_MAX_LAYERS];         // keep: relu of layer l (l < n - 1), or null
  int ldact;
  float* color;                         // the sigmoid's 3 columns, rows ldcolor apart
  int ldcolor, M;
};

// A relu layer's epilogue: relu(acc + b) in place into the tile and, with
// kKeep, acts[l].  acc[4j + q] holds tile row r + 8 (q >> 1), column c NW +
// 8j + 2t + (q & 1).
template <bool kKeep, int NW>
__device__ __forceinline__ void cf32_relu_epilogue(const float (&acc)[NW / 2],
                                                   const CF32FwdArgs& p, int l,
                                                   unsigned char* tile, int c, int r, int t,
                                                   int grow0) {
  const float* bias = p.bias[l];
  float* ag = kKeep ? p.acts[l] : nullptr;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = make_float2(fmaxf(acc[4 * j + 2 * h] + b.x, 0.f),
                                   fmaxf(acc[4 * j + 2 * h + 1] + b.y, 0.f));
      *reinterpret_cast<float2*>(tile + t32_offset(r + 8 * h, col)) = v;
      const int grow = grow0 + 8 * h;
      if (kKeep && grow < p.M) *reinterpret_cast<float2*>(ag + (size_t)grow * p.ldact + col) = v;
    }
  }
}

// The last layer's epilogue: sigmoid(acc + b) (EPI_SIGMOID's f32
// arithmetic) of its first CF32_COLORS columns.
template <int NW>
__device__ __forceinline__ void cf32_sigmoid_epilogue(const float (&acc)[NW / 2],
                                                      const CF32FwdArgs& p, int l, int c, int t,
                                                      int grow0) {
  const float* bias = p.bias[l];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
    if (col >= CF32_COLORS) continue;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow >= p.M) continue;
      float* out = p.color + (size_t)grow * p.ldcolor + col;
      out[0] = 1.f / (1.f + expf(-(acc[4 * j + 2 * h] + b.x)));
      if (col + 1 < CF32_COLORS) out[1] = 1.f / (1.f + expf(-(acc[4 * j + 2 * h + 1] + b.y)));
    }
  }
}

template <int NW>
__device__ __forceinline__ void cf32_fwd_phase(const CF32FwdArgs& p, const CF32Phase& ph,
                                               unsigned char* tile, const unsigned char* ring_ptr,
                                               uint32_t ring, uint32_t full, uint32_t empty,
                                               int c, int r, int t, int grow0, int& it) {
  float acc[NW / 2];
  t32_ring_mma<NW>(acc, ph, tile, ring_ptr, ring, full, empty, c, r, t, it);
  if (ph.kind == CF32_SIGMOID) {
    cf32_sigmoid_epilogue<NW>(acc, p, ph.layer, c, t, grow0);
    return;
  }
  t32_sync();  // both consumers are done reading the tile
  if (p.acts[0])
    cf32_relu_epilogue<true, NW>(acc, p, ph.layer, tile, c, r, t, grow0);
  else
    cf32_relu_epilogue<false, NW>(acc, p, ph.layer, tile, c, r, t, grow0);
  t32_sync();  // the next layer reads the whole tile
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    color_fwd_f32_kernel(const __grid_constant__ CF32FwdArgs p) {
  extern __shared__ __align__(128) unsigned char cf32f_smem[];
  t32_ring_kernel(
      p, cf32f_smem, [](unsigned char*, int) {},
      [&](const CF32Phase& ph, unsigned char* tile, const unsigned char* ring_ptr,
          uint32_t ring, uint32_t full, uint32_t empty, int c, int r, int t, int grow0,
          int& it) {
        if (ph.width == 256)
          cf32_fwd_phase<128>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
        else if (ph.width == 128)
          cf32_fwd_phase<64>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
        else
          cf32_fwd_phase<32>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
      });
}

// ---------------------------------------------------------------------------
// color_bwd_f32_kernel
// ---------------------------------------------------------------------------

struct CF32BwdArgs {
  CF32Ring q;                           // w: [big; small] of W_l
  const float* s;                       // the forward's sigmoid (3 columns), rows lds apart
  int lds;
  const float* dcolor;                  // (M, 3), rows lddc apart
  int lddc;
  const float* acts[TF32_MAX_LAYERS];   // relu of layer l (l < n - 1): layer l + 1's mask
  int ldact;
  float* dz[TF32_MAX_LAYERS];           // with dW: dz_l (l < n), rows lddz apart, or null
  int lddz;
  float* dx;                            // (M, the input's width), rows lddx apart
  int lddx;
  int M, n_layers, top;                 // top: the last layer's columns (dz_{n-1}'s)
};

// A tile's dz_{n-1} = s (1 - s) dcolor (color_dz_kernel's arithmetic) on
// the last layer's `top` columns, zero past the colors and past M, into the
// tile and, with dW, dz[n-1]: the 256 consumer threads a cell each in turn.
__device__ __forceinline__ void cf32_seed(const CF32BwdArgs& p, unsigned char* tile, int tl) {
  t32_sync();  // both consumers are done reading the last tile
  float* dz = p.dz[p.n_layers - 1];
  for (int i = threadIdx.x - 128; i < TF32_TILE * p.top; i += 256) {
    const int row = i / p.top, col = i % p.top, grow = tl * TF32_TILE + row;
    float v = 0.f;
    if (grow < p.M && col < CF32_COLORS) {
      const float s = p.s[(size_t)grow * p.lds + col];
      v = s * (1.f - s) * p.dcolor[(size_t)grow * p.lddc + col];
    }
    *reinterpret_cast<float*>(tile + t32_offset(row, col)) = v;
    if (dz && grow < p.M) dz[(size_t)grow * p.lddz + col] = v;
  }
  t32_sync();  // the first phase reads the whole seed
}

// A layer's transpose: its products, then the mask's rows loaded, then
// (both consumers done reading the tile) dz_{l-1} = acts[l-1] > 0 ? da : 0
// in place into the tile and, with dW, dz[l-1] (EPI_MASK's arithmetic).
template <int NW>
__device__ __forceinline__ void cf32_mask(const CF32BwdArgs& p, const CF32Phase& ph,
                                          unsigned char* tile, const unsigned char* ring_ptr,
                                          uint32_t ring, uint32_t full, uint32_t empty, int c,
                                          int r, int t, int grow0, int& it) {
  const int l = ph.layer;
  float acc[NW / 2];
  t32_ring_mma<NW>(acc, ph, tile, ring_ptr, ring, full, empty, c, r, t, it);
  float2 av[NW / 8][2];
  t32_load_rows<NW>(av, p.acts[l - 1], p.ldact, p.M, c, t, grow0);
  float* dz = p.dz[l - 1];
  t32_sync();  // both consumers are done reading the tile
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      const float2 v = make_float2(av[j][h].x > 0.f ? acc[4 * j + 2 * h] : 0.f,
                                   av[j][h].y > 0.f ? acc[4 * j + 2 * h + 1] : 0.f);
      *reinterpret_cast<float2*>(tile + t32_offset(r + 8 * h, col)) = v;
      if (dz && grow < p.M) *reinterpret_cast<float2*>(dz + (size_t)grow * p.lddz + col) = v;
    }
  }
  t32_sync();  // the next layer reads the whole tile
}

// A piece of dx = dz_0 W_0^T: its columns row0 .. row0 + width straight to
// dx (EPI_F32: no bias, nothing after the sum).
template <int NW>
__device__ __forceinline__ void cf32_dx(const CF32BwdArgs& p, const CF32Phase& ph,
                                        unsigned char* tile, const unsigned char* ring_ptr,
                                        uint32_t ring, uint32_t full, uint32_t empty, int c,
                                        int r, int t, int grow0, int& it) {
  float acc[NW / 2];
  t32_ring_mma<NW>(acc, ph, tile, ring_ptr, ring, full, empty, c, r, t, it);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = ph.row0 + c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow < p.M)
        *reinterpret_cast<float2*>(p.dx + (size_t)grow * p.lddx + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int NW>
__device__ __forceinline__ void cf32_bwd_phase(const CF32BwdArgs& p, const CF32Phase& ph,
                                               unsigned char* tile, const unsigned char* ring_ptr,
                                               uint32_t ring, uint32_t full, uint32_t empty,
                                               int c, int r, int t, int grow0, int& it) {
  if (ph.kind == CF32_MASK)
    cf32_mask<NW>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
  else
    cf32_dx<NW>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    color_bwd_f32_kernel(const __grid_constant__ CF32BwdArgs p) {
  extern __shared__ __align__(128) unsigned char cf32b_smem[];
  t32_ring_kernel(
      p, cf32b_smem, [&](unsigned char* tile, int tl) { cf32_seed(p, tile, tl); },
      [&](const CF32Phase& ph, unsigned char* tile, const unsigned char* ring_ptr,
          uint32_t ring, uint32_t full, uint32_t empty, int c, int r, int t, int grow0,
          int& it) {
        if (ph.width == 256)
          cf32_bwd_phase<128>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
        else if (ph.width == 128)
          cf32_bwd_phase<64>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
        else
          cf32_bwd_phase<32>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
      });
}

// A layer's columns: one phase of 64, 128 or 256 (the last layer's 3
// colors padded to 64).
static bool cf32_width_ok(int w) { return w == 64 || w == 128 || w == 256; }

// Launch one of the two kernels on M points: the grid, one block an SM.
template <class Args>
static cudaError_t cf32_launch(void (*kernel)(Args), const Args& p, cudaStream_t stream,
                               bool& smem_set) {
  const cudaError_t err = t32_smem_ready((const void*)kernel, CF32_SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return err;
  const int grid = p.q.tiles < wg::sm_count() ? p.q.tiles : wg::sm_count();
  kernel<<<grid, wg::THREADS, CF32_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace honerf

// The f32 color net's forward on M points: its input [e | cx2] (f32; e's
// first Ep columns, rows lde apart, then cx2's first X, rows ldx apart);
// layer l's split weights wsplit[l] = [big; small] of W_l^T (2 cols[l]
// rows of rows[l] f32: fused_fine.tf32_operands(w, True)) and f32 biases
// bs[l].  Outputs: color[grow * ldcolor + c] = sigmoid of the last layer's
// column c < 3 (ldcolor 8: packed[:, 4:7]) and, with acts (optional),
// acts[l] = relu of layer l (l < n - 1, f32, rows ldact apart).  Refused
// (cudaErrorInvalidValue): shapes the tiles do not hold (hidden and last
// widths not 64, 128 or 256, Ep or X not a multiple of 64, rows that do
// not chain), operands TMA or the vector stores cannot take.
extern "C" int honerf_color_fwd_f32(const float* e, int lde, int Ep, const float* cx2, int ldx,
                                    int X, int M, int n_layers, const void* const* wsplit,
                                    const int* rows, const int* cols, const void* const* bs,
                                    float* color, int ldcolor, void* const* acts, int ldact,
                                    cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (n_layers < 2 || n_layers > TF32_MAX_LAYERS || Ep <= 0 || Ep % 64 || X <= 0 || X % 64 ||
      M < 0 || lde % 4 || ldx % 4 || honerf_misaligned16(e) || honerf_misaligned16(cx2) ||
      !color || ldcolor < CF32_COLORS || (acts && ldact % 2))
    return (int)cudaErrorInvalidValue;
  CF32FwdArgs p{};
  const int H = cols[0];
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l + 1 == n_layers;
    if (rows[l] != (l == 0 ? Ep + X : H) || !cf32_width_ok(cols[l]) || (!last && cols[l] != H) ||
        honerf_misaligned16(bs[l]) ||
        (acts && !last && (!acts[l] || honerf_misaligned16(acts[l]))) ||
        !wg::tma_map(&p.q.w[l], wsplit[l], rows[l], 2 * cols[l], rows[l], TF32_BK, TF32_BOX_ROWS,
                     4))
      return (int)cudaErrorInvalidValue;
    p.bias[l] = static_cast<const float*>(bs[l]);
    p.acts[l] = acts && !last ? static_cast<float*>(acts[l]) : nullptr;
    p.q.small_rows[l] = cols[l];
    // layer 0 over e's boxes, then cx2's; the others over the tile
    p.q.ph[l] = CF32Phase{l == 0 ? 0 : H / TF32_BK, l == 0 ? Ep / TF32_BK : 0,
                          l == 0 ? X / TF32_BK : 0, l, 0, cols[l],
                          last ? CF32_SIGMOID : CF32_RELU};
  }
  if (M == 0) return (int)cudaGetLastError();
  if (!wg::tma_map(&p.q.box[0], e, Ep, M, lde, TF32_BK, TF32_TILE, 4) ||
      !wg::tma_map(&p.q.box[1], cx2, X, M, ldx, TF32_BK, TF32_TILE, 4))
    return (int)cudaErrorInvalidValue;
  p.q.n_phases = p.q.n_maps = n_layers;
  p.q.n_boxes = 2;
  p.q.tiles = (M + TF32_TILE - 1) / TF32_TILE;
  p.ldact = ldact;
  p.color = color;
  p.ldcolor = ldcolor;
  p.M = M;
  static bool smem_set = false;
  return (int)cf32_launch(color_fwd_f32_kernel, p, stream, smem_set);
}

// The f32 color net's transpose on the same M points: wsplit[l] = [big;
// small] of W_l (2 in_cols[l] rows of out_cols[l] f32:
// fused_fine.tf32_operands(w, False)); s the forward's sigmoid (3 columns,
// rows lds apart: packed[:, 4:7]), dcolor (M, 3) rows lddc apart, the
// forward's kept relu rows acts[l] (l < n - 1, rows ldact apart).
// Outputs: dx (M, in_cols[0]) f32 rows lddx apart and, with dz
// (optional), dz[l] (l < n, out_cols[l] columns, rows lddz apart).
// Refused: as honerf_color_fwd_f32.
extern "C" int honerf_color_bwd_f32(int M, int n_layers, const void* const* wsplit,
                                    const int* in_cols, const int* out_cols, const float* s,
                                    int lds, const float* dcolor, int lddc,
                                    const void* const* acts, int ldact, float* dx, int lddx,
                                    void* const* dz, int lddz, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (n_layers < 2 || n_layers > TF32_MAX_LAYERS || M < 0 || !s || !dcolor || !acts || !dx ||
      honerf_misaligned16(dx) || lddx % 2 || ldact % 2 || (dz && lddz % 2) ||
      in_cols[0] <= 0 || in_cols[0] % 64)
    return (int)cudaErrorInvalidValue;
  CF32BwdArgs p{};
  const int H = out_cols[0];
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l + 1 == n_layers;
    if (!cf32_width_ok(out_cols[l]) || (!last && out_cols[l] != H) ||
        (l > 0 && in_cols[l] != H) ||
        (!last && (!acts[l] || honerf_misaligned16(acts[l]))) ||
        (dz && (!dz[l] || honerf_misaligned16(dz[l]))) ||
        !wg::tma_map(&p.q.w[l], wsplit[l], out_cols[l], 2 * in_cols[l], out_cols[l], TF32_BK,
                     TF32_BOX_ROWS, 4))
      return (int)cudaErrorInvalidValue;
    p.q.small_rows[l] = in_cols[l];
    p.acts[l] = last ? nullptr : static_cast<const float*>(acts[l]);
    p.dz[l] = dz ? static_cast<float*>(dz[l]) : nullptr;
  }
  // the top layer over the seed's out_cols[n-1] / 32 K steps, the others
  // over H / 32; then dx's pieces of 256, 128 or 64 columns
  int n_ph = 0;
  for (int l = n_layers - 1; l > 0; --l)
    p.q.ph[n_ph++] = CF32Phase{out_cols[l] / TF32_BK, 0, 0, l, 0, H, CF32_MASK};
  for (int n0 = 0; n0 < in_cols[0];) {
    const int rem = in_cols[0] - n0;
    const int width = rem >= CF32_PIECE ? CF32_PIECE : (rem >= 128 ? 128 : 64);
    if (n_ph >= CF32_MAX_PHASES) return (int)cudaErrorInvalidValue;
    p.q.ph[n_ph++] = CF32Phase{H / TF32_BK, 0, 0, 0, n0, width, CF32_DX};
    n0 += width;
  }
  if (M == 0) return (int)cudaGetLastError();
  p.q.n_phases = n_ph;
  p.q.n_maps = n_layers;
  p.q.n_boxes = 0;
  p.q.tiles = (M + TF32_TILE - 1) / TF32_TILE;
  p.s = s;
  p.lds = lds;
  p.dcolor = dcolor;
  p.lddc = lddc;
  p.ldact = ldact;
  p.lddz = lddz;
  p.dx = dx;
  p.lddx = lddx;
  p.M = M;
  p.n_layers = n_layers;
  p.top = out_cols[n_layers - 1];
  static bool smem_set = false;
  return (int)cf32_launch(color_bwd_f32_kernel, p, stream, smem_set);
}
