// The f32 hand trunk's backward in two launches: the u-chain transposed,
// upward (hand_trunk_ut_f32_kernel), then the forward transposed, downward
// (hand_trunk_dz_f32_kernel) (ops/fused_fine.py: trunk_ut, trunk_dz on an
// f32 trunk; cuda_trunk_backward calls them for K3 and K6).
//
// Replaces: the f32 mode of `_trunk_bwd_block`'s two chains
//   (honerf_tpu/ops/fused_fine.py:342; the upward loop :363-381, the
//   downward one :382-401) inside K6's pallas_call (:488) and K3's
//   (honerf_tpu/ops/fused_fine_full.py:1650) with FineMeta(dtype='f32').
//   The split launches they replace (one gemm_f32_kernel a layer with the
//   EPI_UT or EPI_DZ epilogue, common.cuh) stay callable for comparison
//   only (fused_fine.cuda_trunk_backward_split).  The weight gradients
//   (gemm_tn_f32_kernel, colsum_partial_kernel) run after the chains on
//   the rows these kernels keep.
//
// What bounds them on an H100: operations.  The chains do the products of
//   K5's trunk and u-chain, run backward: up 1386 -> 256, 3 x 256 -> 256,
//   (256 + 1386) -> 256, 3 x 256 -> 256 (~2.34 MFLOP a point); down
//   257 -> 256, 3 x 256 -> 256, 256 -> (256 + 1386), 3 x 256 -> 256,
//   256 -> 1386 (~2.47).  As 3xTF32 (tf32.cuh) the card's 495 TF32
//   TFLOP/s give 165 of f32 work: ~29 ms per million points, an f32
//   step's 56,448 points 1.644 ms.  Their bytes: du read twice (du_b,
//   du_s: 5.6 KB each), the sigmoid rows read twice (8 KB each), the c
//   rows (7 KB), ds written and read (8 KB each), the top cotangent (1.3
//   KB) and de (5.6 KB), with dW every dm and dz row (8 KB each): ~75 KB a
//   point with dW, ~1.3 ms an f32 step at 3.35 TB/s.  The weights' [big;
//   small] rows (~10 MB a kernel) stay in L2.
//
// Design (csrc/trunk_fused_f32.cu's forward, whose shape both chains
//   repeat; the ring shell, tf32.cuh's t32_ring_kernel, is shared with
//   csrc/color_fused_f32.cu): one persistent block an SM walks tiles of
//   TF32_TILE = 64 points; warpgroup 0's first thread streams each phase's
//   K steps of B (and A's boxes where A is not the tile) by TMA into a
//   4-slot ring, two slots a K step (B's small rows with the box, then B's
//   big rows);
//   warpgroups 1 and 2 read all 64 rows of A and each computes half of
//   the phase's columns into a fresh accumulator a 32-deep step, added to
//   the running sum with round to nearest (t32_steps).
//
//  * The upward chain is the forward's shape: dt_l = dm_l W_l, B the
//   forward's [big; small] of W_l^T (fused_fine.tf32_operands(w, True)).
//   Layer 0 reads du_b = du in boxes of 64 x 32 riding in the small slot,
//   as the forward reads e; layers 1 .. n-2 the dm tile; the skip the tile,
//   then du_s's boxes (du / sqrt2, already scaled: nothing scales A).  Each
//   layer's epilogue is EPI_UT's: ds_l = dt_l c_{l+1} to ds[l] (f32; c_{n-1}
//   the one row c_last), the next tile dm_{l+1} = (dt_l s_l) hscale (hscale
//   1/sqrt2 into the skip), with keep also to dm[l + 1] for the dW launches.
//   Shared memory: the 64 KB dm tile and four 40 KB slots (the box and
//   256 B rows x 32 k), 225 KB.
//  * The downward chain is the u-chain's shape: din = dz_l W_l^T, B the
//   u-chain's [big; small] of W_l (tf32_operands(w, False)).  The top layer
//   reads the top cotangent dz_{n-1} (Op columns) in boxes, as layer 0 of
//   the upward chain reads du; each later layer the dz tile.  Each chain
//   epilogue is EPI_DZ's, dz_{l-1} = (din hscale) s_{l-1} + ds_{l-1} ((beta s)
//   (1 - s)) in place into the tile, with keep to dz[l - 1] (once: the split
//   launches wrote it twice, dzf and dzb).  de in pieces of 256, 128 or 64
//   columns: at the skip, before its chain part overwrites dz_skip, each
//   piece's skip part (W_skip's rows from Hp + n0) stored as f32(acc /
//   sqrt2); after layer 1, each piece's layer-0 part (W_0's rows from n0),
//   de = that + acc, read back by the thread that stored it (EPI_DZ's u_acc
//   order).  One tile and the upward kernel's ring: 225 KB.  (Two tiles,
//   dz_skip kept in the second to layer 0 as the f32 u-chain keeps t, with
//   three 32 KB slots and the top copied in by the consumers, measured the
//   same: PERF.md.)
//
//   Where the time goes (bench_gemm.py --trunk-bwd-variants, 28,288
//   points): the epilogues' row loads and stores, which both consumers
//   wait for in lockstep while the tensor cores idle: ~0.6 ms of the
//   upward kernel's 1.03, and of the downward's 1.33 ~0.4 (its chain) and
//   ~0.45 (de's pieces); 1xTF32 would save ~12%, B's small rows ~3%.
//
//   ops/wgmma_layout.py: tb32_ut_phases / tb32_dz_phases and their loads
//   model the tables; ring_schedule(pairs=True) the barriers
//   (tests/test_torch_trunk_bwd_f32_layout.py).  New bits are expected
//   against the split launches: wgmma's internal order is not mma.sync's.

#include "tf32.cuh"

namespace honerf {

constexpr int TB32_MAX_PHASES = 40;

enum TB32Kind { TB32_UT = 0, TB32_CHAIN = 1, TB32_SKIP = 2, TB32_ZERO = 3 };

// The phases of a tile (tf32.cuh's ring shell): an upward layer, a
// downward chain layer, a piece of de's skip part or its layer-0 part.
using TB32Phase = T32RingPhase;
using TB32Ring = T32Ring<TB32_MAX_PHASES>;

// ---------------------------------------------------------------------------
// hand_trunk_ut_f32_kernel
// ---------------------------------------------------------------------------

struct UT32Args {
  TB32Ring q;                        // boxes: du_b, du_s; w: [big; small] of W_l^T (2 Hp, in_pad)
  const float* ss;                   // ss[l] = ss + l * ss_layer, rows lds apart
  long long ss_layer;
  int lds;
  const float* cs[TF32_MAX_LAYERS];  // c_l (1 <= l < n - 1), rows ldc apart
  int ldc;
  const float* c_last;               // c_{n-1}: one row for every point
  float* ds;                         // ds[l] = ds + l * ds_layer, rows ldds apart
  long long ds_layer;
  int ldds;
  float* dm[TF32_MAX_LAYERS];        // keep: dm_l (1 <= l <= n - 1), rows lddm apart, or null
  int lddm;
  int M, n_layers, skip;
  float hscale;
};

// Layer l's epilogue (EPI_UT's arithmetic): ds_l = dt c_{l+1} to ds[l];
// dm_{l+1} = (dt s_l) hscale into the tile and, with kKeep, dm[l + 1].
template <bool kKeep, int NW>
__device__ __forceinline__ void ut32_epilogue(const float (&acc)[NW / 2],
                                              const float2 (&sv)[NW / 8][2],
                                              const float2 (&cv)[NW / 8][2], const UT32Args& p,
                                              int l, unsigned char* tile, int c, int r, int t,
                                              int grow0) {
  const float hscale = l + 1 == p.skip ? p.hscale : 1.f;
  float* ds = p.ds + l * p.ds_layer;
  float* dm = p.dm[l + 1];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      const float z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
      const float2 dv = make_float2(z0 * cv[j][h].x, z1 * cv[j][h].y);
      const float2 mv = make_float2((z0 * sv[j][h].x) * hscale, (z1 * sv[j][h].y) * hscale);
      *reinterpret_cast<float2*>(tile + t32_offset(r + 8 * h, col)) = mv;
      if (grow < p.M) {
        *reinterpret_cast<float2*>(ds + (size_t)grow * p.ldds + col) = dv;
        if (kKeep) *reinterpret_cast<float2*>(dm + (size_t)grow * p.lddm + col) = mv;
      }
    }
  }
}

// One layer of a tile: its products, its rows of s and c loaded, then
// (both consumers done reading the tile) its epilogue.
template <int NW>
__device__ __forceinline__ void ut32_layer(const UT32Args& p, const TB32Phase& ph,
                                           unsigned char* tile, const unsigned char* ring_ptr,
                                           uint32_t ring, uint32_t full, uint32_t empty, int c,
                                           int r, int t, int grow0, int& it) {
  const int l = ph.layer;
  float acc[NW / 2];
  t32_ring_mma<NW>(acc, ph, tile, ring_ptr, ring, full, empty, c, r, t, it);
  const bool last = l + 2 == p.n_layers;
  float2 sv[NW / 8][2], cv[NW / 8][2];
  t32_load_rows<NW>(sv, p.ss + l * p.ss_layer, p.lds, p.M, c, t, grow0);
  t32_load_rows<NW>(cv, last ? p.c_last : p.cs[l + 1], last ? 0 : p.ldc, p.M, c, t, grow0);
  t32_sync();  // both consumers are done reading the tile
  if (p.dm[l + 1])
    ut32_epilogue<true, NW>(acc, sv, cv, p, l, tile, c, r, t, grow0);
  else
    ut32_epilogue<false, NW>(acc, sv, cv, p, l, tile, c, r, t, grow0);
  t32_sync();  // the next layer reads the whole tile
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    hand_trunk_ut_f32_kernel(const __grid_constant__ UT32Args p) {
  extern __shared__ __align__(128) unsigned char ut32_smem[];
  t32_ring_kernel(p, ut32_smem, [](unsigned char*, int) {},
              [&](const TB32Phase& ph, unsigned char* tile, const unsigned char* ring_ptr,
                  uint32_t ring, uint32_t full, uint32_t empty, int c, int r, int t, int grow0,
                  int& it) {
                if (ph.width == 256)
                  ut32_layer<128>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
                else if (ph.width == 128)
                  ut32_layer<64>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
                else
                  ut32_layer<32>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
              });
}

// ---------------------------------------------------------------------------
// hand_trunk_dz_f32_kernel
// ---------------------------------------------------------------------------

struct DZ32Args {
  TB32Ring q;                        // box 0: the top cotangent; w: [big; small] of W_l
  const float* ss;                   // ss[l] = ss + l * ss_layer, rows lds apart
  long long ss_layer;
  int lds;
  const float* ds;                   // ds[l] = ds + l * ds_layer, rows ldds apart
  long long ds_layer;
  int ldds;
  float* de;                         // (M, Ep) f32, rows ldde apart
  int ldde;
  float* dz[TF32_MAX_LAYERS];        // keep: dz_l (l < n - 1), rows lddz apart, or null
  int lddz;
  int M, skip, Hp;
  float hscale, escale;
};

// A chain layer's epilogue (EPI_DZ's arithmetic): dz_{l-1} = (din hscale)
// s_{l-1} + ds_{l-1} ((beta s) (1 - s)) into the tile and, with kKeep,
// dz[l - 1].
template <bool kKeep, int NW>
__device__ __forceinline__ void dz32_epilogue(const float (&acc)[NW / 2],
                                              const float2 (&sv)[NW / 8][2],
                                              const float2 (&dv)[NW / 8][2], const DZ32Args& p,
                                              int l, unsigned char* tile, int c, int r, int t,
                                              int grow0) {
  const float hscale = l == p.skip ? p.hscale : 1.f;
  float* dz = p.dz[l - 1];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      const float2 s = sv[j][h], d = dv[j][h];
      const float2 v = make_float2(
          (acc[4 * j + 2 * h] * hscale) * s.x + d.x * ((kBeta * s.x) * (1.f - s.x)),
          (acc[4 * j + 2 * h + 1] * hscale) * s.y + d.y * ((kBeta * s.y) * (1.f - s.y)));
      *reinterpret_cast<float2*>(tile + t32_offset(r + 8 * h, col)) = v;
      if (kKeep && grow < p.M) *reinterpret_cast<float2*>(dz + (size_t)grow * p.lddz + col) = v;
    }
  }
}

// A chain layer: its products, its rows of s and ds loaded, then (both
// consumers done reading the tile) its epilogue in place.
template <int NW>
__device__ __forceinline__ void dz32_chain(const DZ32Args& p, const TB32Phase& ph,
                                           unsigned char* tile, const unsigned char* ring_ptr,
                                           uint32_t ring, uint32_t full, uint32_t empty, int c,
                                           int r, int t, int grow0, int& it) {
  const int l = ph.layer;
  float acc[NW / 2];
  t32_ring_mma<NW>(acc, ph, tile, ring_ptr, ring, full, empty, c, r, t, it);
  float2 sv[NW / 8][2], dv[NW / 8][2];
  t32_load_rows<NW>(sv, p.ss + (l - 1) * p.ss_layer, p.lds, p.M, c, t, grow0);
  t32_load_rows<NW>(dv, p.ds + (l - 1) * p.ds_layer, p.ldds, p.M, c, t, grow0);
  t32_sync();  // both consumers are done reading the tile
  if (p.dz[0])
    dz32_epilogue<true, NW>(acc, sv, dv, p, l, tile, c, r, t, grow0);
  else
    dz32_epilogue<false, NW>(acc, sv, dv, p, l, tile, c, r, t, grow0);
  t32_sync();
}

// A part of a piece of de (EPI_DZ's U and u_acc): the skip's part stores
// de = f32(acc * escale); layer 0's, which the same thread runs later on
// the same cells, de = de + acc (the skip's part rounded first, then
// layer 0's added).
template <int NW>
__device__ __forceinline__ void dz32_piece(const DZ32Args& p, const TB32Phase& ph,
                                           const unsigned char* tile,
                                           const unsigned char* ring_ptr, uint32_t ring,
                                           uint32_t full, uint32_t empty, int c, int r, int t,
                                           int grow0, int& it) {
  float acc[NW / 2];
  t32_ring_mma<NW>(acc, ph, tile, ring_ptr, ring, full, empty, c, r, t, it);
  const bool skip = ph.kind == TB32_SKIP;
  const int n0 = skip ? ph.row0 - p.Hp : ph.row0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = n0 + c * NW + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int grow = grow0 + 8 * h;
      if (grow >= p.M) continue;
      float2* de = reinterpret_cast<float2*>(p.de + (size_t)grow * p.ldde + col);
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      if (skip) {
        *de = make_float2(__fmul_rn(a0, p.escale), __fmul_rn(a1, p.escale));
      } else {
        const float2 prev = *de;
        *de = make_float2(__fadd_rn(prev.x, a0), __fadd_rn(prev.y, a1));
      }
    }
  }
}

template <int NW>
__device__ __forceinline__ void dz32_phase(const DZ32Args& p, const TB32Phase& ph,
                                           unsigned char* tile, const unsigned char* ring_ptr,
                                           uint32_t ring, uint32_t full, uint32_t empty, int c,
                                           int r, int t, int grow0, int& it) {
  if (ph.kind == TB32_CHAIN)
    dz32_chain<NW>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
  else
    dz32_piece<NW>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    hand_trunk_dz_f32_kernel(const __grid_constant__ DZ32Args p) {
  extern __shared__ __align__(128) unsigned char dz32_smem[];
  t32_ring_kernel(p, dz32_smem, [](unsigned char*, int) {},
              [&](const TB32Phase& ph, unsigned char* tile, const unsigned char* ring_ptr,
                  uint32_t ring, uint32_t full, uint32_t empty, int c, int r, int t, int grow0,
                  int& it) {
                if (ph.width == 256)
                  dz32_phase<128>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
                else if (ph.width == 128)
                  dz32_phase<64>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
                else
                  dz32_phase<32>(p, ph, tile, ring_ptr, ring, full, empty, c, r, t, grow0, it);
              });
}

// Both chains' entry checks, common to the two entry points.
static bool tb32_shapes_ok(int M, int Ep, int Hp, int n_layers, int skip) {
  return n_layers >= 3 && n_layers <= TF32_MAX_LAYERS && skip > 0 && skip < n_layers - 1 &&
         (Hp == 64 || Hp == 128 || Hp == 256) && Ep > 0 && Ep % 64 == 0 && M >= 0;
}

// Launch one of the two kernels on M points: the grid, one block an SM.
template <class Args>
static cudaError_t tb32_launch(void (*kernel)(Args), const Args& p, cudaStream_t stream,
                               bool& smem_set) {
  const cudaError_t err = t32_smem_ready((const void*)kernel, TF32_SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return err;
  const int grid = p.q.tiles < wg::sm_count() ? p.q.tiles : wg::sm_count();
  kernel<<<grid, wg::THREADS, TF32_SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace honerf

// The upward chain on M points: du_b = du and du_s = du / sqrt2 (f32, (M,
// Ep), rows lddu apart); wsplit[l] = [big; small] of W_l^T (2 Hp rows of
// in_cols[l] f32: fused_fine.tf32_operands(w, True)) for l < n - 1; the
// forward's sigmoid rows ss[l] and the u-chain's c rows cs[l] (1 <= l <
// n - 1, rows ldc apart), c_last = c_{n-1} (Hp f32, every point's);
// hscale the skip's 1/sqrt2.  Outputs: ds[l] (l < n - 1, f32, rows ldds
// apart) and, with dm (optional), dm[l] (1 <= l <= n - 1, rows lddm
// apart).  Refused (cudaErrorInvalidValue): shapes the tiles do not hold
// (Hp not 64, 128 or 256, Ep not a multiple of 64, rows that do not
// chain), operands TMA or the vector loads and stores cannot take.
extern "C" int honerf_trunk_ut_f32(int M, int Ep, int Hp, int n_layers, int skip,
                                   const void* const* wsplit, const int* in_cols,
                                   const float* du_b, const float* du_s, int lddu,
                                   const float* ss, long long ss_layer, int lds,
                                   const void* const* cs, int ldc, const float* c_last,
                                   float* ds, long long ds_layer, int ldds, void* const* dm,
                                   int lddm, float hscale, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (!tb32_shapes_ok(M, Ep, Hp, n_layers, skip) || lddu % 4 || !ss || !ds || !c_last ||
      honerf_misaligned16(ss) || honerf_misaligned16(ds) || honerf_misaligned16(c_last) ||
      lds % 4 || ss_layer % 4 || ldds % 4 || ds_layer % 4 || ldc % 4 || (dm && lddm % 4))
    return (int)cudaErrorInvalidValue;
  UT32Args p{};
  for (int l = 0; l + 1 < n_layers; ++l) {
    const int want = l == 0 ? Ep : (l == skip ? Hp + Ep : Hp);
    if (in_cols[l] != want || (l > 0 && (!cs[l] || honerf_misaligned16(cs[l]))) ||
        (dm && (!dm[l + 1] || honerf_misaligned16(dm[l + 1]))) ||
        !wg::tma_map(&p.q.w[l], wsplit[l], in_cols[l], 2 * Hp, in_cols[l], TF32_BK,
                     TF32_BOX_ROWS, 4))
      return (int)cudaErrorInvalidValue;
    // layer 0 over du_b's boxes (map 0); the skip over the tile, then
    // du_s's (map 1)
    p.q.ph[l] = TB32Phase{l == 0 ? 0 : Hp / TF32_BK, l == 0 ? Ep / TF32_BK : 0,
                          l == skip ? Ep / TF32_BK : 0, l, 0, Hp, TB32_UT};
    p.q.small_rows[l] = Hp;
    p.cs[l] = l > 0 ? static_cast<const float*>(cs[l]) : nullptr;
    p.dm[l + 1] = dm ? static_cast<float*>(dm[l + 1]) : nullptr;
  }
  if (M == 0) return (int)cudaGetLastError();
  if (!wg::tma_map(&p.q.box[0], du_b, Ep, M, lddu, TF32_BK, TF32_TILE, 4) ||
      !wg::tma_map(&p.q.box[1], du_s, Ep, M, lddu, TF32_BK, TF32_TILE, 4))
    return (int)cudaErrorInvalidValue;
  p.q.n_phases = p.q.n_maps = n_layers - 1;
  p.q.n_boxes = 2;
  p.q.tiles = (M + TF32_TILE - 1) / TF32_TILE;
  p.ss = ss;
  p.ss_layer = ss_layer;
  p.lds = lds;
  p.ldc = ldc;
  p.c_last = c_last;
  p.ds = ds;
  p.ds_layer = ds_layer;
  p.ldds = ldds;
  p.lddm = lddm;
  p.M = M;
  p.n_layers = n_layers;
  p.skip = skip;
  p.hscale = hscale;
  static bool smem_set = false;
  return (int)tb32_launch(hand_trunk_ut_f32_kernel, p, stream, smem_set);
}

// The downward chain on the same M points from the top cotangent top (f32,
// (M, Op), rows ldtop apart): wsplit[l] = [big; small] of W_l (2
// in_cols[l] rows of out_cols[l] f32: tf32_operands(w, False)); the
// sigmoid rows ss and the upward chain's ds (l < n - 1); hscale and escale
// the skip's two scales.  Outputs: de (M, Ep) f32 rows ldde apart and, with
// dz (optional), dz[l] (l < n - 1, rows lddz apart).  Refused: as
// honerf_trunk_ut_f32.
extern "C" int honerf_trunk_dz_f32(int M, int Ep, int Hp, int Op, int n_layers, int skip,
                                   const void* const* wsplit, const int* in_cols,
                                   const int* out_cols, const float* top, int ldtop,
                                   const float* ss, long long ss_layer, int lds,
                                   const float* ds, long long ds_layer, int ldds, float* de,
                                   int ldde, void* const* dz, int lddz, float hscale,
                                   float escale, cudaStream_t stream) {
  namespace wg = honerf::wg;
  using namespace honerf;
  if (!tb32_shapes_ok(M, Ep, Hp, n_layers, skip) || Op <= 0 || Op % 64 || !top || !ss || !ds ||
      !de || honerf_misaligned16(ss) || honerf_misaligned16(ds) || honerf_misaligned16(de) ||
      ldtop % 4 || lds % 4 || ss_layer % 4 || ldds % 4 || ds_layer % 4 || ldde % 4 ||
      (dz && lddz % 4))
    return (int)cudaErrorInvalidValue;
  DZ32Args p{};
  for (int l = 0; l < n_layers; ++l) {
    const int want_in = l == 0 ? Ep : (l == skip ? Hp + Ep : Hp);
    const int want_out = l + 1 == n_layers ? Op : Hp;
    if (in_cols[l] != want_in || out_cols[l] != want_out ||
        (dz && l + 1 < n_layers && (!dz[l] || honerf_misaligned16(dz[l]))) ||
        !wg::tma_map(&p.q.w[l], wsplit[l], out_cols[l], 2 * in_cols[l], out_cols[l], TF32_BK,
                     TF32_BOX_ROWS, 4))
      return (int)cudaErrorInvalidValue;
    p.q.small_rows[l] = in_cols[l];
    p.dz[l] = dz && l + 1 < n_layers ? static_cast<float*>(dz[l]) : nullptr;
  }
  // the top layer over the top cotangent's boxes; the chain down to the
  // skip; de's skip parts (before the skip's chain part overwrites dz_skip);
  // the chain on to layer 1; de's layer-0 parts
  const int kt = Hp / TF32_BK;
  int n_ph = 0, n_pieces = 0;
  const auto pieces = [&](int layer, int row0, int kind) {
    n_pieces = 0;
    for (int n0 = 0; n0 < Ep; ++n_pieces) {
      const int rem = Ep - n0;
      const int width = rem >= TF32_PIECE ? TF32_PIECE : (rem >= 128 ? 128 : 64);
      if (kind >= 0) p.q.ph[n_ph++] = TB32Phase{kt, 0, 0, layer, row0 + n0, width, kind};
      n0 += width;
    }
  };
  pieces(0, 0, -1);  // count them
  if (n_layers - 1 + 2 * n_pieces > TB32_MAX_PHASES) return (int)cudaErrorInvalidValue;
  p.q.ph[n_ph++] = TB32Phase{0, Op / TF32_BK, 0, n_layers - 1, 0, Hp, TB32_CHAIN};
  for (int l = n_layers - 2; l > 0; --l) {
    if (l == skip) pieces(skip, Hp, TB32_SKIP);
    p.q.ph[n_ph++] = TB32Phase{kt, 0, 0, l, 0, Hp, TB32_CHAIN};
  }
  pieces(0, 0, TB32_ZERO);
  if (M == 0) return (int)cudaGetLastError();
  if (!wg::tma_map(&p.q.box[0], top, Op, M, ldtop, TF32_BK, TF32_TILE, 4))
    return (int)cudaErrorInvalidValue;
  p.q.n_phases = n_ph;
  p.q.n_maps = n_layers;
  p.q.n_boxes = 1;
  p.q.tiles = (M + TF32_TILE - 1) / TF32_TILE;
  p.ss = ss;
  p.ss_layer = ss_layer;
  p.lds = lds;
  p.ds = ds;
  p.ds_layer = ds_layer;
  p.ldds = ldds;
  p.de = de;
  p.ldde = ldde;
  p.lddz = lddz;
  p.M = M;
  p.skip = skip;
  p.Hp = Hp;
  p.hscale = hscale;
  p.escale = escale;
  static bool smem_set = false;
  return (int)tb32_launch(hand_trunk_dz_f32_kernel, p, stream, smem_set);
}
