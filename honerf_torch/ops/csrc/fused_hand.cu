// Ladder hand SDF, forward only (ops/fused_hand.py: fused_hand_sdf).
//
// Replaces: the Pallas kernel of honerf_tpu/ops/fused_hand.py
//   (`_run_kernel` pallas_call, body `_make_kernel`), which the JAX
//   package calls through FusedHandSDF for the NeuS up-sample ladder.
//
// Bound on an H100: operations.  Per point the trunk does ~2.34 MFLOP of
//   bf16 matmul (9 layers, 1386- and 1642-deep inputs) against 12 bytes
//   of input and 4 of output, so the tensor cores, not HBM, set the floor
//   (about 2.4 ms per million points at 989 TFLOP/s).
//
// Design: the TPU kernel kept e and all activations of a 512-point block
//   in VMEM.  A block's shared memory on Hopper (227 KB) holds the bf16
//   embedding (2.8 KB/pt) of only ~64 points next to the weight tiles, so
//   this version splits the op into launches over a bounded global
//   scratch (the wrapper's CHUNK): hand_embed_kernel writes e once
//   (channel-major columns, tiles of points stored by bulk copies), then one
//   gemm_kernel per layer streams the layer's weights from L2 through
//   shared memory and applies softplus in its epilogue, writing the bf16
//   activation the next layer reads.  The scratch traffic is ~7 KB/pt
//   against ~2.3 MFLOP/pt, well under the card's byte/FLOP balance.
//   What bounds this version is the GEMM itself (wgmma on tiles fed by a
//   TMA ring, wgmma.cuh; the epilogue's transcendentals take longer than
//   a 256-deep product): PERF.md has its times.  Fusing the launches is
//   later work.

#include "common.cuh"
