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
//   embedding (2.8 KB/pt) of only ~64 points beside the weight tiles, so e
//   stays in a bounded global scratch (the wrapper's CHUNK of points):
//   each chunk is two launches, hand_embed_kernel (this library: e once,
//   channel-major columns, tiles of points stored by bulk copies) and
//   hand_trunk_fwd_kernel (csrc/trunk_fused.cu), which runs all nine
//   layers of a tile of 128 points in one launch: e's 64-column boxes
//   streamed by TMA beside the weights for layer 0 and the skip, the
//   activations in shared memory from layer to layer, only the sdf column
//   stored.  The scratch traffic is e written once and read twice, ~8.4
//   KB a point.  One gemm_kernel launch a layer, each epilogue writing the
//   activation the next one read, took 1.03 ms at 65,536 points; the two
//   launches 0.46 (PERF.md).

#include "common.cuh"
