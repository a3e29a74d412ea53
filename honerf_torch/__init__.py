"""HO-NeRF in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

A port of `honerf_tpu` (JAX/Pallas) that mirrors its sub-package and
module names.  It imports torch and numpy only.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; on a CPU tensor
each kernel wrapper runs its plain PyTorch version instead.

What is ported so far: the offline stage of both models through
cli.exp_runner -> train.runner.OfflineRunner (train / test / mesh):
    config.hocon, data (datasets, pixels, synthetic) -> models.fields ->
    render.neus -> train.offline (train steps, eval renders) ->
    train.checkpoints; extract (grid, marching cubes).
Its kernels (ops/csrc): ops.fused_hand (the hand's ladder SDF),
ops.fused_fine_full (the hand's fine pass, forward and backward) and
ops.fused_sdf (the object SDF of mesh extraction).  The object model's
field is plain PyTorch, as in the JAX package.
"""

__version__ = "0.1.0"
