"""HO-NeRF in PyTorch with hand-written Hopper (sm_90a) CUDA kernels.

A port of `honerf_tpu` (JAX/Pallas) that mirrors its sub-package and
module names.  It imports torch and numpy only.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; on a CPU tensor
each kernel wrapper runs its plain PyTorch version instead.

This slice covers the hand model's novel-view render:
    config.hocon -> models.fields -> ops.fused_hand (ladder kernel) ->
    ops.fused_fine_full (fine-pass forward kernel) -> render.neus ->
    train.offline.make_hand_eval_render -> train.runner.render_full_image
"""

__version__ = "0.1.0"
