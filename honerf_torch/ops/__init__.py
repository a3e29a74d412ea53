"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

  fused_hand.fused_hand_sdf         ladder SDF        (csrc/fused_hand.cu)
  fused_fine_full.hand_fine_color   fine-pass forward (csrc/fused_fine_full.cu)
"""
