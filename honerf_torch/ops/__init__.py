"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions.

  fused_hand.fused_hand_sdf              ladder SDF         (csrc/fused_hand.cu)
  fused_fine_full.hand_fine_color_fwd    fine-pass forward  (csrc/fused_fine_full.cu)
  fused_fine_full.hand_fine_color_bwd    fine-pass backward (csrc/fused_fine_bwd.cu)
  fused_fine_full.hand_fine_color        the two as one autograd op
  fused_sdf.fused_obj_sdf                object SDF         (csrc/fused_sdf.cu)
"""
