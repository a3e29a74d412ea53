from honerf_torch.render.neus import (
    Field,
    HandPacks,
    RenderConfig,
    coarse_z_vals,
    make_hand_field,
    make_obj_field,
    pack_hand_field,
    rays_to_object_frame,
    render_single,
    safe_norm,
    sdf_to_alpha,
)
from honerf_torch.render.sampling import (
    hierarchical_z_vals,
    merge_sorted,
    merge_z_vals,
    neus_upsample_weights,
    sample_pdf_det,
)

__all__ = [
    "Field",
    "HandPacks",
    "RenderConfig",
    "coarse_z_vals",
    "hierarchical_z_vals",
    "make_hand_field",
    "make_obj_field",
    "merge_sorted",
    "merge_z_vals",
    "neus_upsample_weights",
    "pack_hand_field",
    "rays_to_object_frame",
    "render_single",
    "safe_norm",
    "sample_pdf_det",
    "sdf_to_alpha",
]
