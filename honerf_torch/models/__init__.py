from honerf_torch.models.fields import (
    ColorConfig,
    SDFConfig,
    color_config_from_conf,
    color_hand_apply,
    hand_fine_color_apply,
    init_color_params,
    init_sdf_params,
    init_variance_params,
    sdf_config_from_conf,
    sdf_hand_apply,
    sdf_hand_value_feat_grad,
    variance_apply,
)

__all__ = [
    "ColorConfig",
    "SDFConfig",
    "color_config_from_conf",
    "color_hand_apply",
    "hand_fine_color_apply",
    "init_color_params",
    "init_sdf_params",
    "init_variance_params",
    "sdf_config_from_conf",
    "sdf_hand_apply",
    "sdf_hand_value_feat_grad",
    "variance_apply",
]
