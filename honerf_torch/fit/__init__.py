from honerf_torch.fit.single import (
    POSE_KEYS,
    SINGLE_FIT_LRS,
    FitHyper,
    current_pose,
    final_pose_numpy,
    init_fit_state,
    init_pose_params,
    make_pose_optimizer,
    make_single_fit_step,
    select_fit_kernels,
)

__all__ = [
    "FitHyper",
    "POSE_KEYS",
    "SINGLE_FIT_LRS",
    "current_pose",
    "final_pose_numpy",
    "init_fit_state",
    "init_pose_params",
    "make_pose_optimizer",
    "make_single_fit_step",
    "select_fit_kernels",
]
