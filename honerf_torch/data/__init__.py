from honerf_torch.data.datasets import (
    FrameWindowSampler,
    RayBatchLoader,
    SceneData,
    ViewRecord,
    get_bone_length,
    load_offline_dataset,
)
from honerf_torch.data.pixels import sample_patch, sample_rays

__all__ = [
    "FrameWindowSampler",
    "RayBatchLoader",
    "SceneData",
    "ViewRecord",
    "get_bone_length",
    "load_offline_dataset",
    "sample_patch",
    "sample_rays",
]
