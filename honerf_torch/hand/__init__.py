from honerf_torch.hand.api import bone_transforms_from_mano_joints
from honerf_torch.hand.kinematics import pose_to_bone_transforms, transform_to_canonical
from honerf_torch.hand.skeleton import convert_joints

__all__ = [
    "bone_transforms_from_mano_joints",
    "convert_joints",
    "pose_to_bone_transforms",
    "transform_to_canonical",
]
