from honerf_torch.hand.api import bone_transforms_from_mano_joints, refined_hand_joints
from honerf_torch.hand.kinematics import (
    forward_joints_from_bones,
    pose_to_bone_transforms,
    refine_joints,
    transform_to_canonical,
)
from honerf_torch.hand.skeleton import convert_joints

__all__ = [
    "bone_transforms_from_mano_joints",
    "convert_joints",
    "forward_joints_from_bones",
    "pose_to_bone_transforms",
    "refine_joints",
    "refined_hand_joints",
    "transform_to_canonical",
]
