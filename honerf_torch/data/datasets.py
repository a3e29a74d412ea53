"""Bone lengths of a 21-joint skeleton (numpy only); the part of
honerf_tpu.data.datasets that the hand train step needs."""

from __future__ import annotations

import numpy as np

# Parent/child joint pairs of the 21-joint MANO-ordered skeleton.
BONE_FATHERS = [0, 0, 0, 0, 0, 1, 5, 9, 13, 17, 2, 6, 10, 14, 18, 3, 7, 11, 15, 19]
BONE_CHILDREN = [1, 5, 9, 13, 17, 2, 6, 10, 14, 18, 3, 7, 11, 15, 19, 4, 8, 12, 16, 20]


def get_bone_length(t_pose_21: np.ndarray) -> np.ndarray:
    """20 bone lengths from a (21, 3) skeleton."""
    diffs = t_pose_21[BONE_CHILDREN] - t_pose_21[BONE_FATHERS]
    return np.linalg.norm(diffs, axis=-1)
