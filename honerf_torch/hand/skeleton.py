"""Skeleton joint-order conversions (mano / biomech / halo); counterpart
of honerf_tpu.hand.skeleton.  "mano" is 0 = wrist then contiguous 4-joint
chains per finger; "biomech" is level-major."""

from __future__ import annotations

import numpy as np
import torch

HALO_TO_MANO = np.asarray(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
)
MANO_TO_HALO = np.asarray(
    [0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3, 4, 8, 12, 16, 20]
)
MANO_TO_BIOMECH = np.asarray(
    [0, 1, 5, 9, 13, 17, 2, 6, 10, 14, 18, 3, 7, 11, 15, 19, 4, 8, 12, 16, 20]
)
BIOMECH_TO_MANO = np.asarray(
    [0, 1, 6, 11, 16, 2, 7, 12, 17, 3, 8, 13, 18, 4, 9, 14, 19, 5, 10, 15, 20]
)
HALO_TO_BIOMECH = np.asarray(
    [0, 13, 1, 4, 10, 7, 14, 2, 5, 11, 8, 15, 3, 6, 12, 9, 16, 17, 18, 19, 20]
)
BIOMECH_TO_HALO = np.asarray(
    [0, 2, 7, 12, 3, 8, 13, 5, 10, 15, 4, 9, 14, 1, 6, 11, 16, 17, 18, 19, 20]
)

_TABLES = {
    ("halo", "biomech"): HALO_TO_BIOMECH,
    ("biomech", "halo"): BIOMECH_TO_HALO,
    ("mano", "biomech"): MANO_TO_BIOMECH,
    ("biomech", "mano"): BIOMECH_TO_MANO,
    ("halo", "mano"): HALO_TO_MANO,
    ("mano", "halo"): MANO_TO_HALO,
}


def convert_joints(joints: torch.Tensor, source: str, target: str) -> torch.Tensor:
    """Permute axis 1 of a (B, 21, ...) tensor between joint orderings
    (also applied to (B, 21, 4, 4) bone-transform stacks)."""
    if source == target:
        return joints
    perm = torch.as_tensor(_TABLES[(source, target)], device=joints.device)
    return joints[:, perm]
