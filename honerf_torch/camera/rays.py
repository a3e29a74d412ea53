"""Ray bundles from NDC pixel grids (counterpart of honerf_tpu.camera.rays):
unproject at depths 1 and 2, direction = normalized difference, origin =
the depth-1 point minus one direction unit (the convention the
renderer's near/far are calibrated against)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from honerf_torch.camera.cameras import Camera, unproject_points
from honerf_torch.utils.transforms import normalize


class RayBundle(NamedTuple):
    origins: torch.Tensor
    directions: torch.Tensor
    xys: torch.Tensor


def xy_to_ray_bundle(camera: Camera, xy_ndc: torch.Tensor) -> RayBundle:
    depth1 = torch.ones(xy_ndc.shape[:-1] + (1,), dtype=xy_ndc.dtype, device=xy_ndc.device)
    p1 = unproject_points(camera, torch.cat([xy_ndc, depth1], dim=-1))
    p2 = unproject_points(camera, torch.cat([xy_ndc, 2.0 * depth1], dim=-1))
    directions = normalize(p2 - p1)
    return RayBundle(origins=p1 - directions, directions=directions, xys=xy_ndc)
