"""Mesh extraction: the SDF grid on the device, marching cubes on the host."""

from honerf_torch.extract.grid import (
    bounds_from_points,
    evaluate_sdf_grid,
    extract_geometry,
    inner_point_ids,
)
from honerf_torch.extract.marching_cubes import marching_cubes

__all__ = ["bounds_from_points", "evaluate_sdf_grid", "extract_geometry", "inner_point_ids",
           "marching_cubes"]
