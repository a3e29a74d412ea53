"""NDC perspective camera (counterpart of honerf_tpu.camera.cameras).

pytorch3d conventions: world -> view X_view = X_world @ R + T (row
vectors); x_ndc = fx x_v / z_v + px; the full-image grid runs from
+range to -range (the reference's sign flip).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    R: torch.Tensor          # (3, 3) world->view rotation, row-vector convention
    T: torch.Tensor          # (3,)
    focal: torch.Tensor      # (2,) NDC focal lengths
    principal: torch.Tensor  # (2,) NDC principal point


def view_to_world(camera: Camera, pts: torch.Tensor) -> torch.Tensor:
    return (pts - camera.T) @ camera.R.T


def unproject_points(camera: Camera, xy_depth: torch.Tensor) -> torch.Tensor:
    """(x_ndc, y_ndc, depth) -> world points."""
    xy = xy_depth[..., :2]
    depth = xy_depth[..., 2:3]
    v_xy = (xy - camera.principal) * depth / camera.focal
    return view_to_world(camera, torch.cat([v_xy, depth], dim=-1))


def full_image_ndc_grid(H: int, W: int, device=None) -> torch.Tensor:
    """(H*W, 2) NDC grid for full-image renders: x from +range_x to
    -range_x across W columns, y from +range_y to -range_y down H rows."""
    if W >= H:
        range_x, range_y = W / H, 1.0
    else:
        range_x, range_y = 1.0, H / W
    xs = torch.linspace(range_x, -range_x, W, device=device)
    ys = torch.linspace(range_y, -range_y, H, device=device)
    grid_x = xs[None, :].expand(H, W).reshape(-1, 1)
    grid_y = ys[:, None].expand(H, W).reshape(-1, 1)
    return torch.cat([grid_x, grid_y], dim=-1)
