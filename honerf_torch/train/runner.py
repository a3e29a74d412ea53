"""Full-image novel-view render (counterpart of the chunk loop of
honerf_tpu.train.runner.OfflineRunner._render_full_image).  The runner,
its CLI and its datasets come with a later slice."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from honerf_torch.camera import full_image_ndc_grid


def render_full_image(render_chunk: Callable, params: Dict[str, Any],
                      view: Dict[str, torch.Tensor], H: int, W: int,
                      chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render the (H, W) NDC grid of one view in requests of `chunk` rays.

    view: cam_R, cam_T, focal, principal, joints, t_pose_21 (one device).
    Returns (color (H, W, 3), weight_sum (H, W))."""
    grid = full_image_ndc_grid(H, W, device=view["cam_R"].device)
    colors, wsums = [], []
    for s in range(0, grid.shape[0], chunk):
        color, wsum = render_chunk(params, dict(view, rays_xy=grid[s:s + chunk]))
        colors.append(color)
        wsums.append(wsum)
    return (torch.cat(colors, dim=0).reshape(H, W, 3),
            torch.cat(wsums, dim=0).reshape(H, W))
