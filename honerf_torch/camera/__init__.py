from honerf_torch.camera.cameras import Camera, full_image_ndc_grid, unproject_points
from honerf_torch.camera.rays import RayBundle, xy_to_ray_bundle

__all__ = ["Camera", "RayBundle", "full_image_ndc_grid", "unproject_points",
           "xy_to_ray_bundle"]
