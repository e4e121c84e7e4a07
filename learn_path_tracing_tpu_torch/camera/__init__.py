from .camera import (Camera, CameraParams, LegacyCamera, generate_rays,
                     generate_rays_for_pixels, pixel_grid, rotation_matrix)

__all__ = ["Camera", "CameraParams", "LegacyCamera", "generate_rays",
           "generate_rays_for_pixels", "pixel_grid", "rotation_matrix"]
