from .aabb import aabb_hit, aabb_union
from .sphere import intersect_spheres, sphere_normal, sphere_t, sphere_uv
from .triangle import interpolate_attributes, triangle_barycentrics, triangle_t

__all__ = ["aabb_hit", "aabb_union", "intersect_spheres", "interpolate_attributes",
           "sphere_normal", "sphere_uv", "triangle_barycentrics", "triangle_t"]
