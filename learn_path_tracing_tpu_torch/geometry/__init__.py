from .sphere import intersect_spheres, sphere_normal

__all__ = ["intersect_spheres", "sphere_normal"]
