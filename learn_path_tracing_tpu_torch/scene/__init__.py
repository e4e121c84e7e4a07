from .world import Sphere, SphereWorldData, World, hit

__all__ = ["Sphere", "SphereWorldData", "World", "hit"]
