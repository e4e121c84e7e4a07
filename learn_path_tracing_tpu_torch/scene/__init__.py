from .legacy_world import LegacyWorld, LegacyWorldData, hit_legacy, trace_legacy
from .world import Sphere, SphereWorldData, World, hit

__all__ = ["LegacyWorld", "LegacyWorldData", "Sphere", "SphereWorldData", "World", "hit",
           "hit_legacy", "trace_legacy"]
