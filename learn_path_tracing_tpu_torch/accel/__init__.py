from .bvh import FlatBVH, build_bvh, bvh_stats
from .wide import WideBVH, collapse, decode_leaf

__all__ = ["FlatBVH", "WideBVH", "build_bvh", "bvh_stats", "collapse", "decode_leaf"]
