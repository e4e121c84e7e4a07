from . import color, image, rng
from .pytree import tree_where
from .types import Hits, Material, Materials, Rays

__all__ = [
    "color",
    "image",
    "rng",
    "tree_where",
    "Hits",
    "Material",
    "Materials",
    "Rays",
]
