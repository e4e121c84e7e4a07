from .hybrid import render_hybrid
from .persistent import render_persistent
from .wavefront import render, sky_background, trace_sample

__all__ = ["render", "render_hybrid", "render_persistent", "sky_background", "trace_sample"]
