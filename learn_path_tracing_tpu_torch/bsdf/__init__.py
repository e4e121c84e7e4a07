from . import sampling
from .bsdf import SCATTERERS, scatter_diffuse, scatter_modern

__all__ = ["sampling", "SCATTERERS", "scatter_diffuse", "scatter_modern"]
