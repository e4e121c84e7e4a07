from .progressive import ProgressiveRenderer

__all__ = ["ProgressiveRenderer"]
