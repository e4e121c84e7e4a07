from . import checks, config

__all__ = ["checks", "config"]
