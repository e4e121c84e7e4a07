from . import benchlib, checks, config, profiling

__all__ = ["benchlib", "checks", "config", "profiling"]
