"""What a run refuses: no card (or too few), and JAX in the process.

The benchmark measures the PyTorch and CUDA package only. Its name begins
with the JAX package's, so modules are compared by their whole top-level
name, the part before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "learn_path_tracing_tpu"})


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def cards_missing(chips: int):
    """Why this machine cannot run a cell of ``chips`` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, this machine has {torch.cuda.device_count()}"
    return None
