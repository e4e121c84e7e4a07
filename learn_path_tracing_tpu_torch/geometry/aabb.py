"""Batched AABB slab tests (plain PyTorch).

Counterpart of ``learn_path_tracing_tpu.geometry.aabb``: a hit is
``t1 > t0 - eps and t1 > 0``, the epsilon-relaxed form that keeps thin and
flat boxes. Division by a zero direction component follows IEEE (inf), and
``torch.minimum``/``maximum`` propagate NaN as ``jnp.minimum``/``maximum``
do.
"""

from __future__ import annotations

import torch

EPSILON = 1e-4


def aabb_hit(low, high, ro, rd, eps: float = EPSILON):
    """Slab test. ``low, high``: ``f32[...,3]``; ``ro, rd``: ``f32[...,3]``
    broadcastable against them. Returns a bool mask."""
    inv = 1.0 / rd
    i = (low - ro) * inv
    o = (high - ro) * inv
    t1 = torch.amin(torch.maximum(i, o), dim=-1)
    t0 = torch.amax(torch.minimum(i, o), dim=-1)
    return (t1 > t0 - eps) & (t1 > 0.0)


def aabb_union(low_a, high_a, low_b, high_b):
    return torch.minimum(low_a, low_b), torch.maximum(high_a, high_b)
