"""The legacy line's stage 11 sphere scene, frozen for the benchmark.

A copy of the port's ``stages.l11_bvh.legacy_random_scene`` (the reference's
``legacy/PT_in_one_weekend/11_bvh.py:487-535``), kept here so that a change
to the program cannot change what the benchmark renders. The placement
draws from ``random.Random(seed)`` in the same order: a ground of radius
10,000 with absorptivity 0.5, ``(2·size)²`` grid spheres (80 % diffuse of
roughness 1, 15 % metal, 5 % glass), three hero spheres. ``generate``
returns plain numpy arrays, with every material column of the legacy BSDF;
the config records their digest and set-up checks it.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

FIELDS = ("center", "radius", "albedo", "roughness", "metallic", "ior", "transparency",
          "absorptivity")


def _sphere(rows, center, radius, albedo, roughness, metallic, ior, transparency=0.0,
            absorptivity=0.0):
    rows.append((tuple(float(c) for c in center), float(radius),
                 tuple(float(c) for c in albedo), float(roughness), float(metallic),
                 float(ior), float(transparency), float(absorptivity)))


def generate(config) -> dict:
    """The scene of ``config`` (``scene_seed``, ``grid_size``) as float32
    arrays: ``center [S,3]``, ``radius [S]``, ``albedo [S,3]``,
    ``roughness``, ``metallic``, ``ior``, ``transparency``, ``absorptivity``
    (each ``[S]``)."""
    rng = random.Random(config["scene_seed"])
    size = config["grid_size"]
    rows = []
    _sphere(rows, (0, -10000, 0), 10000, (1, 1, 1), 1, 0, 1.5, absorptivity=0.5)
    for a in range(-size, size):
        for b in range(-size, size):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if ((center[0] - 4) ** 2 + center[2] ** 2) ** 0.5 > 0.9:
                albedo = (rng.random(), rng.random(), rng.random())
                if choose < 0.8:
                    _sphere(rows, center, 0.2, albedo, 1, 0, 1.5)
                elif choose < 0.95:
                    _sphere(rows, center, 0.2, tuple(0.5 + 0.5 * c for c in albedo),
                            0.5 * rng.random(), 1, 0)
                else:
                    _sphere(rows, center, 0.2, tuple(0.75 + 0.25 * c for c in albedo),
                            0.2 * rng.random(), 0, 1.5, transparency=1)
    _sphere(rows, (0, 1, 0), 1.0, (1, 1, 1), 0, 0, 1.5, transparency=1)
    _sphere(rows, (-4, 1, 0), 1.0, (0.4, 0.2, 0.1), 1, 0, 1.5)
    _sphere(rows, (4, 1, 0), 1.0, (0.7, 0.6, 0.5), 0, 1, 0)
    cols = list(zip(*rows))
    return {name: np.asarray(col, np.float32) for name, col in zip(FIELDS, cols)}


def digest(arrays) -> str:
    """sha256 of the arrays' bytes, in ``FIELDS`` order (16 hex digits)."""
    h = hashlib.sha256()
    for name in FIELDS:
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()[:16]
