"""The "Ray Tracing in One Weekend" cover scene, frozen for the benchmark.

A copy of the port's ``models.random_scene`` and ``stage10_camera``
(``learn_path_tracing_tpu_torch/models/scenes.py``), kept here so that a
change to the program cannot change what the benchmark renders. The
placement draws from ``random.Random(seed)`` in the same order: ground,
``(2·size)²`` grid spheres (80 % diffuse, 15 % metal, 5 % glass), three hero
spheres. ``generate`` returns plain numpy arrays; the config records their
digest and set-up checks it.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

FIELDS = ("center", "radius", "albedo", "roughness", "metallic", "ior", "transparency")


def _sphere(rows, center, radius, albedo, roughness, metallic, ior, transparency):
    rows.append((tuple(float(c) for c in center), float(radius),
                 tuple(float(c) for c in albedo), float(roughness), float(metallic),
                 float(ior), float(transparency)))


def generate(config) -> dict:
    """The scene of ``config`` (``scene_seed``, ``grid_size``) as float32
    arrays: ``center [S,3]``, ``radius [S]``, ``albedo [S,3]``,
    ``roughness``, ``metallic``, ``ior``, ``transparency`` (each ``[S]``)."""
    rng = random.Random(config["scene_seed"])
    size = config["grid_size"]
    rows = []
    _sphere(rows, (0.0, -10000.0, 0.0), 10000.0, (0.25, 0.25, 0.25), 0.5, 0, 1.5, 0)
    for a in range(-size, size):
        for b in range(-size, size):
            choose_mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            dx, dz = center[0] - 4.0, center[2]
            if (dx * dx + 0.0 + dz * dz) ** 0.5 > 0.9:
                albedo = (rng.random(), rng.random(), rng.random())
                if choose_mat < 0.8:
                    _sphere(rows, center, 0.2, albedo, rng.random(), 0, 1.5, 0)
                elif choose_mat < 0.95:
                    _sphere(rows, center, 0.2, tuple(0.5 + 0.5 * c for c in albedo),
                            0.5 * rng.random(), 1, 0, 0)
                else:
                    _sphere(rows, center, 0.2, tuple(0.75 + 0.25 * c for c in albedo),
                            0.2 * rng.random(), 0, 1.5, 1)
    _sphere(rows, (0.0, 1.0, 0.0), 1.0, (1.0, 1.0, 1.0), 0.0, 0, 1.5, 1)
    _sphere(rows, (-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), 0.5, 0, 1.5, 0)
    _sphere(rows, (4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0, 1, 0, 0)
    cols = list(zip(*rows))
    return {name: np.asarray(col, np.float32) for name, col in zip(FIELDS, cols)}


def digest(arrays) -> str:
    """sha256 of the arrays' bytes, in ``FIELDS`` order (16 hex digits)."""
    h = hashlib.sha256()
    for name in FIELDS:
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()[:16]

