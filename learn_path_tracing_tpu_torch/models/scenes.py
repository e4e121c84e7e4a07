"""Built-in scenes mirroring the reference's staged tutorial scenes.

The same builders as ``learn_path_tracing_tpu.models.scenes``, over the
port's ``World`` and ``Camera``; scene placement draws from
``random.Random(seed)`` in the same order, so a seed builds the same scene
(file:line of the reference stage cited per function).
"""

from __future__ import annotations

import random as _random

from ..camera import Camera
from ..core.types import Material
from ..scene.world import Sphere, World


def stage3_scene():
    """Single sphere at (0,0,-2), r=0.5 (3_adding_a_sphere/__main__.py:28-51)."""
    return World([Sphere((0.0, 0.0, -2.0), 0.5)])


def stage4_scene():
    """Sphere + ground (4_objects/__main__.py:39-41)."""
    return World([
        Sphere((0.0, 0.0, 0.0), 0.5),
        Sphere((0.0, -100.5, 0.0), 100.0),
    ])


def stage6_scene():
    """Three diffuse spheres + ground (6_diffuse/__main__.py:70-74)."""
    return World([
        Sphere((0.0, 0.0, 0.0), 0.5, (0.25, 0.25, 0.5)),
        Sphere((-1.0, 0.0, 0.0), 0.5, (0.25, 0.5, 0.25)),
        Sphere((1.0, 0.0, 0.0), 0.5, (0.5, 0.25, 0.25)),
        Sphere((0.0, -10000.5, 0.0), 10000.0, (0.25, 0.25, 0.25)),
    ])


def stage7_scene():
    """Diffuse + two metal spheres + ground (7_reflect/__main__.py:73-77)."""
    return World([
        Sphere((0.0, 0.0, 0.0), 0.5,
               Material(albedo=(0.25, 0.25, 0.5), roughness=0.5, metallic=0, ior=1.5)),
        Sphere((-1.0, 0.0, 0.0), 0.5,
               Material(albedo=(0.25, 0.5, 0.25), roughness=0.0, metallic=1, ior=1.5)),
        Sphere((1.0, 0.0, 0.0), 0.5,
               Material(albedo=(0.5, 0.25, 0.25), roughness=0.5, metallic=1, ior=1.5)),
        Sphere((0.0, -10000.5, 0.0), 10000.0,
               Material(albedo=(0.25, 0.25, 0.25), roughness=0.5, metallic=0, ior=1.5)),
    ])


def stage8_scene():
    """Stage 7 + two glass spheres (8_refract/__main__.py:73-79)."""
    world = stage7_scene()
    glass = [
        Sphere((-0.5, 0.866, 0.0), 0.5,
               Material(albedo=(1.0, 1.0, 1.0), roughness=0.0, metallic=0,
                        ior=1.5, transparency=1)),
        Sphere((0.5, 0.866, 0.0), 0.5,
               Material(albedo=(0.5, 1.0, 0.5), roughness=0.5, metallic=0,
                        ior=1.5, transparency=1)),
    ]
    # glass spheres go before the ground, matching reference insertion order
    return World(world.spheres[:3] + glass + world.spheres[3:])


def random_scene(size: int = 11, seed=None) -> World:
    """The RTIOW cover scene (10_final/__main__.py:12-45): ground + ~(2·size)²
    grid spheres (80% diffuse / 15% metal / 5% glass) + three hero spheres.

    The reference draws from the unseeded host RNG; pass ``seed`` for a
    reproducible scene.
    """
    rng = _random.Random(seed) if seed is not None else _random

    world = World()
    world.add(Sphere((0.0, -10000.0, 0.0), 10000.0,
                     Material(albedo=(0.25, 0.25, 0.25), roughness=0.5,
                              metallic=0, ior=1.5, transparency=0)))

    for a in range(-size, size):
        for b in range(-size, size):
            choose_mat = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            dx, dz = center[0] - 4.0, center[2]
            if (dx * dx + 0.0 + dz * dz) ** 0.5 > 0.9:
                albedo = (rng.random(), rng.random(), rng.random())
                if choose_mat < 0.8:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=albedo, roughness=rng.random(), metallic=0,
                        ior=1.5, transparency=0)))
                elif choose_mat < 0.95:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=tuple(0.5 + 0.5 * c for c in albedo),
                        roughness=0.5 * rng.random(), metallic=1, ior=0,
                        transparency=0)))
                else:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=tuple(0.75 + 0.25 * c for c in albedo),
                        roughness=0.2 * rng.random(), metallic=0, ior=1.5,
                        transparency=1)))

    world.add(Sphere((0.0, 1.0, 0.0), 1.0, Material(
        albedo=(1.0, 1.0, 1.0), roughness=0.0, metallic=0, ior=1.5, transparency=1)))
    world.add(Sphere((-4.0, 1.0, 0.0), 1.0, Material(
        albedo=(0.4, 0.2, 0.1), roughness=0.5, metallic=0, ior=1.5, transparency=0)))
    world.add(Sphere((4.0, 1.0, 0.0), 1.0, Material(
        albedo=(0.7, 0.6, 0.5), roughness=0.0, metallic=1, ior=0, transparency=0)))
    return world


def stage10_camera(resolution=(1280, 720)) -> Camera:
    """Camera of 10_final/__main__.py:106-110."""
    cam = Camera(resolution)
    cam.set_position((13.0, 2.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_fov(40.0)
    cam.set_len(10.0, 0.2)
    return cam
