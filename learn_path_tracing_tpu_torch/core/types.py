"""Core structure-of-arrays value types as tensor dataclasses.

Counterparts of the JAX package's pytrees (``learn_path_tracing_tpu.core.types``):
every field is a tensor with a leading wavefront dimension ``[N]``, and the
layouts are the same (``ro/rd/throughput`` are ``f32[N,3]``).

The material model is the union of the modern and legacy reference lines:
``metallic`` and ``transparency`` are float, ``absorptivity`` is the legacy
energy-loss term; the modern stages use {0.0, 1.0} values and zero
absorptivity.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def _map(fn, obj):
    """Apply ``fn`` to every tensor field of a dataclass, recursively."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = _map(fn, v)
        kw[f.name] = v
    return type(obj)(**kw)


@dataclass(frozen=True)
class Materials:
    """Material table (or per-ray gathered materials). Fields: ``[S,...]``."""

    albedo: torch.Tensor        # f32[S, 3]
    roughness: torch.Tensor     # f32[S]
    metallic: torch.Tensor      # f32[S]   (modern: 0/1 dispatch; legacy: mix prob)
    ior: torch.Tensor           # f32[S]
    transparency: torch.Tensor  # f32[S]   (0/1)
    absorptivity: torch.Tensor  # f32[S]   (legacy only; 0 in modern stages)

    @staticmethod
    def stack(mats, device=None) -> "Materials":
        """Build a table on ``device`` from a sequence of host `Material` records."""
        def f32(xs):
            return torch.as_tensor(np.asarray(xs, np.float32), device=device)

        return Materials(
            albedo=f32([m.albedo for m in mats]).reshape(-1, 3),
            roughness=f32([m.roughness for m in mats]),
            metallic=f32([m.metallic for m in mats]),
            ior=f32([m.ior for m in mats]),
            transparency=f32([m.transparency for m in mats]),
            absorptivity=f32([m.absorptivity for m in mats]),
        )

    def gather(self, idx) -> "Materials":
        """Per-ray materials by object index ``idx i32[N]``, with
        ``jnp.take``'s rule: a negative index counts from the end, and one
        outside ``[-S, S)`` gives NaN."""
        s = self.roughness.shape[0]
        i = idx.to(torch.int64)
        i = torch.where(i < 0, i + s, i)
        ok = (i >= 0) & (i < s)
        i = torch.where(ok, i, 0)

        def take(a):
            keep = ok.reshape(ok.shape + (1,) * (a.dim() - 1))
            return torch.where(keep, a[i], float("nan"))

        return _map(take, self)

    def to(self, device) -> "Materials":
        return _map(lambda a: a.to(device), self)


class Material:
    """Host-side scalar material record (scene construction convenience)."""

    __slots__ = ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity")

    def __init__(self, albedo=(1.0, 1.0, 1.0), roughness=0.0, metallic=0.0,
                 ior=1.5, transparency=0.0, absorptivity=0.0):
        self.albedo = tuple(float(c) for c in albedo)
        self.roughness = float(roughness)
        self.metallic = float(metallic)
        self.ior = float(ior)
        self.transparency = float(transparency)
        self.absorptivity = float(absorptivity)

    def __repr__(self):
        return (f"Material(albedo={self.albedo}, roughness={self.roughness}, "
                f"metallic={self.metallic}, ior={self.ior}, "
                f"transparency={self.transparency}, absorptivity={self.absorptivity})")


@dataclass(frozen=True)
class Rays:
    """A wavefront of rays. ``throughput`` is the reference's ``ray.l``."""

    ro: torch.Tensor          # f32[N, 3] origin
    rd: torch.Tensor          # f32[N, 3] unit direction
    throughput: torch.Tensor  # f32[N, 3]
    alive: torch.Tensor       # bool[N] — inverse of the reference's ``end`` flag

    @property
    def count(self) -> int:
        return self.ro.shape[0]

    def take(self, idx) -> "Rays":
        """Rows ``idx`` of every field (drain compaction)."""
        return _map(lambda a: a[idx], self)

    def with_alive(self, alive) -> "Rays":
        return dataclasses.replace(self, alive=alive)

    def to(self, device) -> "Rays":
        return _map(lambda a: a.to(device), self)


@dataclass(frozen=True)
class Hits:
    """Per-ray nearest-hit records (full wavefront width, masked by ``hit``)."""

    t: torch.Tensor        # f32[N]; +inf on miss
    point: torch.Tensor    # f32[N, 3]
    normal: torch.Tensor   # f32[N, 3] — flipped to front-face (see scene.world)
    uv: torch.Tensor       # f32[N, 2] — texture coordinates (0 for untextured)
    obj: torch.Tensor      # i32[N] object/primitive index; -1 on miss
    hit: torch.Tensor      # bool[N]
    material: Materials    # gathered per-ray; ``ior`` already inverted on backface
