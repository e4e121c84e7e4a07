"""Sphere-scene container: host-side builder, device tables and hit query.

Counterpart of ``learn_path_tracing_tpu.scene.world``:

- ``Sphere`` / ``World``: host-side scene construction;
- ``SphereWorldData``: the padded structure-of-arrays tables on one device,
  produced by ``World.device(device)``, plus the sphere-scan kernel's packed
  tables, built once here rather than on every pass, and with
  ``use_bvh=True`` the sphere BVH's traversal tables (kernel K3);
- ``hit(world_data, rays)``: the wavefront nearest-hit query, with the
  reference's back-face handling (flip the normal, invert the ior).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..accel.bvh import build_bvh
from ..accel.wide import collapse
from ..bsdf.sampling import sum3
from ..core.types import Hits, Material, Materials, Rays
from ..geometry.sphere import intersect_spheres, sphere_normal
from ..ops.packet_traverse import pack_sphere_packet_tables, stack_cap, traverse
from ..ops.sphere_scan import intersect_spheres_scan, pack_spheres

_PAD = 128  # sphere tables are padded to a multiple of 128, as in the JAX package

# columns of the per-sphere attribute rows gathered for each ray's winner
_C0, _RADIUS, _ALB0, _ROUGH, _METAL, _IOR, _TRANSP, _ABSORB = 0, 3, 4, 7, 8, 9, 10, 11


class Sphere:
    """Host-side sphere record. ``material`` may be a Material, an RGB tuple
    (stage-6 style albedo shorthand), or None (stages 4-5 normal shading)."""

    __slots__ = ("center", "radius", "material")

    def __init__(self, center, radius, material=None):
        self.center = tuple(float(c) for c in center)
        self.radius = float(radius)
        if material is None:
            material = Material()
        elif not isinstance(material, Material):
            material = Material(albedo=material)  # albedo shorthand
        self.material = material


@dataclass(frozen=True)
class SphereWorldData:
    centers: torch.Tensor       # f32[S,3] (padded; radius==0 marks padding)
    radii: torch.Tensor         # f32[S]
    materials: Materials        # fields [S,...]
    # the sphere BVH's traversal tables (nodes, entries, runs) and their
    # stack bound, from World.device(use_bvh=True); None without it
    bvh: tuple | None = None
    bvh_stack: int = 0
    # sphere-scan kernel tables, derived from the fields above
    scan_table: torch.Tensor = field(init=False, repr=False)   # f32[S,8]
    scan_attrs: torch.Tensor = field(init=False, repr=False)   # f32[S,16]

    def __post_init__(self):
        m = self.materials
        zero = torch.zeros_like(self.radii)
        attrs = torch.stack([
            self.centers[:, 0], self.centers[:, 1], self.centers[:, 2],
            self.radii,
            m.albedo[:, 0], m.albedo[:, 1], m.albedo[:, 2],
            m.roughness, m.metallic, m.ior, m.transparency, m.absorptivity,
            zero, zero, zero, zero,
        ], dim=1).contiguous()
        object.__setattr__(self, "scan_attrs", attrs)
        object.__setattr__(self, "scan_table",
                           pack_spheres(self.centers, self.radii, m.transparency))

    @property
    def device(self) -> torch.device:
        return self.centers.device

    def to(self, device) -> "SphereWorldData":
        bvh = None if self.bvh is None else tuple(x.to(device) for x in self.bvh)
        return SphereWorldData(centers=self.centers.to(device),
                               radii=self.radii.to(device),
                               materials=self.materials.to(device),
                               bvh=bvh, bvh_stack=self.bvh_stack)


class World:
    """Growable sphere scene."""

    def __init__(self, spheres=()):
        self.spheres: list[Sphere] = list(spheres)
        self._cache: dict[str, SphereWorldData] = {}

    def add(self, sphere: Sphere) -> None:
        self.spheres.append(sphere)
        self._cache = {}

    @property
    def size(self) -> int:
        return len(self.spheres)

    def device(self, device=None, use_bvh: bool = False) -> SphereWorldData:
        """The scene as padded tables on ``device`` (cached per device).

        ``use_bvh=True`` also builds the JAX package's SAH sphere BVH (over
        the unpadded spheres' boxes, ``max_depth=8``, ``max_leaf=4``),
        collapsed to 8-wide nodes and packed into K3's tables, which
        ``hit(..., backend='bvh')`` walks. A cached world built without it
        is rebuilt with it. The device comes first (the JAX package's
        ``device(use_bvh)`` has none), so a bool there raises ``TypeError``
        rather than being read as ``use_bvh``."""
        if isinstance(device, bool):
            raise TypeError("World.device takes the torch device first; "
                            "pass use_bvh by keyword")
        key = str(torch.device(device or "cpu"))
        cached = self._cache.get(key)
        if cached is None or (use_bvh and cached.bvh is None):
            n = len(self.spheres)
            if n == 0:
                raise ValueError("empty world")
            padded = -(-n // _PAD) * _PAD
            centers = np.zeros((padded, 3), np.float32)
            radii = np.zeros((padded,), np.float32)
            for k, s in enumerate(self.spheres):
                centers[k] = s.center
                radii[k] = s.radius
            mats = [s.material for s in self.spheres]
            mats += [Material()] * (padded - n)
            bvh, stack = None, 0
            if use_bvh:
                c, r = centers[:n], radii[:n, None]
                transparency = np.array([s.material.transparency for s in self.spheres],
                                        np.float32)
                tables = pack_sphere_packet_tables(
                    collapse(build_bvh(c - r, c + r, centroid=c, max_depth=8, max_leaf=4)),
                    c, radii[:n], transparency)
                bvh = tuple(torch.as_tensor(x, device=device) for x in tables)
                stack = stack_cap(tables[1])
            self._cache[key] = SphereWorldData(
                centers=torch.as_tensor(centers, device=device),
                radii=torch.as_tensor(radii, device=device),
                materials=Materials.stack(mats, device=device),
                bvh=bvh, bvh_stack=stack,
            )
        return self._cache[key]


def hit(world: SphereWorldData, rays: Rays, t_min: float = 1e-4,
        backend: str = "auto", err=None) -> Hits:
    """Nearest-hit of a ray wavefront against the sphere table.

    ``backend``:
      - 'auto': the sphere-scan kernel for CUDA tensors, its plain twin for
        CPU tensors (``ops.sphere_scan.intersect_spheres_scan``);
      - 'cuda': the kernel; raises for tensors that are not on a card;
      - 'xla': the expanded-quadratic plain formulation
        (``geometry.sphere.intersect_spheres``), the JAX package's CPU default;
      - 'bvh': a walk of the sphere BVH of ``World.device(use_bvh=True)``
        (``ValueError`` on a world built without it):
        ``ops.packet_traverse.traverse`` with sphere leaves, which launches
        kernel K3 for CUDA tensors and runs its plain twin for CPU tensors.
        Its leaf test is the scan's pair test with ``t > t_min`` (the scan
        takes ``t >= t_min``) and its ties go to the smaller sphere index,
        as the scan's do, so it finds the scan's hits, but for two kinds of
        ray the walk's boxes turn away: one with a direction component of
        exactly 0 (the hoisted slab test's ``inf - inf`` is NaN), and one
        grazing the r = 10,000 ground, which the scan's f32 quadratic hits
        and exact arithmetic misses (about one path in 10**7 of stage l11's
        frames). Every lane is walked as active, dead rays too, and counted
        so in K3's active lanes.

    ``err``: K3's error word, which the caller reads (``traverse``'s
    ``err``); the other backends launch no K3 and leave it as it was.
    """
    if backend in ("auto", "cuda"):
        if backend == "cuda" and rays.ro.device.type != "cuda":
            raise ValueError("hit backend 'cuda' needs rays on a CUDA device")
        t, idx, attr = intersect_spheres_scan(
            rays.ro, rays.rd, world.scan_table, world.scan_attrs, t_min=t_min)
    elif backend == "xla":
        t, idx = intersect_spheres(
            rays.ro, rays.rd, world.centers, world.radii,
            world.materials.transparency, t_min=t_min)
        attr = world.scan_attrs[idx.to(torch.int64)]
    elif backend == "bvh":
        if world.bvh is None:
            raise ValueError("World.device(use_bvh=True) required for 'bvh'")
        n = rays.count
        t, idx, _ = traverse(*world.bvh, rays.ro, rays.rd,
                             torch.full((n,), float("inf"), dtype=torch.float32,
                                        device=rays.ro.device),
                             torch.ones((n,), dtype=torch.bool, device=rays.ro.device),
                             eps=t_min, leaf_kind="sphere", stack=world.bvh_stack,
                             active_lanes=n, err=err)
        idx = torch.clamp_min(idx, 0)
        attr = world.scan_attrs[idx.to(torch.int64)]
    else:
        raise ValueError(f"unknown hit backend: {backend!r}")
    return hit_record(rays, t, idx, attr)


def hit_record(rays: Rays, t, idx, attr) -> Hits:
    """The ``Hits`` of a nearest-sphere scan's result: ``t f32[N]`` (inf on a
    miss), the winner ``idx i32[N]`` and its ``scan_attrs`` row ``attr``."""
    hit_mask = torch.isfinite(t)
    t_safe = torch.where(hit_mask, t, torch.zeros_like(t))
    point = rays.ro + t_safe[:, None] * rays.rd
    normal = sphere_normal(point, attr[:, _C0:_C0 + 3], attr[:, _RADIUS])
    # Back-face: flip the normal and invert the relative ior so refraction
    # exits the medium. The ior is inverted as 1/max(ior, 1e-9), as on the
    # JAX package's Pallas path (world.py:146) that runs on its accelerator;
    # its CPU path uses a bare 1/ior, which differs only for metals (ior=0),
    # where the dielectric lobe that reads the ior is discarded anyway.
    backface = sum3(rays.rd * normal)[:, 0] > 0.0
    normal = torch.where(backface[:, None], -normal, normal)
    ior = attr[:, _IOR]
    ior = torch.where(backface, 1.0 / torch.clamp_min(ior, 1e-9), ior)
    mat = Materials(
        albedo=attr[:, _ALB0:_ALB0 + 3], roughness=attr[:, _ROUGH],
        metallic=attr[:, _METAL], ior=ior, transparency=attr[:, _TRANSP],
        absorptivity=attr[:, _ABSORB],
    )
    return Hits(
        t=t, point=point, normal=normal,
        uv=torch.zeros((rays.count, 2), dtype=torch.float32, device=t.device),
        obj=torch.where(hit_mask, idx, torch.full_like(idx, -1)),
        hit=hit_mask, material=mat,
    )
