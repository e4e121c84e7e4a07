"""Batched ray-sphere intersection in plain PyTorch.

``intersect_spheres`` is the expanded-quadratic formulation of the JAX
package's ``geometry.sphere`` (its default backend on the CPU): the two
per-(ray, sphere) dot products are matrix products
``rd @ centers.T`` and ``ro @ centers.T``, then an elementwise solve and one
min/argmin over the sphere axis. ``scene.world.hit`` reaches it as
``backend='xla'``, so tests can hold the port against the JAX package's
default CPU path. The main path uses the sphere-scan kernel of
``ops.sphere_scan`` instead, whose ``oc = ro - c`` form is better
conditioned.

Semantics: nearest hit with ``t >= t_min``; the first sphere wins ties; a
transparent sphere whose near root is below ``t_min`` yields its far root;
spheres with radius <= 0 never hit.

``sphere_t`` is the pairwise test in the ``oc = ro - c`` form (the leaf
test of the lockstep walks in ``accel.traverse``), as ``triangle_t`` is
for triangles.
"""

from __future__ import annotations

import torch

from ..bsdf.sampling import sum3

INF = float("inf")
T_MIN = 1e-4


def intersect_spheres(ro, rd, centers, radii, transparency, t_min: float = T_MIN):
    """Nearest-hit scan of ``N`` rays against ``S`` spheres.

    Args:
      ro, rd: ``f32[N,3]`` ray origins / unit directions.
      centers: ``f32[S,3]``; radii: ``f32[S]``; transparency: ``f32[S]``.

    Returns:
      ``(t, idx)``: ``f32[N]`` hit distance (+inf on miss) and ``i32[N]``
      sphere index (arbitrary on miss — mask with ``torch.isfinite(t)``).
    """
    d_dot_c = rd @ centers.T                                   # f32[N,S]
    o_dot_c = ro @ centers.T                                   # f32[N,S]
    o_dot_d = torch.sum(ro * rd, dim=-1, keepdim=True)         # f32[N,1]
    o_dot_o = torch.sum(ro * ro, dim=-1, keepdim=True)         # f32[N,1]
    c_dot_c = torch.sum(centers * centers, dim=-1)             # f32[S]

    half_b = o_dot_d - d_dot_c
    c = o_dot_o - 2.0 * o_dot_c + (c_dot_c - radii * radii)[None, :]
    disc = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -half_b - sq
    t_far = -half_b + sq
    t = torch.where((t_near < t_min) & (transparency[None, :] > 0.0), t_far, t_near)
    valid = (disc >= 0.0) & (t >= t_min) & (radii[None, :] > 0.0)
    t = torch.where(valid, t, torch.full_like(t, INF))

    # torch.min over a dim returns the first index of the minimum
    t_best, idx = torch.min(t, dim=-1)
    return t_best, idx.to(torch.int32)


def sphere_t(center, radius, transparency, ro, rd, eps: float = T_MIN):
    """Intersection distance of rays against spheres, pairwise (shapes
    broadcast: ``center, ro, rd f32[...,3]``, ``radius, transparency
    f32[...]``); +inf where there is no hit. The near root, or the far root
    when the near one is below ``eps`` and the sphere is transparent; a hit
    needs ``t > eps``."""
    oc = ro - center
    half_b = sum3(oc * rd)[..., 0]
    cterm = sum3(oc * oc)[..., 0] - radius * radius
    disc = half_b * half_b - cterm
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -half_b - sq
    t = torch.where((t_near < eps) & (transparency > 0.0), -half_b + sq, t_near)
    return torch.where((disc >= 0.0) & (t > eps), t, INF)


def sphere_normal(point, center, radius):
    """Outward geometric normal at ``point`` on the sphere (normalized)."""
    v = point - center
    n = torch.sqrt(sum3(v * v))
    return v / torch.clamp_min(n, 1e-20)


def sphere_uv(normal):
    """Spherical lat/long UV of a unit normal (legacy textures: u from
    atan2(z, x), v from acos(y))."""
    u = 0.5 + torch.atan2(normal[..., 2], normal[..., 0]) / (2.0 * torch.pi)
    v = torch.acos(torch.clamp(normal[..., 1], -1.0, 1.0)) / torch.pi
    return torch.stack([u, v], dim=-1)
