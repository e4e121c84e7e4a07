"""Batched ray-triangle intersection (plain PyTorch).

Counterpart of ``learn_path_tracing_tpu.geometry.triangle``: intersect the
supporting plane, then require all three barycentric weights strictly
positive (the reference's plane-then-barycentric test). Attribute
interpolation (smooth normal, UV, tangent frame) is separate, computed once
for the final nearest hit. The traversal kernel uses the same test in the
precomputed coefficient form of ``ops.packet_traverse``.
"""

from __future__ import annotations

import torch

EPSILON = 1e-4


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _unit_normal(p1, p2, p3):
    n = torch.linalg.cross(p2 - p1, p3 - p1)
    nn = torch.sqrt(_dot(n, n))[..., None]
    return n / torch.clamp_min(nn, 1e-20)


def triangle_t(p1, p2, p3, ro, rd, eps: float = EPSILON):
    """Intersection distances of rays against triangles (pairwise, shapes
    broadcast, all ``f32[...,3]``); +inf where there is no hit."""
    n = _unit_normal(p1, p2, p3)
    denom = _dot(rd, n)
    t = _dot(p1 - ro, n) / denom
    p = ro + rd * t[..., None]
    w1, w2, w3 = _weights(p1, p2, p3, p, n)
    ok = (t > eps) & (w1 > 0.0) & (w2 > 0.0) & (w3 > 0.0)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def _weights(p1, p2, p3, point, n):
    # the reference's cross-ratio form of the barycentric weights
    cross = torch.linalg.cross
    w1 = _dot(cross(p3 - p2, point - p2), n) / _dot(cross(p3 - p2, p1 - p2), n)
    w2 = _dot(cross(p1 - p3, point - p3), n) / _dot(cross(p1 - p3, p2 - p3), n)
    return w1, w2, 1.0 - w1 - w2


def triangle_barycentrics(p1, p2, p3, point):
    """Barycentric weights (w1, w2, w3) of ``point`` in the triangle plane."""
    return _weights(p1, p2, p3, point, _unit_normal(p1, p2, p3))


def interpolate_attributes(w1, w2, w3, n1, n2, n3, uv1, uv2, uv3,
                           p1, p2, p3):
    """Smooth normal, UV, and UV-derived tangent/bitangent frame for the
    final hit. Returns (normal, uv, tangent, bitangent)."""
    normal = w1[..., None] * n1 + w2[..., None] * n2 + w3[..., None] * n3
    nn = torch.sqrt(_dot(normal, normal))[..., None]
    normal = normal / torch.clamp_min(nn, 1e-20)
    uv = w1[..., None] * uv1 + w2[..., None] * uv2 + w3[..., None] * uv3
    dv1 = (uv2 - uv1)[..., 1]
    dv2 = (uv3 - uv1)[..., 1]
    tangent = dv1[..., None] * (p3 - p1) - dv2[..., None] * (p2 - p1)
    tangent = tangent - _dot(tangent, normal)[..., None] * normal
    tn = torch.sqrt(_dot(tangent, tangent))[..., None]
    tangent = tangent / torch.clamp_min(tn, 1e-20)
    bitangent = torch.linalg.cross(tangent, normal)
    return normal, uv, tangent, bitangent
