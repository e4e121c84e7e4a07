"""Sampling, BSDFs and escape radiance of the path tracer, frozen.

A copy of the port's plain PyTorch ``bsdf/sampling.py``, ``bsdf/bsdf.py``
(``scatter_modern``, ``scatter_legacy``) and the gradient sky, over plain
tensors: every operation in the same order, so on the same device the
reference rounds as the program's plain path does. The uniforms are cast to
the working type of the rays, which lets the control run the same code in
a lower precision.
"""

from __future__ import annotations

import torch

from . import rng

TWO_PI = 6.283185307179586


def sum3(v):
    return (v[..., 0:1] + v[..., 1:2]) + v[..., 2:3]


def dot(a, b):
    return sum3(a * b)


def normalize(v, eps: float = 0.0):
    n = torch.sqrt(sum3(v * v))
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def uniform(base_h, dim, like):
    return rng.uniform(base_h, dim).to(like.dtype)


def sample_at_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def sample_in_disk(u1, u2):
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_lambertian(normal, u1, u2):
    return normalize(normal + sample_at_sphere(u1, u2), eps=1e-12)


def slerp(a, b, t):
    cosw = torch.clamp(dot(a, b), -1.0, 1.0)
    omega = torch.acos(cosw)
    so = torch.sqrt(torch.clamp_min(1.0 - cosw * cosw, 0.0))
    small = so < 1e-6
    safe_so = torch.where(small, torch.ones_like(so), so)
    sin_tw = torch.sin(t * omega)
    cos_tw = torch.cos(t * omega)
    s_a = cos_tw - cosw * sin_tw / safe_so
    s_b = sin_tw / safe_so
    lin = (1.0 - t) * a + t * b
    sph = s_a * a + s_b * b
    return normalize(torch.where(small, lin, sph), eps=1e-12)


def reflect(d, n):
    return d - 2.0 * dot(d, n) * n


def sample_normal(d, n, roughness, u1, u2):
    s = sample_lambertian(n, u1, u2)
    r = reflect(d, n)
    r = slerp(r, s, (roughness * roughness))
    return normalize(r - d, eps=1e-12)


def refract(d, n, ior):
    ior = ior[..., None]
    k = dot(d, n)
    r_perp = (d - k * n) / ior
    perp_len2 = dot(r_perp, r_perp)
    kk = torch.sqrt(torch.clamp_min(1.0 - perp_len2, 0.0))
    refracted = r_perp - kk * n
    return torch.where(perp_len2 > 1.0, reflect(d, n), refracted)


def refract_legacy(d, n, ior):
    ior = ior[..., None]
    k = dot(d, n)
    r_perp = (d - k * n) / ior
    perp_len2 = torch.clamp_max(dot(r_perp, r_perp), 1.0)
    kk = torch.sqrt(torch.clamp_min(1.0 - perp_len2, 0.0))
    return r_perp - kk * n


def schlick(cos_theta, f0):
    c = torch.clamp_min(cos_theta, 0.0)
    m = 1.0 - c
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)


def ball_radius(u1, u2, u3):
    return torch.maximum(u1, torch.maximum(u2, u3))


def sky(rd):
    """The white-to-blue gradient of the sphere scenes."""
    t = 0.5 * (rd[..., 1] + 1.0)
    return torch.stack([(1.0 - t) + t * b for b in (0.5, 0.7, 1.0)], dim=-1)


def scatter_modern(rd, thr, point, normal, mat, base):
    """The sphere scenes' BSDF: ``(ro', rd', throughput')``. ``mat`` holds
    ``albedo [N,3]``, ``roughness``, ``metallic``, ``ior``, ``transparency``."""
    d = rd
    u1, u2 = uniform(base, 0, d), uniform(base, 1, d)
    u_roulette = uniform(base, 2, d)
    u3, u4 = uniform(base, 3, d), uniform(base, 4, d)
    n = sample_normal(d, normal, mat["roughness"][..., None], u1, u2)
    cos_theta = torch.clamp_min(sum3(n * (-d))[..., 0], 0.0)
    f_metal = schlick(cos_theta[..., None], mat["albedo"])
    rd_metal = reflect(d, n)
    l_metal = thr * f_metal
    ior = mat["ior"]
    q = (ior - 1.0) / (ior + 1.0)
    f_diel = schlick(cos_theta, q * q)
    rd_refract = refract(d, n, ior)
    rd_diffuse = sample_lambertian(normal, u3, u4)
    transmit = u_roulette > f_diel
    is_transparent = mat["transparency"] > 0.0
    rd_nonspec = torch.where(is_transparent[..., None], rd_refract, rd_diffuse)
    rd_diel = torch.where(transmit[..., None], rd_nonspec, reflect(d, n))
    l_diel = torch.where(transmit[..., None], thr * mat["albedo"], thr)
    is_metal = (mat["metallic"] == 1.0)[..., None]
    return (point, torch.where(is_metal, rd_metal, rd_diel),
            torch.where(is_metal, l_metal, l_diel))


def scatter_legacy(rd, thr, point, normal, mat, base):
    """The mesh scenes' BSDF (the reference's 15_module.py:994-1013):
    ``(ro', rd', throughput')``; ``mat`` also holds ``absorptivity``."""
    d = rd
    nrm = normal
    u_metal = uniform(base, 0, d)
    u1, u2, u3 = uniform(base, 1, d), uniform(base, 2, d), uniform(base, 3, d)
    u_fresnel = uniform(base, 4, d)
    u4, u5 = uniform(base, 5, d), uniform(base, 6, d)
    s_sphere = sample_at_sphere(u1, u2)
    ball = s_sphere * ball_radius(u3, u4, u5)[..., None]
    rough = mat["roughness"][..., None]

    def roughen(direction):
        return normalize(direction + rough * ball, eps=1e-12)

    cos_theta = torch.clamp_min(torch.sum(nrm * (-d), dim=-1), 0.0)
    rd_reflect = roughen(reflect(d, nrm))
    f_metal = schlick(cos_theta[..., None], mat["albedo"])
    l_metal = thr * f_metal
    ior = mat["ior"]
    q = (ior - 1.0) / (ior + 1.0)
    f_diel = schlick(cos_theta, q * q)
    rd_refract = roughen(refract_legacy(d, nrm, ior))
    rd_diffuse = normalize(nrm + s_sphere, eps=1e-12)
    attenuation = mat["albedo"] * (1.0 - mat["absorptivity"])[..., None]
    transmit = u_fresnel > f_diel
    is_transparent = mat["transparency"] > 0.0
    rd_nonspec = torch.where(is_transparent[..., None], rd_refract, rd_diffuse)
    rd_diel = torch.where(transmit[..., None], rd_nonspec, rd_reflect)
    l_diel = torch.where(transmit[..., None], thr * attenuation, thr)
    is_metal = (u_metal < mat["metallic"])[..., None]
    return (point + 2.0 * 1e-4 * nrm, torch.where(is_metal, rd_reflect, rd_diel),
            torch.where(is_metal, l_metal, l_diel))
