"""Monte-Carlo sampling primitives (batched, branchless).

Counterparts of ``learn_path_tracing_tpu.bsdf.sampling``: pure functions that
take their uniforms explicitly (counter-based RNG) and work on ``f32[N,3]``
batches. All math is float32 tensor math, so the transcendental functions
round like the JAX package's f32 ones up to their ulp-level implementation
differences; every conditional is a ``torch.where`` select.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586


def sum3(v):
    """Sum over a last axis of size 3 as ``(x + y) + z``, keeping dims:
    f32[N,1]. The order is written out because ``torch.sum`` leaves it to
    the device's reduction kernel; this one is the CPU's, and the bounce
    kernel (``csrc/bounce_megakernel.cu``) adds in it too."""
    return (v[..., 0:1] + v[..., 1:2]) + v[..., 2:3]


def dot(a, b):
    """Batched dot product over the last axis, keeping dims: f32[N,1]."""
    return sum3(a * b)


def normalize(v, eps: float = 0.0):
    n = torch.sqrt(sum3(v * v))
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n


def _col(x, like):
    """Scalar or ``[N]`` tensor ``x`` as a column broadcastable to ``like``."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x[..., None] if x.ndim < like.ndim else x


def sample_at_sphere(u1, u2):
    """Uniform direction on the unit sphere. ``u1,u2: f32[N]`` → ``f32[N,3]``."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def ball_radius(u1, u2, u3):
    """Radius of a uniform in-ball point from three uniforms: ``max(u1,u2,u3)``
    has CDF r³ — exactly the cbrt(U) distribution."""
    return torch.maximum(u1, torch.maximum(u2, u3))


def sample_in_sphere(u1, u2, u3):
    """Uniform point inside the unit ball: direction uniform, radius ∝ cbrt(u).
    PyTorch has no cbrt; ``u ** (1/3)`` agrees with it to a few ulps."""
    d = sample_at_sphere(u1, u2)
    r = torch.pow(u3, 1.0 / 3.0)
    return d * r[..., None]


def sample_in_disk(u1, u2):
    """Uniform point in the unit disk → ``f32[N,2]`` (thin-lens aperture)."""
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_lambertian(normal, u1, u2):
    """Cosine-weighted bounce: normalize(normal + uniform-on-sphere)."""
    return normalize(normal + sample_at_sphere(u1, u2), eps=1e-12)


def slerp(a, b, t):
    """Spherical lerp between unit vectors; linear fallback when nearly
    parallel (sin ω < 1e-6), then re-normalized.

    Same transcendental-lean form as the JAX package: sin ω from √(1−cos²ω)
    and sin((1−t)ω) by the angle-difference identity, so one acos, one sin
    and one cos per lane.
    """
    cosw = torch.clamp(dot(a, b), -1.0, 1.0)
    omega = torch.acos(cosw)
    so = torch.sqrt(torch.clamp_min(1.0 - cosw * cosw, 0.0))  # sin ω, ω ∈ [0, π]
    t = _col(t, a)
    small = so < 1e-6
    safe_so = torch.where(small, torch.ones_like(so), so)
    sin_tw = torch.sin(t * omega)
    cos_tw = torch.cos(t * omega)
    # sin((1-t)ω)/sinω = cos(tω) − cosω·sin(tω)/sinω
    s_a = cos_tw - cosw * sin_tw / safe_so
    s_b = sin_tw / safe_so
    lin = (1.0 - t) * a + t * b
    sph = s_a * a + s_b * b
    return normalize(torch.where(small, lin, sph), eps=1e-12)


def reflect(d, n):
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return d - 2.0 * dot(d, n) * n


def sample_normal(d, n, roughness, u1, u2):
    """Roughness-perturbed shading normal: slerp the mirror direction toward
    a cosine-weighted sample by roughness², then take the half-way normal
    between incoming and perturbed outgoing directions."""
    s = sample_lambertian(n, u1, u2)
    r = reflect(d, n)
    r = slerp(r, s, (roughness * roughness))
    return normalize(r - d, eps=1e-12)


def refract(d, n, ior):
    """Snell refraction of unit ``d`` through normal ``n`` with relative index
    ``ior`` (outside→inside); mirror reflection on total internal reflection."""
    ior = _col(ior, d)
    k = dot(d, n)
    r_perp = (d - k * n) / ior
    perp_len2 = dot(r_perp, r_perp)
    kk = torch.sqrt(torch.clamp_min(1.0 - perp_len2, 0.0))
    refracted = r_perp - kk * n
    return torch.where(perp_len2 > 1.0, reflect(d, n), refracted)


def schlick(cos_theta, f0):
    """Schlick fresnel approximation: F0 + (1-F0)(1-cosθ)⁵, the fifth power
    spelled as squares like the JAX package."""
    c = torch.clamp_min(cos_theta, 0.0)
    m = 1.0 - c
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)


def refract_legacy(d, n, ior):
    """Legacy refraction: like `refract` but with the perpendicular component
    clamped to length 1 instead of a TIR fallback."""
    ior = _col(ior, d)
    k = dot(d, n)
    r_perp = (d - k * n) / ior
    perp_len2 = torch.clamp_max(dot(r_perp, r_perp), 1.0)
    kk = torch.sqrt(torch.clamp_min(1.0 - perp_len2, 0.0))
    return r_perp - kk * n


def roughen(direction, roughness, u1, u2, u3):
    """Legacy roughness perturbation: add roughness-scaled uniform-in-ball
    jitter, then normalize."""
    s = sample_in_sphere(u1, u2, u3)
    return normalize(direction + _col(roughness, direction) * s, eps=1e-12)
