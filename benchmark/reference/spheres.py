"""Plain reference of the sphere scenes: nearest hit by a scan of every
sphere, the sphere hit record, the modern BSDF and the gradient sky.

The hit is worked out from the benchmark's own sphere arrays
(``scenes/rtiow.py``): the nearest ``t >= 1e-4`` over all spheres in the
``oc = ro - c`` form, the far root for a transparent sphere whose near root
is too close, the first sphere on a tie; the back face flips the normal and
inverts the ior (``1 / max(ior, 1e-9)``).
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import integrate
from .shading import scatter_modern, sky, sum3

T_MIN = 1e-4
CHUNK = 128  # spheres a step of the scan (bounds its [N, chunk] temporaries)


def tables(scene, device, dtype=torch.float32) -> dict:
    """The scene's arrays as tensors: centres, r², transparency flags and
    the material columns."""
    def t(name):
        return torch.as_tensor(scene[name], device=device).to(dtype)

    r = t("radius")
    return {"center": t("center"), "radius": r, "r2": r * r,
            "transparent": t("transparency") > 0, "albedo": t("albedo"),
            "roughness": t("roughness"), "metallic": t("metallic"), "ior": t("ior"),
            "transparency": t("transparency")}


def _sqrt(x):
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def nearest(tab, ro, rd, t_min=T_MIN):
    """``(t [N] (+inf on a miss), idx int64 [N])``: the nearest sphere."""
    n = ro.shape[0]
    dev, dt = ro.device, ro.dtype
    t_min_t = torch.tensor(t_min, dtype=dt, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    ro_c = [ro[:, d:d + 1] for d in range(3)]
    rd_c = [rd[:, d:d + 1] for d in range(3)]
    t_best = torch.full((n,), float("inf"), dtype=dt, device=dev)
    idx_best = torch.zeros((n,), dtype=torch.int64, device=dev)
    s = tab["r2"].shape[0]
    for s0 in range(0, s, CHUNK):
        c = [tab["center"][None, s0:s0 + CHUNK, d] for d in range(3)]
        r2 = tab["r2"][None, s0:s0 + CHUNK]
        transparent = tab["transparent"][None, s0:s0 + CHUNK]
        oc = [ro_c[d] - c[d] for d in range(3)]
        half_b = -((oc[0] * rd_c[0] + oc[1] * rd_c[1]) + oc[2] * rd_c[2])
        c0 = ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]) - r2
        disc = half_b * half_b - c0
        sq = _sqrt(torch.clamp_min(disc, 0.0))
        t_near = half_b - sq
        t = torch.where((t_near < t_min_t) & transparent, half_b + sq, t_near)
        t = torch.where((t >= t_min_t) & (disc >= 0.0), t, inf)
        t_chunk, i_chunk = torch.min(t, dim=1)
        better = t_chunk < t_best
        t_best = torch.where(better, t_chunk, t_best)
        idx_best = torch.where(better, i_chunk + s0, idx_best)
    return t_best, idx_best


def hit_fn(tab):
    def hit(ro, rd):
        t, idx = nearest(tab, ro, rd)
        hit_mask = torch.isfinite(t)
        t_safe = torch.where(hit_mask, t, torch.zeros_like(t))
        point = ro + t_safe[:, None] * rd
        v = point - tab["center"][idx]
        normal = v / torch.clamp_min(torch.sqrt(sum3(v * v)), 1e-20)
        backface = sum3(rd * normal)[:, 0] > 0.0
        normal = torch.where(backface[:, None], -normal, normal)
        ior = tab["ior"][idx]
        ior = torch.where(backface, 1.0 / torch.clamp_min(ior, 1e-9), ior)
        mat = {"albedo": tab["albedo"][idx], "roughness": tab["roughness"][idx],
               "metallic": tab["metallic"][idx], "ior": ior,
               "transparency": tab["transparency"][idx]}
        return hit_mask, point, normal, mat
    return hit


def render(scene, config, seed, spp: int, pixels, dtype=torch.float32,
           block: int = 1 << 20):
    """``(acc int64[P,3], segments int64[P])`` of the pixels ``pixels`` of
    the config's frame at ``spp`` samples, frame seed ``seed``."""
    device = pixels.device
    res = tuple(config["resolution"])
    fr = cam_mod.frame(config["camera"], res, device)
    tab = tables(scene, device, dtype)

    def primary(pix, sample):
        return cam_mod.primary(fr, "thinlens", res, pix, seed, sample, dtype)

    return integrate.render(pixels, spp, config["depth"], seed, primary, hit_fn(tab),
                            sky, scatter_modern, block)
