"""Plain reference of the legacy line's sphere scene (stage 11): nearest hit
by a scan of every sphere, the sphere hit record with the legacy material
columns, the legacy BSDF, the gradient sky and the thin-lens camera whose
``fov`` is the half angle.

It composes the frozen pieces beside it and imports nothing of the program:
``spheres.nearest`` (the nearest ``t >= 1e-4`` over all spheres, the first
sphere on a tie: an independent check of the program's BVH walk), the
sphere hit record of ``spheres.py`` with the absorptivity column added,
``shading.scatter_legacy`` and ``shading.sky``, and ``camera.primary(...,
'thinlens')``. Every path is traced on its own, in float32 (``dtype``
lowers it for the control), and dead paths are compacted away after every
bounce.

Departures from the reference stage (``legacy/PT_in_one_weekend/11_bvh.py``
of https://github.com/JeffreyXiang/learn_path_tracing), each the program's
too:

- the scene is drawn with seed 1234 (the stage's ``random`` is unseeded),
  and every frame takes orbit frame 0's camera (the configuration's
  ``assumed``);
- the random numbers are the program's counter-based stream (``rng.py``),
  not Taichi's ``ti.random``, so a sample is the program's sample;
- the nearest hit is found by a scan of every sphere where the stage walks
  its BVH: the same nearest sphere, found another way;
- a back face inverts the ior as ``1 / max(ior, 1e-9)`` (the stage divides
  by the ior; the two differ only on metals, whose ior of 0 only the
  discarded dielectric lobe reads);
- a pixel's radiance is the float32 sum of its samples, added one sample
  at a time in sample order, over ``spp`` (the program's wavefront
  accumulator); a path still alive after ``depth`` segments adds nothing.

The program walks a BVH, and its walk turns away two kinds of ray that the
scan here hits: a ray with a direction component of exactly 0 (its hoisted
slab test computes ``inf - inf``, NaN, and rejects the box) and a ray
grazing the r = 10,000 ground that the f32 quadratic hits and exact
arithmetic misses. About one path in 10**7 takes either, so one compared
pixel in 65,536 differs on about a third of the seeds; the limits of
``correct`` leave room for that.
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import rng
from .integrate import FIXED_ONE
from .shading import scatter_legacy, sky, sum3
from .spheres import nearest
from .spheres import tables as sphere_tables


def tables(scene, device, dtype=torch.float32) -> dict:
    """``spheres.tables`` and the absorptivity column."""
    tab = sphere_tables(scene, device, dtype)
    tab["absorptivity"] = torch.as_tensor(scene["absorptivity"], device=device).to(dtype)
    return tab


def hit_fn(tab):
    """``hit(ro, rd) -> (hit, point, normal, mat)``: the nearest sphere's
    record; a back face flips the normal and inverts the ior."""
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
        mat = {k: tab[k][idx] for k in ("albedo", "roughness", "metallic", "transparency",
                                        "absorptivity")}
        mat["ior"] = ior
        return hit_mask, point, normal, mat
    return hit


def render(scene, config, seed, spp: int, pixels, dtype=torch.float32):
    """``(acc f64[P,3], segments int64[P])`` of the pixels ``pixels`` of the
    config's frame at ``spp`` samples, frame seed ``seed``. ``acc`` is each
    pixel's radiance sum in the units ``integrate.image`` divides by (the
    sum times ``2**32``, exact in float64), so that the harness's image is
    the sum over ``spp``, rounded as the program rounds it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = pixels.device
    res = tuple(config["resolution"])
    limit = config["depth"]
    fr = cam_mod.frame(config["camera"], res, device)
    hit = hit_fn(tables(scene, device, dtype))
    n_pix = pixels.shape[0]
    acc = torch.zeros((n_pix, 3), dtype=dtype, device=device)
    segments = torch.zeros((n_pix,), dtype=torch.int64, device=device)
    for sample in range(spp):
        row = torch.arange(n_pix, dtype=torch.int64, device=device)
        pix = pixels
        ro, rd = cam_mod.primary(fr, "thinlens", res, pix, seed, sample, dtype)
        thr = torch.ones_like(ro)
        radiance = torch.zeros((n_pix, 3), dtype=dtype, device=device)
        for b in range(limit):
            if row.numel() == 0:
                break
            segments.index_add_(0, row, torch.ones_like(row))
            hit_mask, point, normal, mat = hit(ro, rd)
            esc = torch.nonzero(~hit_mask).squeeze(1)
            radiance.index_add_(0, row[esc], sky(rd[esc]) * thr[esc])
            if b + 1 == limit:
                break
            keep = torch.nonzero(hit_mask).squeeze(1)
            row, pix = row[keep], pix[keep]
            base = rng.base(rng.stream(seed, sample, b, rng.STREAM_BSDF), pix)
            ro, rd, thr = scatter_legacy(rd[keep], thr[keep], point[keep], normal[keep],
                                         {k: v[keep] for k, v in mat.items()}, base)
        acc = acc + radiance
    return acc.to(torch.float64) * FIXED_ONE, segments
