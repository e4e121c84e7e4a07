"""Plain reference of the textured mesh scenes (the legacy line): nearest
triangle by a scan of every triangle, smooth normals and uvs from the
barycentric weights, the bilinear material and environment taps, the legacy
hit record and BSDF.

Everything is worked out again from the benchmark's own arrays
(``scenes/standin.py``): the triangle test is the plane-then-barycentric
test of the reference (15_module.py:909-967) in its coefficient form, whose
per-triangle coefficients are computed here with the same numpy operations
the program's packer documents; the nearest hit is the least ``(t,
triangle)`` with ``t > 1e-4`` and all three weights positive. Textures are
the 8-bit images the program reads, linearised (albedo^2.2, roughness^2,
metallic^2, normal*2-1) and held in bfloat16 like the program's material
atlas; the sky is the half-float EXR widened to f32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera as cam_mod
from . import integrate
from .shading import scatter_legacy

EPS = 1e-4
IOR = 1.5
ABSORPTIVITY = 0.25
RAY_CHUNK = 2048   # rays a step of the triangle scan


def _coefficients(p1s, p2s, p3s):
    """Per triangle, the 12 f32 coefficients ``n, p1·n, g1, c1, g2, c2`` of
    the plane-then-barycentric test (numpy, one triangle at a time)."""
    out = np.empty((p1s.shape[0], 12), np.float32)
    for i in range(p1s.shape[0]):
        p1, p2, p3 = p1s[i], p2s[i], p3s[i]
        n = np.cross(p2 - p1, p3 - p1)
        nn = np.sqrt(np.dot(n, n))
        n = n / max(nn, 1e-20)
        den1 = np.dot(np.cross(p3 - p2, p1 - p2), n)
        den2 = np.dot(np.cross(p1 - p3, p2 - p3), n)
        den1 = den1 if abs(den1) > 1e-20 else 1e-20
        den2 = den2 if abs(den2) > 1e-20 else 1e-20
        g1 = np.cross(n, p3 - p2) / den1
        c1 = -np.dot(np.cross(p3 - p2, p2), n) / den1
        g2 = np.cross(n, p1 - p3) / den2
        c2 = -np.dot(np.cross(p1 - p3, p3), n) / den2
        out[i] = [n[0], n[1], n[2], np.dot(p1, n), g1[0], g1[1], g1[2], c1,
                  g2[0], g2[1], g2[2], c2]
    return out


def _material(scene):
    """``[W, H, 8]`` f32 material texels (albedo, normal, roughness,
    metallic), column ``x`` and row ``y`` with v pointing up, as loaded."""
    def texels(img):
        a = np.asarray(img, np.float32) / 255.0
        if a.ndim == 3:
            return np.flip(a.transpose(1, 0, 2)[..., :3], 1)
        return np.flip(a.transpose(1, 0), 1)

    albedo, rough = texels(scene["albedo"]), texels(scene["roughness"])
    metal, normal = texels(scene["metallic"]), texels(scene["normal_map"])
    out = np.zeros(albedo.shape[:2] + (8,), np.float32)
    out[..., 0:3] = albedo ** 2.2
    out[..., 3:6] = normal * 2.0 - 1.0
    out[..., 6] = rough ** 2
    out[..., 7] = metal ** 2
    return out


def tables(scene, device) -> dict:
    faces = np.asarray(scene["faces"], np.int64)
    p = np.asarray(scene["positions"], np.float32)[faces]     # [T,3,3]
    n = np.asarray(scene["normals"], np.float32)[faces]
    uv = np.asarray(scene["uvs"], np.float32)[faces]
    env = np.flip(np.asarray(scene["env"], np.float16).astype(np.float32).transpose(1, 0, 2), 1)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return {"coef": t(_coefficients(p[:, 0], p[:, 1], p[:, 2])),
            "p": t(p), "n": t(n), "uv": t(uv),
            "tex": t(scene["face_tex"], np.int64),
            "material": t(_material(scene)).to(torch.bfloat16),
            "env": t(env)}


def nearest(coef, ro, rd, eps=EPS):
    """``(t [N] (+inf on a miss), triangle int64 [N] (-1 on a miss))``."""
    c = [coef[None, :, k] for k in range(12)]
    ts, ps = [], []
    for r0 in range(0, ro.shape[0], RAY_CHUNK):
        o = [ro[r0:r0 + RAY_CHUNK, k:k + 1] for k in range(3)]
        d = [rd[r0:r0 + RAY_CHUNK, k:k + 1] for k in range(3)]
        denom = (d[0] * c[0] + d[1] * c[1]) + d[2] * c[2]
        ron = (o[0] * c[0] + o[1] * c[1]) + o[2] * c[2]
        t = (c[3] - ron) / denom
        w1 = (((o[0] * c[4] + o[1] * c[5]) + o[2] * c[6])
              + t * ((d[0] * c[4] + d[1] * c[5]) + d[2] * c[6])) + c[7]
        w2 = (((o[0] * c[8] + o[1] * c[9]) + o[2] * c[10])
              + t * ((d[0] * c[8] + d[1] * c[9]) + d[2] * c[10])) + c[11]
        w3 = (1.0 - w1) - w2
        ok = (t > eps) & (w1 > 0.0) & (w2 > 0.0) & (w3 > 0.0)
        t = torch.where(ok, t, float("inf"))
        t_min, prim = torch.min(t, dim=1)      # the first triangle among equal t
        ts.append(t_min)
        ps.append(torch.where(torch.isfinite(t_min), prim, -1))
    return torch.cat(ts), torch.cat(ps)


def _imod(a, m):
    af = a.to(torch.float32)
    mf = torch.clamp_min(m.to(torch.float32), 1.0)
    return (af - torch.floor(af / mf) * mf).to(torch.int64)


def bilinear(table, u, v):
    """Bilinear tap of ``table [W,H,C]`` at ``(u, v)`` with wrap-around:
    texels widened to f32, blended along v, then along u."""
    w, h = table.shape[0], table.shape[1]
    wf, hf = float(w), float(h)
    uu = u * wf - 0.5
    vv = v * hf - 0.5
    l = uu.to(torch.int32)
    b = vv.to(torch.int32)
    wl = ((l + 1).to(torch.float32) - uu)[:, None]
    wb = ((b + 1).to(torch.float32) - vv)[:, None]
    wt, ht = torch.tensor(w, device=u.device), torch.tensor(h, device=u.device)
    x0, y0 = _imod(l, wt), _imod(b, ht)
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h

    def tex(x, y):
        return table[x, y].to(torch.float32)

    left = (wb * tex(x0, y0) + (1.0 - wb) * tex(x0, y1)) + 0.0
    right = (wb * tex(x1, y0) + (1.0 - wb) * tex(x1, y1)) + 0.0
    return wl * left + (1.0 - wl) * right


def environment(env):
    def escape(rd):
        phi = torch.asin(torch.clamp(rd[:, 1], -1.0, 1.0))
        v = phi / torch.pi + 0.5
        theta = torch.atan2(-rd[:, 0], -rd[:, 2])
        u = (theta / torch.pi + 1.0) / 2.0
        return bilinear(env, u, v)
    return escape


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def hit_fn(tab):
    def hit(ro, rd):
        t, prim = nearest(tab["coef"], ro, rd)
        hit_mask = prim >= 0
        point = ro + torch.where(hit_mask, t, 0.0)[:, None] * rd
        k = torch.clamp_min(prim, 0)
        p, nv, uv = tab["p"][k], tab["n"][k], tab["uv"][k]
        p1x, p1y, p1z = p[:, 0, 0], p[:, 0, 1], p[:, 0, 2]
        p2x, p2y, p2z = p[:, 1, 0], p[:, 1, 1], p[:, 1, 2]
        p3x, p3y, p3z = p[:, 2, 0], p[:, 2, 1], p[:, 2, 2]
        nx, ny, nz = _cross(p2x - p1x, p2y - p1y, p2z - p1z, p3x - p1x, p3y - p1y, p3z - p1z)
        ninv = 1.0 / torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
        px, py, pz = point[:, 0], point[:, 1], point[:, 2]
        ex, ey, ez = p3x - p2x, p3y - p2y, p3z - p2z
        cx, cy, cz = _cross(ex, ey, ez, px - p2x, py - p2y, pz - p2z)
        dx, dy, dz = _cross(ex, ey, ez, p1x - p2x, p1y - p2y, p1z - p2z)
        w1 = (cx * nx + cy * ny + cz * nz) / (dx * nx + dy * ny + dz * nz)
        ex, ey, ez = p1x - p3x, p1y - p3y, p1z - p3z
        cx, cy, cz = _cross(ex, ey, ez, px - p3x, py - p3y, pz - p3z)
        dx, dy, dz = _cross(ex, ey, ez, p2x - p3x, p2y - p3y, p2z - p3z)
        w2 = (cx * nx + cy * ny + cz * nz) / (dx * nx + dy * ny + dz * nz)
        w3 = 1.0 - w1 - w2
        smx = w1 * nv[:, 0, 0] + w2 * nv[:, 1, 0] + w3 * nv[:, 2, 0]
        smy = w1 * nv[:, 0, 1] + w2 * nv[:, 1, 1] + w3 * nv[:, 2, 1]
        smz = w1 * nv[:, 0, 2] + w2 * nv[:, 1, 2] + w3 * nv[:, 2, 2]
        sinv = 1.0 / torch.clamp_min(torch.sqrt(smx * smx + smy * smy + smz * smz), 1e-20)
        su = w1 * uv[:, 0, 0] + w2 * uv[:, 1, 0] + w3 * uv[:, 2, 0]
        sv = w1 * uv[:, 0, 1] + w2 * uv[:, 1, 1] + w3 * uv[:, 2, 1]
        normal = torch.stack([smx * sinv, smy * sinv, smz * sinv], -1)
        tap = bilinear(tab["material"], su, sv)
        ones = torch.ones_like(t)
        backface = (torch.sum(rd * normal, dim=-1) > 0.0) & hit_mask
        normal = torch.where(backface[:, None], -normal, normal)
        mat = {"albedo": tap[:, 0:3], "roughness": tap[:, 6], "metallic": tap[:, 7],
               "ior": torch.where(backface, 1.0 / (IOR * ones), IOR * ones),
               "absorptivity": torch.where(backface, 0.0, ABSORPTIVITY * ones),
               "transparency": torch.zeros_like(t)}
        return hit_mask, point, normal, mat
    return hit


def render(scene, config, seed, spp: int, pixels, block: int = 1 << 18, tab=None):
    """``(acc int64[P,3], segments int64[P])`` of the pixels ``pixels`` of
    the config's frame at ``spp`` samples, frame seed ``seed``. ``tab``:
    ``tables(scene, device)``, when already made."""
    device = pixels.device
    res = tuple(config["resolution"])
    fr = cam_mod.frame(config["camera"], res, device)
    tab = tab if tab is not None else tables(scene, device)

    def primary(pix, sample):
        return cam_mod.primary(fr, "jitter", res, pix, seed, sample)

    return integrate.render(pixels, spp, config["depth"], seed, primary, hit_fn(tab),
                            environment(tab["env"]), scatter_legacy, block)
