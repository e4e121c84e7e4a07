"""Primary rays of the path tracer's cameras, frozen.

A copy of the port's ``camera/camera.py`` ray generation: yaw, pitch, roll
in f32 degrees; the modern thin lens (``fov`` the full horizontal angle,
sub-pixel jitter and an aperture disk sample) and the legacy jittered
pinhole (``fov`` the half angle). Pixel ``p`` is column ``p // H``, row
``p % H``; the camera stream keys on ``(seed, sample, pixel)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .shading import normalize, sample_in_disk

DEG2RAD = np.float32(np.pi / 180.0)


def look_at_angles(camera) -> dict:
    """Yaw, pitch and roll in degrees of a camera at ``position`` looking at
    ``look_at``, as the camera's ``look_at`` sets them (Python floats)."""
    px, py, pz = camera["position"]
    tx, ty, tz = camera["look_at"]
    dx, dy, dz = tx - px, ty - py, tz - pz
    norm = math.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / norm, dy / norm, dz / norm
    return {"yaw": math.degrees(math.atan2(-dx, -dz)), "pitch": math.degrees(math.asin(dy)),
            "roll": 0.0}


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def frame(camera, resolution, device) -> dict:
    """The camera's frame at ``resolution``: position, direction, the two
    image axes, the view extent, the half aperture and the focal length."""
    w, h = resolution
    angles = look_at_angles(camera)
    y = _f32(angles["yaw"], device) * DEG2RAD
    p = _f32(angles["pitch"], device) * DEG2RAD
    r = _f32(angles["roll"], device) * DEG2RAD
    cy, sy, cp, sp_, cr, sr = (torch.cos(y), torch.sin(y), torch.cos(p), torch.sin(p),
                               torch.cos(r), torch.sin(r))
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    yaw_m = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    pitch_m = torch.stack([one, zero, zero, zero, cp, -sp_, zero, sp_, cp]).reshape(3, 3)
    roll_m = torch.stack([cr, -sr, zero, sr, cr, zero, zero, zero, one]).reshape(3, 3)
    trans = yaw_m @ pitch_m @ roll_m
    fov_scale = _f32(0.5 if camera["fov_convention"] == "full" else 1.0, device)
    view_width = 2.0 * torch.tan(_f32(camera["fov"], device) * DEG2RAD * fov_scale)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    return {"position": _f32(camera["position"], device), "direction": trans @ -eye[2],
            "width_axis": trans @ eye[0], "height_axis": trans @ eye[1],
            "view_width": view_width, "view_height": view_width * (h / w),
            "half_aperture": _f32(camera.get("aperture", 0.0), device) * 0.5,
            "focal_length": _f32(camera.get("focal_length", 1.0), device)}


def primary(fr, model, resolution, pix, seed, sample, dtype=torch.float32):
    """``(ro, rd)`` ``[N,3]`` of the absolute pixel ids ``pix`` (int64) for
    their samples ``sample``; ``model`` 'thinlens' or 'jitter'."""
    w, h = resolution
    fi = (pix // h).to(torch.float32)
    fj = (pix % h).to(torch.float32)
    b = rng.base(rng.stream(seed, sample, 0, rng.STREAM_CAMERA), pix)
    u0, u1 = rng.uniform(b, 0), rng.uniform(b, 1)
    du = ((fi + u0) / w - 0.5) * fr["view_width"]
    dv = ((fj + u1) / h - 0.5) * fr["view_height"]
    if model == "jitter":
        rd = normalize(fr["direction"][None, :] + du[:, None] * fr["width_axis"][None, :]
                       + dv[:, None] * fr["height_axis"][None, :])
        ro = fr["position"][None, :].expand(pix.shape[0], 3).contiguous()
        return ro.to(dtype), rd.to(dtype)
    u2, u3 = rng.uniform(b, 2), rng.uniform(b, 3)
    target = fr["focal_length"] * (
        fr["direction"][None, :] + du[:, None] * fr["width_axis"][None, :]
        + dv[:, None] * fr["height_axis"][None, :])
    disk = sample_in_disk(u2, u3)
    origin = fr["half_aperture"] * (disk[:, 0:1] * fr["width_axis"][None, :]
                                    + disk[:, 1:2] * fr["height_axis"][None, :])
    return (fr["position"][None, :] + origin).to(dtype), normalize(target - origin).to(dtype)
