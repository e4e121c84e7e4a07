"""Cameras: yaw/pitch/roll rotation, pinhole and thin-lens ray generation.

Counterparts of ``learn_path_tracing_tpu.camera.camera``:

- ``model='center'``  — stages 2-4: rays through pixel centers, no jitter,
  offsets ``i/(W-1) - 0.5``;
- ``model='jitter'``  — jittered pinhole, bit-identical to a degenerate
  thin lens (aperture 0, focal length 1);
- ``model='thinlens'`` — stages 5-10: sub-pixel jitter ``(i+u)/W - 0.5`` and
  thin-lens depth of field.

The angle math (``deg2rad``, ``cos``, ``sin``, ``tan``) runs on float32
tensors, as the JAX package runs it on f32 arrays, so the rays agree with
it to a few ulps; doing it in Python's float64 would shift every ray.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import rng
from ..core.types import Rays
from ..bsdf import sampling as sp

_DEG2RAD = np.float32(np.pi / 180.0)


@dataclass(frozen=True)
class CameraParams:
    position: torch.Tensor      # f32[3]
    yaw: torch.Tensor           # f32 degrees
    pitch: torch.Tensor         # f32 degrees
    roll: torch.Tensor          # f32 degrees
    fov: torch.Tensor           # f32 degrees (horizontal)
    focal_length: torch.Tensor  # f32
    aperture: torch.Tensor      # f32
    # fov degrees → half-angle factor: 0.5 for the modern camera (fov is the
    # full horizontal angle), 1.0 for the legacy camera (fov is the half angle)
    fov_scale: torch.Tensor = None  # f32

    @property
    def device(self) -> torch.device:
        return self.position.device


def rotation_matrix(yaw_deg, pitch_deg, roll_deg):
    """Yaw (about +y), then pitch (about +x), then roll (about +z). Takes f32
    scalar tensors in degrees; returns ``f32[3,3]`` on their device."""
    y = yaw_deg * _DEG2RAD
    p = pitch_deg * _DEG2RAD
    r = roll_deg * _DEG2RAD
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp_ = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    yaw_m = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    pitch_m = torch.stack([one, zero, zero, zero, cp, -sp_, zero, sp_, cp]).reshape(3, 3)
    roll_m = torch.stack([cr, -sr, zero, sr, cr, zero, zero, zero, one]).reshape(3, 3)
    return yaw_m @ pitch_m @ roll_m


def pixel_grid(resolution, device=None):
    """Flat pixel ids; index p maps to (i, j) = (p // H, p % H), matching the
    reference's (W, H) field layout. int64 holding uint32 values."""
    w, h = resolution
    return torch.arange(w * h, dtype=torch.int64, device=device)


@dataclass(frozen=True)
class LensFrame:
    """A camera's constants at one resolution, on its device: what ray
    generation reads. The bounce kernel reads the same values packed into
    16 floats (``ops.bounce_megakernel.pack_camera``)."""

    position: torch.Tensor       # f32[3]
    direction: torch.Tensor      # f32[3] view direction
    width_axis: torch.Tensor     # f32[3]
    height_axis: torch.Tensor    # f32[3]
    view_width: torch.Tensor     # f32
    view_height: torch.Tensor    # f32
    half_aperture: torch.Tensor  # f32
    focal_length: torch.Tensor   # f32


def lens_frame(params: CameraParams, resolution) -> LensFrame:
    """The frame of ``params`` at ``resolution``, in f32 on its device."""
    w, h = resolution
    trans = rotation_matrix(params.yaw, params.pitch, params.roll)
    fov_scale = params.fov_scale if params.fov_scale is not None else 0.5
    view_width = 2.0 * torch.tan(params.fov * _DEG2RAD * fov_scale)
    eye = torch.eye(3, dtype=torch.float32, device=params.device)  # made on the device: no copy
    return LensFrame(
        position=params.position, direction=trans @ -eye[2],
        width_axis=trans @ eye[0], height_axis=trans @ eye[1],
        view_width=view_width, view_height=view_width * (h / w),
        half_aperture=params.aperture * 0.5, focal_length=params.focal_length)


def _camera_stream(seed, sample, stream_h):
    """The camera stream's hash of ``(seed, sample)``, or ``stream_h`` where
    it is given."""
    return rng.stream(seed, sample, 0, rng.STREAM_CAMERA) if stream_h is None else stream_h


def thin_lens_rays(frame: LensFrame, resolution, pix, seed, sample, stream_h=None):
    """Thin-lens primary rays ``(ro, rd)``, each ``f32[N,3]``, for the
    int64 absolute pixel ids ``pix``: sub-pixel jitter ``(i+u)/W - 0.5`` and
    a disk sample on the aperture, from the camera stream of ``(seed,
    sample, pixel)``. ``stream_h``: that stream's hash
    (``rng.stream(seed, sample, 0, rng.STREAM_CAMERA)``) in place of
    ``seed`` and ``sample``, a 0-d int64 tensor that a captured CUDA graph
    reads (``integrator.wavefront.PassGraphs``)."""
    w, h = resolution
    fi = (pix // h).to(torch.float32)
    fj = (pix % h).to(torch.float32)
    b = rng.base(_camera_stream(seed, sample, stream_h), pix)
    u0, u1 = rng.uniform2(b, 0)
    u2, u3 = rng.uniform2(b, 2)
    du = ((fi + u0) / w - 0.5) * frame.view_width
    dv = ((fj + u1) / h - 0.5) * frame.view_height
    target = frame.focal_length * (
        frame.direction[None, :] + du[:, None] * frame.width_axis[None, :]
        + dv[:, None] * frame.height_axis[None, :]
    )
    disk = sp.sample_in_disk(u2, u3)
    origin = frame.half_aperture * (
        disk[:, 0:1] * frame.width_axis[None, :] + disk[:, 1:2] * frame.height_axis[None, :]
    )
    return frame.position[None, :] + origin, sp.normalize(target - origin)


def generate_rays_for_pixels(params: CameraParams, resolution, pixel_ids,
                             seed, sample, model: str = "thinlens",
                             stream_h=None) -> Rays:
    """Emit one primary ray for each absolute pixel id in ``pixel_ids``.

    RNG is keyed on the absolute pixel id, so rays for a chunk of the pixel
    grid equal those of the full grid. ``sample`` is an int or a per-lane
    tensor. Pixel ids >= W*H produce valid dummy rays. ``stream_h``: the
    camera stream's hash in place of ``seed`` and ``sample``
    (``thin_lens_rays``).
    """
    w, h = resolution
    n = pixel_ids.shape[0]
    dev = pixel_ids.device
    pix = pixel_ids.to(torch.int64)
    f = lens_frame(params, resolution)

    if model == "center":
        fi = (pix // h).to(torch.float32)
        fj = (pix % h).to(torch.float32)
        du = (fi / (w - 1) - 0.5) * f.view_width
        dv = (fj / (h - 1) - 0.5) * f.view_height
        rd = sp.normalize(
            f.direction[None, :] + du[:, None] * f.width_axis[None, :]
            + dv[:, None] * f.height_axis[None, :]
        )
        ro = params.position[None, :].expand(n, 3)
    elif model == "jitter":
        # Jittered pinhole: bit-identical to 'thinlens' with aperture=0 and
        # focal_length=1 (same u0/u1 counters, origin exactly 0), without the
        # second RNG hash and the disk sample.
        fi = (pix // h).to(torch.float32)
        fj = (pix % h).to(torch.float32)
        b = rng.base(_camera_stream(seed, sample, stream_h), pix)
        u0, u1 = rng.uniform2(b, 0)
        du = ((fi + u0) / w - 0.5) * f.view_width
        dv = ((fj + u1) / h - 0.5) * f.view_height
        rd = sp.normalize(
            f.direction[None, :] + du[:, None] * f.width_axis[None, :]
            + dv[:, None] * f.height_axis[None, :]
        )
        ro = params.position[None, :].expand(n, 3)
    elif model == "thinlens":
        ro, rd = thin_lens_rays(f, resolution, pix, seed, sample, stream_h)
    else:
        raise ValueError(f"unknown camera model: {model!r}")

    return Rays(
        ro=ro.contiguous(),
        rd=rd,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def generate_rays(params: CameraParams, resolution, seed, sample,
                  model: str = "thinlens") -> Rays:
    """Emit one jittered primary ray per pixel as a flat wavefront [W*H]."""
    return generate_rays_for_pixels(
        params, resolution, pixel_grid(resolution, params.device), seed, sample,
        model=model,
    )


class Camera:
    """Host camera state mirroring the reference's Camera class."""

    FOV_SCALE = 0.5   # full-angle fov (modern line)

    def __init__(self, resolution, fov=60.0, focal_length=1.0, aperture=0.0):
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.fov = float(fov)
        self.focal_length = float(focal_length)
        self.aperture = float(aperture)
        self.position = (0.0, 0.0, 0.0)
        self.yaw = 0.0
        self.pitch = 0.0
        self.roll = 0.0

    # -- reference API --
    def set_position(self, position):
        self.position = tuple(float(c) for c in position)

    def set_direction(self, yaw, pitch, roll=0.0):
        self.yaw, self.pitch, self.roll = float(yaw), float(pitch), float(roll)

    def set_fov(self, fov):
        self.fov = float(fov)

    def set_len(self, focal_length=1.0, aperture=0.0):
        self.focal_length = float(focal_length)
        self.aperture = float(aperture)

    def look_at(self, target, roll=0.0):
        dx = target[0] - self.position[0]
        dy = target[1] - self.position[1]
        dz = target[2] - self.position[2]
        norm = math.sqrt(dx * dx + dy * dy + dz * dz)
        dx, dy, dz = dx / norm, dy / norm, dz / norm
        self.yaw = math.degrees(math.atan2(-dx, -dz))
        self.pitch = math.degrees(math.asin(dy))
        self.roll = float(roll)

    # -- legacy free-fly controls --
    def _axes(self):
        y, p = math.radians(self.yaw), math.radians(self.pitch)
        front = (-math.sin(y) * math.cos(p), math.sin(p), -math.cos(y) * math.cos(p))
        right = (math.cos(y), 0.0, -math.sin(y))
        up = (0.0, 1.0, 0.0)
        return front, right, up

    def _move(self, axis, dist):
        self.position = tuple(p + dist * a for p, a in zip(self.position, axis))

    def move_front(self, dist):
        self._move(self._axes()[0], dist)

    def move_right(self, dist):
        self._move(self._axes()[1], dist)

    def move_up(self, dist):
        self._move(self._axes()[2], dist)

    def rotate(self, dyaw, dpitch):
        self.yaw = (self.yaw + dyaw) % 360.0
        self.pitch = max(-89.0, min(89.0, self.pitch + dpitch))

    def params(self, device=None) -> CameraParams:
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return CameraParams(
            position=f32(self.position),
            yaw=f32(self.yaw),
            pitch=f32(self.pitch),
            roll=f32(self.roll),
            fov=f32(self.fov),
            focal_length=f32(self.focal_length),
            aperture=f32(self.aperture),
            fov_scale=f32(self.FOV_SCALE),
        )

    def get_rays(self, seed=0, sample=0, model="thinlens", device=None) -> Rays:
        return generate_rays(self.params(device), self.resolution, seed, sample, model)


class LegacyCamera(Camera):
    """Camera with the legacy line's fov convention: ``fov`` is the HALF
    horizontal angle (view_width = 2·tan(fov))."""

    FOV_SCALE = 1.0
