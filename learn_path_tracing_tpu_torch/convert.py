"""Carry state across from the JAX package as numpy arrays.

The port never imports the JAX package. These helpers take the leaves of its
``SphereWorldData`` and ``CameraParams`` (converted with ``np.asarray``) and
build the port's own objects on ``device``, so both packages can run on the
same scene and camera.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera.camera import CameraParams
from .core.types import Materials
from .scene.world import SphereWorldData


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)  # a writable copy


def world_from_numpy(centers, radii, albedo, roughness, metallic, ior,
                     transparency, absorptivity, device=None) -> SphereWorldData:
    """A ``SphereWorldData`` from the JAX world's ``centers f32[S,3]``,
    ``radii f32[S]`` and material leaves (``albedo f32[S,3]``, the rest
    ``f32[S]``)."""
    return SphereWorldData(
        centers=_f32(centers, device),
        radii=_f32(radii, device),
        materials=Materials(
            albedo=_f32(albedo, device),
            roughness=_f32(roughness, device),
            metallic=_f32(metallic, device),
            ior=_f32(ior, device),
            transparency=_f32(transparency, device),
            absorptivity=_f32(absorptivity, device),
        ),
    )


def camera_from_numpy(position, yaw, pitch, roll, fov, focal_length, aperture,
                      fov_scale=0.5, device=None) -> CameraParams:
    """A ``CameraParams`` from the JAX camera's leaves (``position f32[3]``,
    the rest f32 scalars)."""
    return CameraParams(
        position=_f32(position, device),
        yaw=_f32(yaw, device),
        pitch=_f32(pitch, device),
        roll=_f32(roll, device),
        fov=_f32(fov, device),
        focal_length=_f32(focal_length, device),
        aperture=_f32(aperture, device),
        fov_scale=_f32(fov_scale, device),
    )
