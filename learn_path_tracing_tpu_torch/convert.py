"""Carry state across from the JAX package as numpy arrays.

The port never imports the JAX package. These helpers take the leaves of its
``SphereWorldData``, ``CameraParams`` and ``LegacyWorldData`` (converted
with ``np.asarray``) and build the port's own objects on ``device``, so both
packages can run on the same scene, camera and tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.bvh import FlatBVH
from .accel.wide import WideBVH
from .camera.camera import CameraParams
from .core.types import Materials
from .io.texture import StripAtlas
from .ops.packet_traverse import stack_cap
from .ops.sphere_scan import pack_spheres
from .scene.legacy_world import LegacyWorldData, MeshDeviceData, SphereDeviceData
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


def _table(x, device):
    """A JAX table as a torch tensor with the same bits: numpy carries
    bfloat16 as its own ``bfloat16`` type, read here as 16-bit words."""
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _strip_atlas(atlas, device) -> StripAtlas:
    """The port's ``StripAtlas`` from the JAX package's, leaf for leaf."""
    return StripAtlas(table=_table(atlas.table, device),
                      **{k: torch.as_tensor(np.array(getattr(atlas, k), np.int32), device=device)
                         for k in ("info_low", "info_high", "base", "spr", "info")})


def _flat_bvh(b) -> FlatBVH:
    """The port's ``FlatBVH`` from the JAX package's (numpy leaves)."""
    return FlatBVH(**{k: np.asarray(getattr(b, k), np.int32)
                      for k in ("left", "right", "data", "cut", "prim")},
                   low=np.asarray(b.low, np.float32), high=np.asarray(b.high, np.float32),
                   max_depth=int(b.max_depth), max_leaf=int(b.max_leaf))


def _wide_bvh(w) -> WideBVH:
    """The port's ``WideBVH`` from the JAX package's (numpy leaves)."""
    return WideBVH(child_low=np.asarray(w.child_low, np.float32),
                   child_high=np.asarray(w.child_high, np.float32),
                   child_entry=np.asarray(w.child_entry, np.int32),
                   prim=np.asarray(w.prim, np.int32), depth=int(w.depth),
                   max_leaf=int(w.max_leaf))


def _nodes(nodes, device):
    """A packet ``nodes`` table as a tensor: f32, or bfloat16 bit for bit
    where the JAX world holds ``nodes_to_bf16``'s table (``LPT_PACKET_BF16``)."""
    nodes = np.asarray(nodes)
    if nodes.dtype.name == "bfloat16":
        return torch.from_numpy(nodes.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(nodes, np.float32), device=device)


def legacy_world_from_numpy(world, device=None, packet_version: int = 2) -> LegacyWorldData:
    """A ``LegacyWorldData`` from the JAX package's ``LegacyWorldData`` with
    every leaf a numpy array (e.g. ``jax.tree_util.tree_map(np.asarray,
    wd)``); fields are read by name. The traversal tables, triangle
    attributes, sphere arrays and strip-packed atlases are taken as they are
    (the bfloat16 material table bit for bit). ``packet_version`` picks the
    mesh traversal kernel (the JAX package reads it from
    ``LPT_PACKET_VERSION`` instead)."""
    def t(x, dtype=np.float32):
        return torch.as_tensor(np.array(x, dtype), device=device)

    meshes = []
    for m in world.meshes:
        nodes, entries, runs = m.packet
        meshes.append(MeshDeviceData(
            **{k: t(getattr(m, k)) for k in
               ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")},
            tex=t(m.tex, np.int32), bvh=_flat_bvh(m.bvh),
            wide=_wide_bvh(m.wide),
            packet=(_nodes(nodes, device), t(entries, np.int32), t(runs)),
            treelets=(t(m.treelets[0]), t(m.treelets[1])),
            stack=stack_cap(np.asarray(entries))))
    spheres = None
    if world.spheres is not None:
        s = world.spheres
        c, r, tr = t(s.center), t(s.radius), t(s.transparency)
        packet = treelets = None
        stack = 0
        if s.packet is not None:
            nodes, entries, runs = s.packet
            packet = (t(nodes), t(entries, np.int32), t(runs))
            treelets = (t(s.treelets[0]), t(s.treelets[1]))
            stack = stack_cap(np.asarray(entries))
        spheres = SphereDeviceData(
            center=c, radius=r, transparency=tr, tex=t(s.tex, np.int32),
            bvh=_flat_bvh(s.bvh), scan_table=pack_spheres(c, r, tr),
            scan_attrs=torch.zeros((c.shape[0], 16), dtype=torch.float32, device=device),
            packet=packet, treelets=treelets, stack=stack)
    return LegacyWorldData(
        meshes=tuple(meshes), spheres=spheres,
        atlas=_strip_atlas(world.atlas, device),
        envs=_strip_atlas(world.envs, device),
        env_id=int(np.asarray(world.env_id)),
        tri_attr=None if world.tri_attr is None else t(world.tri_attr),
        env_gradient_h=world.env_gradient_h,
        packet_version=packet_version)
