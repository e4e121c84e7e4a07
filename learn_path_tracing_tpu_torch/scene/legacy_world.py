"""Legacy-line world: textured triangle meshes + spheres + IBL environment.

Counterpart of ``learn_path_tracing_tpu.scene.legacy_world`` (the
reference's module-15 ``World``): one sphere set plus triangle meshes,
materials sampled from a texture atlas at hit time, an equirect environment
as the escape radiance, and ``.world.npy`` save/load.

- ``LegacyWorld``: host-side scene construction (numpy). ``build()``/``load()`` pack
  textures, build the BVHs and the traversal kernel's tables, and return
  the ``LegacyWorldData`` tensors on a device; ``device(dev)`` gives them on
  any other device.
- ``trace_legacy``: traversal only, nearest ``(t, prim, src)`` over the
  sphere set and every mesh. Meshes go through the packet-traversal kernel
  of the world's ``packet_version`` (K2 for 2, K5a for 1, K5b for 3: the
  JAX package's ``LPT_PACKET_VERSION``, as data); spheres through the
  sphere scan (K1) up to ``SPHERE_SCAN_CEILING`` spheres and through the
  sphere-leaf packet kernel (K3) above it.
- ``shade_from_trace`` / ``hit_legacy``: attributes and the atlas tap
  (``_attrs_block``) on the hit lanes only, then the legacy hit record
  (fixed ior and absorptivity, back-face flip).
- ``trace_shade_compact``: the bounce step of pool integrators, which
  returns hits compacted to a prefix and never restores lane order.
- ``environment_color``: the equirect IBL lookup.

Ray order follows the JAX package for the packet kernels (versions 1 and
3), whose cost is a packet's node union: ``trace_legacy`` and so
``hit_legacy`` traverse coherence-sorted unless the caller passes
``sort_rays=False`` (the hybrid integrator's primary slabs), and
``trace_shade_compact`` takes ``packet_traverse_sorted`` with the caller's
payload on single-mesh worlds from 4,096 rays. Version 2 (a ray per
thread) walks in lane order everywhere: its sort cost time on the card and
changed no result. Every route gives the same ``(t, prim)`` (the sorts are
permutations, the tie rule is order-free), so renders do not depend on the
version except on rays with a direction component of exactly 0, which the
v1 slab form hits and the others miss.

Two environment variables reach the mesh path, as in the JAX package:
``LPT_PACKET_BF16=1`` when a world is built or loaded stores its meshes'
node boxes in bfloat16 (``nodes_to_bf16``; K2h), and
``LPT_TREELET_RESTART=1`` when a single-mesh world without spheres is
traversed under version 2 from 4,096 rays sends the walk through
``packet_traverse_sorted(restart=True)`` (K2r), in ``hit_legacy`` and
``trace_shade_compact``. Unset, nothing changes; the restart gives the same
hits, the bf16 boxes do not (see ``ops.packet_traverse``).

The material atlas (bfloat16, 16 texels a strip) and the environments
(f32, 42 texels a strip) are the JAX package's strip-packed ``StripAtlas``
tables, tapped by ``sample_bilinear_strips``; the triangle-attribute row
and the atlas rows are fetched by the row-gather kernels (K6a, K6b) with
``jnp.take``'s wrap and fill rule, so a texture id past the last rect of a
multi-texture atlas gives a NaN tap there as it does in JAX.

Differences from the JAX package, none of which changes a result:
attribute shading runs on exactly the hit rows instead of static prefix
buckets (``_attrs_switch``'s ``_r256`` widths exist for XLA's static
shapes); the fused single-mesh hit path (``_hit_legacy_fused``) is the
composed sort, traversal and unsort, which the JAX package's tests hold
bitwise equal to it; the multi-mesh default merges meshes under one BVH, as there.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..accel.bvh import FlatBVH, build_bvh
from ..accel.wide import WideBVH, collapse
from ..core.types import Hits, Materials, Rays
from ..io.obj import MeshData
from ..io.texture import (
    StripAtlas,
    TextureManager,
    build_environment_atlas,
    build_texture_atlas,
    make_info_arrays,
    pack_strips,
    sample_bilinear_strips,
)
from ..ops.packet_traverse import (
    VERSIONS,
    nodes_to_bf16,
    pack_packet_tables,
    pack_sphere_packet_tables,
    packet_traverse,
    packet_traverse_sorted,
    stack_cap,
    treelet_boxes,
)
from ..ops.row_gather import gather
from ..ops.sphere_scan import intersect_spheres_scan, pack_spheres
from ..utils.profiling import host_read, span, spanned
from . import serialize

EPSILON = 1e-4
# Legacy constants baked into hit records (15_module.py:891-894, 946-950).
LEGACY_IOR = 1.5
LEGACY_ABSORPTIVITY = 0.25

# Up to this many spheres, trace_legacy brute-scans them (K1, O(S) per ray);
# above it, build()/load() pack a sphere BVH for the packet kernel (K3).
SPHERE_SCAN_CEILING = 4096

_INF = float("inf")


def _map_tensors(fn, obj):
    """``fn`` applied to every tensor in a dataclass / tuple tree."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_map_tensors(fn, x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


@dataclass(frozen=True)
class MeshDeviceData:
    v0: torch.Tensor   # f32[T,3] pre-gathered vertex positions
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor   # f32[T,3] vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # f32[T,2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    tex: torch.Tensor  # i32[T]
    bvh: FlatBVH       # host (numpy) trees the tables were packed from, for
    wide: WideBVH      # accel.traverse.traverse / accel.wide.traverse_wide
    packet: tuple      # (nodes, entries, runs) traversal tables
    treelets: tuple    # (lo f32[64,3], hi f32[64,3]) depth-2 subtree boxes,
                       # the coherence key of versions 1 and 3
    stack: int         # traversal stack bound of the tables


@dataclass(frozen=True)
class SphereDeviceData:
    center: torch.Tensor        # f32[S,3]
    radius: torch.Tensor        # f32[S]
    transparency: torch.Tensor  # f32[S]
    tex: torch.Tensor           # i32[S]
    bvh: FlatBVH                # host (numpy) tree, for accel.traverse.traverse
    packet: tuple | None        # (nodes, entries, runs) for K3, past the ceiling
    treelets: tuple | None
    scan_table: torch.Tensor    # f32[S,8] sphere-scan (K1) table
    scan_attrs: torch.Tensor    # f32[S,16] K1 epilogue rows (unused: zeros)
    stack: int = 0


@dataclass(frozen=True)
class LegacyWorldData:
    meshes: tuple                 # tuple[MeshDeviceData, ...]
    spheres: SphereDeviceData | None
    atlas: StripAtlas             # material atlas, strip-packed bf16 (8 channels)
    envs: StripAtlas              # equirect environments, strip-packed f32 (3 ch)
    env_id: int
    # every mesh's triangle attributes, one row per triangle: v0 v1 v2 (9),
    # n0 n1 n2 (9), uv0 uv1 uv2 (6), tex (1, f32), pad → 32
    tri_attr: torch.Tensor | None = None
    # rect height of the active environment when it holds the baked sky
    # gradient (its source file was missing): environment_color then
    # evaluates it in closed form
    env_gradient_h: int | None = None
    # kernel version of the mesh traversal (ops.packet_traverse: 2 = K2,
    # 1 = K5a, 3 = K5b); sphere tables always take version 2
    packet_version: int = 2

    def __post_init__(self):
        if self.packet_version not in VERSIONS:
            raise ValueError(f"packet_version must be one of {VERSIONS}, "
                             f"got {self.packet_version!r}")

    @property
    def device(self) -> torch.device:
        return self.atlas.table.device

    def to(self, device) -> "LegacyWorldData":
        return _map_tensors(lambda a: a.to(device), self)


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype))


def _mesh_device(positions, normals, uvs, face_p, face_n, face_t, face_tex,
                 bvh: FlatBVH) -> MeshDeviceData:
    """The mesh's tensors and traversal tables. ``LPT_PACKET_BF16=1`` (read
    here, at build and load time, as the JAX package reads it) stores the
    node boxes outward-rounded to bfloat16 (``nodes_to_bf16``): K2 then
    runs its bf16-slab mode (K2h). The treelet boxes come from the f32
    boxes either way."""
    p = np.asarray(positions, np.float32)[np.asarray(face_p)]   # [T,3,3]
    n = np.asarray(normals, np.float32)[np.asarray(face_n)]
    t = np.asarray(uvs, np.float32)[np.asarray(face_t)]
    wide = collapse(bvh)
    packet = pack_packet_tables(wide, p[:, 0], p[:, 1], p[:, 2])
    treelets = tuple(_t(x) for x in treelet_boxes(packet[0], packet[1]))
    nodes = _t(packet[0])
    if os.environ.get("LPT_PACKET_BF16", "0") == "1":
        nodes = nodes_to_bf16(packet[0])
    return MeshDeviceData(
        v0=_t(p[:, 0]), v1=_t(p[:, 1]), v2=_t(p[:, 2]),
        n0=_t(n[:, 0]), n1=_t(n[:, 1]), n2=_t(n[:, 2]),
        uv0=_t(t[:, 0]), uv1=_t(t[:, 1]), uv2=_t(t[:, 2]),
        tex=_t(face_tex, np.int32), bvh=bvh, wide=wide,
        packet=(nodes, _t(packet[1]), _t(packet[2])),
        treelets=treelets,
        stack=stack_cap(packet[1]),
    )


def _sphere_device(centers, radii, transp, tex, bvh,
                   sphere_packet: bool | None = None) -> SphereDeviceData:
    """SphereDeviceData, with packet-BVH tables when the scene is past the
    brute-scan ceiling (or when ``sphere_packet`` asks)."""
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    transp = np.asarray(transp, np.float32)
    want = (sphere_packet if sphere_packet is not None
            else centers.shape[0] > SPHERE_SCAN_CEILING)
    packet = treelets = None
    stack = 0
    if want:
        tables = pack_sphere_packet_tables(collapse(bvh), centers, radii, transp)
        packet = tuple(_t(x) for x in tables)
        treelets = tuple(_t(x) for x in treelet_boxes(tables[0], tables[1]))
        stack = stack_cap(tables[1])
    c, r, tr = _t(centers), _t(radii), _t(transp)
    return SphereDeviceData(
        center=c, radius=r, transparency=tr, tex=_t(tex, np.int32), bvh=bvh,
        scan_table=pack_spheres(c, r, tr),
        scan_attrs=torch.zeros((c.shape[0], 16), dtype=torch.float32),
        packet=packet, treelets=treelets, stack=stack)


def _merge_mesh_geometry(meshes_geo):
    """Concatenate N meshes' indexed geometry into one global index space
    (mesh-major triangle order, the order ``_tri_attr_table`` packs), so a
    multi-mesh scene costs one traversal per wavefront."""
    ps, ns, us = [], [], []
    fps, fns, fts, texs = [], [], [], []
    po = no = uo = 0
    for (p, n, u, fp, fn, ft, tex) in meshes_geo:
        ps.append(np.asarray(p, np.float32))
        ns.append(np.asarray(n, np.float32))
        us.append(np.asarray(u, np.float32))
        fps.append(np.asarray(fp, np.int64) + po)
        fns.append(np.asarray(fn, np.int64) + no)
        fts.append(np.asarray(ft, np.int64) + uo)
        texs.append(np.asarray(tex, np.int32))
        po += ps[-1].shape[0]
        no += ns[-1].shape[0]
        uo += us[-1].shape[0]
    return (np.concatenate(ps), np.concatenate(ns), np.concatenate(us),
            np.concatenate(fps), np.concatenate(fns), np.concatenate(fts),
            np.concatenate(texs))


def _build_mesh_devices(meshes_geo, mesh_max_depth, mesh_max_leaf,
                        merge: bool = True):
    """MeshDeviceData tuple for a list of mesh geometry tuples: one merged
    mesh when ``merge`` (the default), else one per mesh."""
    if merge and len(meshes_geo) > 1:
        meshes_geo = [_merge_mesh_geometry(meshes_geo)]
    devices = []
    for (p, n, u, fp, fn, ft, tex) in meshes_geo:
        tri_p = np.asarray(p)[np.asarray(fp)]
        bvh = build_bvh(tri_p.min(axis=1), tri_p.max(axis=1),
                        centroid=tri_p.mean(axis=1),
                        max_depth=mesh_max_depth, max_leaf=mesh_max_leaf)
        devices.append(_mesh_device(p, n, u, fp, fn, ft, tex, bvh))
    return tuple(devices)


def _tri_attr_table(meshes: tuple) -> torch.Tensor | None:
    """Every mesh's triangle attributes as one ``f32[sum(T), 32]`` table."""
    if not meshes:
        return None
    rows = []
    for m in meshes:
        rows.append(torch.cat([m.v0, m.v1, m.v2, m.n0, m.n1, m.n2,
                               m.uv0, m.uv1, m.uv2,
                               m.tex.to(torch.float32)[:, None]], dim=1))
    table = torch.cat(rows, dim=0)
    pad = torch.zeros((table.shape[0], 32 - table.shape[1]), dtype=torch.float32)
    return torch.cat([table, pad], dim=1).contiguous()


def _content_size(configs, fallback=(8, 8)):
    """Tight atlas extent covered by the packed rects."""
    if not configs:
        return fallback
    w = max(c["area"]["high"][0] for c in configs)
    h = max(c["area"]["high"][1] for c in configs)
    return (max(int(w), 1), max(int(h), 1))


def _default_environment(tm: TextureManager):
    """Files without an environment dump get a small builtin sky-gradient
    rect, so escape radiance is well defined."""
    if not tm.configs:
        tm.size = (64, 32)
        tm.configs = [{
            "file_path": "<builtin:sky>",
            "size": (64, 32), "id": 0,
            "area": {"low": (0, 0), "high": (64, 32)},
        }]


def _active_gradient_h(tm: TextureManager, environment, gradient_ids):
    """Rect height of the ACTIVE environment iff it holds the baked sky
    gradient, else None."""
    active = int(environment or 0)
    if active not in gradient_ids:
        return None
    for cfg in tm.configs:
        if int(cfg["id"]) == active:
            return int(cfg["area"]["high"][1]) - int(cfg["area"]["low"][1])
    return None


def _bvh_record(bvh: FlatBVH, max_depth: int) -> dict:
    return {"max_depth": max_depth,
            "nodes": {k: getattr(bvh, k) for k in ("left", "right", "low", "high", "data")},
            "cut": bvh.cut}


class LegacyWorld:
    """Host-side scene construction mirroring the reference's module-15 World."""

    def __init__(self, texture_size=(2048 * 6, 2048),
                 environment_size=(2048, 2048)):
        self.meshes: list[MeshData] = []
        self.spheres: list[dict] = []
        self.environment: int | None = None
        self.textures = TextureManager(texture_size)
        self.environments = TextureManager(environment_size)
        self._data: dict[str, LegacyWorldData] = {}   # per device
        self._bvh_records = None  # for save()

    def add_mesh(self, mesh: MeshData):
        self.meshes.append(mesh)
        self._data = {}

    def add_sphere(self, center, radius, transparency=0, texture_id=0):
        self.spheres.append({
            "center": tuple(float(c) for c in center),
            "radius": float(radius),
            "transparency": int(transparency),
            "texture_id": int(texture_id),
        })
        self._data = {}

    def set_environment(self, id):
        self.environment = int(id)

    def _finish(self, meshes, spheres, path_map, device,
                packet_version) -> LegacyWorldData:
        """Atlases plus the device structures → the world on ``device``."""
        _default_environment(self.environments)
        atlas_np = build_texture_atlas(self.textures.configs,
                                       _content_size(self.textures.configs),
                                       path_map=path_map)
        env_np, env_grad_ids = build_environment_atlas(
            self.environments.configs,
            _content_size(self.environments.configs), path_map=path_map)
        tex_low, tex_high = make_info_arrays(self.textures.configs)
        env_low, env_high = make_info_arrays(self.environments.configs)
        data = LegacyWorldData(
            meshes=tuple(meshes),
            spheres=spheres,
            # bfloat16 like the JAX package's material atlas (texture
            # sources are 8-bit); the blend runs in f32
            atlas=pack_strips(atlas_np, tex_low, tex_high, texels=16,
                              dtype=torch.bfloat16),
            envs=pack_strips(env_np, env_low, env_high, texels=42),
            env_id=int(self.environment or 0),
            tri_attr=_tri_attr_table(tuple(meshes)),
            env_gradient_h=_active_gradient_h(self.environments,
                                              self.environment, env_grad_ids),
            packet_version=packet_version,
        )
        self._data = {"cpu": data}
        return self.device(device)

    # ------------------------------------------------------------- build --
    def build(self, mesh_max_depth=24, sphere_max_depth=12, max_leaf=8,
              mesh_max_leaf=8, path_map=None, merge_meshes: bool = True,
              sphere_packet: bool | None = None, device=None,
              packet_version: int = 2) -> LegacyWorldData:
        """Pack textures, build atlases, BVHs and kernel tables; returns the
        world on ``device`` (default CPU).

        ``merge_meshes`` (default True): multi-mesh scenes traverse ONE
        merged BVH (one kernel launch per wavefront); False keeps one
        structure per mesh, traced in turn with each seeded by the best
        ``t`` so far (the reference's composition). ``sphere_packet``
        overrides the brute-scan ceiling (True: packet tables always).
        ``packet_version``: the mesh traversal kernel (2: K2, 1: K5a, 3:
        K5b), the JAX package's ``LPT_PACKET_VERSION``."""
        self.textures.build()
        _default_environment(self.environments)
        self.environments.build()

        merge = merge_meshes and len(self.meshes) > 1
        mesh_records, mesh_devices = [], []
        for mesh in self.meshes:
            tri_p = mesh.positions[mesh.face_p]      # [T,3,3]
            bvh = build_bvh(tri_p.min(axis=1), tri_p.max(axis=1),
                            centroid=tri_p.mean(axis=1),
                            max_depth=mesh_max_depth, max_leaf=mesh_max_leaf)
            if not merge:
                mesh_devices.append(_mesh_device(
                    mesh.positions, mesh.normals, mesh.uvs,
                    mesh.face_p, mesh.face_n, mesh.face_t, mesh.face_tex, bvh))
            # leaf-ordered faces for reference-compatible serialization
            order = bvh.prim
            rec = _bvh_record(bvh, mesh_max_depth)
            rec.update({
                "faces": {"p": mesh.face_p[order], "n": mesh.face_n[order],
                          "t": mesh.face_t[order], "tex": mesh.face_tex[order]},
                "positions": mesh.positions, "normals": mesh.normals,
                "uvs": mesh.uvs,
            })
            mesh_records.append(rec)
        if merge:
            mesh_devices = list(_build_mesh_devices(
                [(m.positions, m.normals, m.uvs, m.face_p, m.face_n,
                  m.face_t, m.face_tex) for m in self.meshes],
                mesh_max_depth, mesh_max_leaf, merge=True))

        sphere_record = sphere_device = None
        if self.spheres:
            centers = np.array([s["center"] for s in self.spheres], np.float32)
            radii = np.array([s["radius"] for s in self.spheres], np.float32)
            transp = np.array([s["transparency"] for s in self.spheres], np.float32)
            tex = np.array([s["texture_id"] for s in self.spheres], np.int32)
            bvh = build_bvh(centers - radii[:, None], centers + radii[:, None],
                            centroid=centers, max_depth=sphere_max_depth,
                            max_leaf=max_leaf)
            sphere_device = _sphere_device(centers, radii, transp, tex, bvh,
                                           sphere_packet)
            order = bvh.prim
            sphere_record = _bvh_record(bvh, sphere_max_depth)
            sphere_record["spheres"] = {
                "center": centers[order], "radius": radii[order],
                "transparency": transp[order].astype(np.int32),
                "texture_id": tex[order],
            }

        self._bvh_records = (mesh_records, sphere_record)
        return self._finish(mesh_devices, sphere_device, path_map, device,
                            packet_version)

    def device(self, device=None, packet_version: int | None = None) -> LegacyWorldData:
        """The built world's tensors on ``device`` (cached per device), with
        the mesh traversal of ``packet_version`` (default: the one it was
        built or loaded with)."""
        if not self._data:
            raise RuntimeError("call build() or load() first")
        key = str(torch.device(device or "cpu"))
        if key not in self._data:
            self._data[key] = self._data["cpu"].to(device)
        data = self._data[key]
        if packet_version is None or packet_version == data.packet_version:
            return data
        return dataclasses.replace(data, packet_version=packet_version)

    # --------------------------------------------------------------- I/O --
    def save(self, filename):
        if self._bvh_records is None:
            raise RuntimeError("build() before save()")
        mesh_records, sphere_record = self._bvh_records
        serialize.save_world_npy(
            filename,
            meshes_bvhs=mesh_records,
            spheres_bvh=sphere_record,
            environment=self.environment,
            textures=self.textures.dump(),
            environments=self.environments.dump(),
        )

    def load(self, filename, path_map=None, rebuild_bvh: bool = True,
             textures_from_obj: str | None = None, merge_meshes: bool = True,
             sphere_packet: bool | None = None, device=None,
             packet_version: int = 2) -> LegacyWorldData:
        """Load a ``.world.npy`` (either schema era) onto ``device``;
        ``packet_version`` as in ``build``.

        ``rebuild_bvh=True`` (default) rebuilds the BVHs from the stored
        geometry with the build settings (meshes depth 24, leaves of 8,
        merged under one BVH unless ``merge_meshes`` is False; spheres depth
        12, leaves of 4). ``rebuild_bvh=False`` packs the file's own trees
        as stored, one structure per mesh (the reference's depth-16 trees
        have leaves of up to ~60 primitives, which the collapse splits into
        runs of 8).

        ``textures_from_obj``: 14-era files carry no texture configs; the
        reference loads the textures of the companion OBJ's materials into
        fixed 2048-wide atlas slots (14_mesh.py:994-999), which the file's
        face texture ids index. Pass the OBJ path (``path_map`` applies to
        it) to do the same."""
        data = serialize.load_world_npy(filename)
        self.environment = data["environment"]
        if data["textures"] is not None:
            self.textures.load(data["textures"])
        elif textures_from_obj is not None:
            from ..io.obj import load_obj

            obj_path = path_map(textures_from_obj) if path_map else textures_from_obj
            mats = load_obj(obj_path, texture_start_id=0).textures
            self.textures.configs = [
                {"file_path": m["file_path"], "size": (2048, 2048), "id": int(m["id"]),
                 "area": {"low": (i * 2048, 0), "high": ((i + 1) * 2048, 2048)}}
                for i, m in enumerate(mats)]
            self.textures.size = (2048 * max(len(mats), 1), 2048)
        if data["environments"] is not None:
            self.environments.load(data["environments"])

        if rebuild_bvh:
            mesh_devices = _build_mesh_devices(
                [(rec["positions"], rec["normals"], rec["uvs"],
                  rec["faces"]["p"], rec["faces"]["n"], rec["faces"]["t"],
                  rec["faces"]["tex"]) for rec in data["meshes_bvhs"]],
                24, 8, merge=merge_meshes)
        else:
            mesh_devices = tuple(
                _mesh_device(rec["positions"], rec["normals"], rec["uvs"],
                             rec["faces"]["p"], rec["faces"]["n"], rec["faces"]["t"],
                             rec["faces"]["tex"], _bvh_from_record(rec))
                for rec in data["meshes_bvhs"])
        sphere_device = None
        if data["spheres_bvh"] is not None:
            rec = data["spheres_bvh"]
            s = rec["spheres"]
            if rebuild_bvh:
                c = np.asarray(s["center"], np.float32)
                r = np.asarray(s["radius"], np.float32)[:, None]
                sbvh = build_bvh(c - r, c + r, centroid=c, max_depth=12, max_leaf=4)
            else:
                sbvh = _bvh_from_record(rec)
            sphere_device = _sphere_device(
                s["center"], s["radius"], np.asarray(s["transparency"], np.float32),
                s["texture_id"], sbvh, sphere_packet)
        return self._finish(mesh_devices, sphere_device, path_map, device,
                            packet_version)


def _bvh_from_record(rec) -> FlatBVH:
    """A stored tree as a ``FlatBVH`` whose primitives are the record's own,
    already in leaf order."""
    cut = np.asarray(rec["cut"], np.int32)
    nodes = rec["nodes"]
    return FlatBVH(
        left=np.asarray(nodes["left"], np.int32),
        right=np.asarray(nodes["right"], np.int32),
        low=np.asarray(nodes["low"], np.float32),
        high=np.asarray(nodes["high"], np.float32),
        data=np.asarray(nodes["data"], np.int32),
        cut=cut,
        prim=np.arange(int(cut[-1]), dtype=np.int32),
        max_depth=int(rec["max_depth"]),
        max_leaf=int((cut[1:] - cut[:-1]).max(initial=1)),
    )


# --------------------------------------------------------------- tracing --

def _attrs_block(world: LegacyWorldData, point, pidx, src_best, hit_mask):
    """Attribute fetch + material tap for M lanes.

    One attribute-row gather and one atlas tap for the whole batch. Returns
    ``(normal, uv, albedo, roughness, metallic, transparency)``, each
    ``[M, ...]``; miss lanes get the defaults below. The mesh barycentrics
    are the reference's cross-ratio form written component-wise, and divide
    by an unguarded ``d·n`` as the JAX package does: a degenerate triangle
    gives non-finite weights (the packer's clamped coefficients never let
    such a triangle be hit).
    """
    m_lanes = hit_mask.shape[0]
    dev = point.device
    zeros = torch.zeros((m_lanes,), dtype=torch.float32, device=dev)
    normal = torch.stack([zeros, zeros, torch.ones_like(zeros)], -1)
    uv = torch.zeros((m_lanes, 2), dtype=torch.float32, device=dev)
    transparency = zeros

    is_mesh = src_best >= 1
    u_tap = torch.full_like(zeros, 0.5)
    v_tap = torch.full_like(zeros, 0.5)
    tex_tap = torch.zeros((m_lanes,), dtype=torch.int64, device=dev)

    # --- sphere attributes (spheres also carry the normal-map frame) ---
    sp_frame = None
    if world.spheres is not None:
        s = world.spheres
        m = src_best == 0
        sidx = torch.where(m, pidx, 0).to(torch.int64)
        c = s.center[sidx]
        r = s.radius[sidx]
        nv = (point - c) / torch.clamp_min(r, 1e-20)[:, None]
        nx, ny, nz = nv[:, 0], nv[:, 1], nv[:, 2]
        rr = torch.sqrt(torch.clamp_min(nx * nx + nz * nz, 1e-20))
        tang = torch.stack([nz / rr, torch.zeros_like(rr), -nx / rr], -1)
        bitang = torch.stack([nx * ny, -rr, nz * ny], -1)
        phi = torch.asin(torch.clamp(ny, -1.0, 1.0))
        theta = torch.atan2(-nx, -nz)
        su = (theta / torch.pi + 1.0) / 2.0
        sv = phi / torch.pi + 0.5
        sp_frame = (m, nv, tang, bitang)
        uv = torch.where(m[:, None], torch.stack([su, sv], -1), uv)
        u_tap = torch.where(m, 2.0 * su, u_tap)
        v_tap = torch.where(m, sv, v_tap)
        tex_tap = torch.where(m, s.tex[sidx].to(torch.int64), tex_tap)
        transparency = torch.where(m, s.transparency[sidx], transparency)

    # --- mesh attributes: one packed-row gather for all meshes ---
    if world.meshes:
        gidx = pidx.to(torch.int64)
        off = 0
        for k, mesh in enumerate(world.meshes):
            if k:
                gidx = torch.where(src_best == 1 + k, gidx + off, gidx)
            off += mesh.tex.shape[0]
        ct = gather(world.tri_attr, torch.where(is_mesh, gidx, 0)).T   # [32, M]
        p1x, p1y, p1z = ct[0], ct[1], ct[2]
        p2x, p2y, p2z = ct[3], ct[4], ct[5]
        p3x, p3y, p3z = ct[6], ct[7], ct[8]

        def _cross1(ax, ay, az, bx, by, bz):
            return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

        nx, ny, nz = _cross1(p2x - p1x, p2y - p1y, p2z - p1z,
                             p3x - p1x, p3y - p1y, p3z - p1z)
        ninv = 1.0 / torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
        px, py, pz = point[:, 0], point[:, 1], point[:, 2]
        ex, ey, ez = p3x - p2x, p3y - p2y, p3z - p2z
        cx, cy, cz = _cross1(ex, ey, ez, px - p2x, py - p2y, pz - p2z)
        dx, dy, dz = _cross1(ex, ey, ez, p1x - p2x, p1y - p2y, p1z - p2z)
        w1 = (cx * nx + cy * ny + cz * nz) / (dx * nx + dy * ny + dz * nz)
        ex, ey, ez = p1x - p3x, p1y - p3y, p1z - p3z
        cx, cy, cz = _cross1(ex, ey, ez, px - p3x, py - p3y, pz - p3z)
        dx, dy, dz = _cross1(ex, ey, ez, p2x - p3x, p2y - p3y, p2z - p3z)
        w2 = (cx * nx + cy * ny + cz * nz) / (dx * nx + dy * ny + dz * nz)
        w3 = 1.0 - w1 - w2
        smx = w1 * ct[9] + w2 * ct[12] + w3 * ct[15]
        smy = w1 * ct[10] + w2 * ct[13] + w3 * ct[16]
        smz = w1 * ct[11] + w2 * ct[14] + w3 * ct[17]
        sinv = 1.0 / torch.clamp_min(torch.sqrt(smx * smx + smy * smy + smz * smz), 1e-20)
        su = w1 * ct[18] + w2 * ct[20] + w3 * ct[22]
        sv = w1 * ct[19] + w2 * ct[21] + w3 * ct[23]
        m_tex = ct[24].to(torch.int64)
        mm = is_mesh[:, None]
        # triangle normal mapping is computed but disabled in the reference
        # (15_module.py:945): the smooth vertex normal wins
        normal = torch.where(mm, torch.stack([smx * sinv, smy * sinv, smz * sinv], -1),
                             normal)
        uv = torch.where(mm, torch.stack([su, sv], -1), uv)
        u_tap = torch.where(is_mesh, su, u_tap)
        v_tap = torch.where(is_mesh, sv, v_tap)
        tex_tap = torch.where(is_mesh, torch.clamp_min(m_tex, 0), tex_tap)

    # --- the single material tap (strip-packed: one pair-row gather) ---
    tap = sample_bilinear_strips(world.atlas, tex_tap, u_tap, v_tap, channels=8)
    albedo = torch.where(hit_mask[:, None], tap[:, 0:3], 0.0)
    roughness = torch.where(hit_mask, tap[:, 6], 0.0)
    metallic = torch.where(hit_mask, tap[:, 7], 0.0)

    if sp_frame is not None:
        m, nv, tang, bitang = sp_frame
        nc = tap[:, 3:6]
        mapped = nc[:, 0:1] * tang + nc[:, 1:2] * bitang + nc[:, 2:3] * nv
        mapped = mapped / torch.clamp_min(
            torch.sqrt(torch.sum(mapped * mapped, -1, keepdim=True)), 1e-20)
        normal = torch.where(m[:, None], mapped, normal)

    return normal, uv, albedo, roughness, metallic, transparency


@spanned("lpt.legacy.attrs")
def _attrs_rows(world, point, pidx, src_best, hit_mask, rows):
    """``_attrs_block`` on the lanes ``rows`` (an index tensor, or an int
    ``k`` for the prefix ``[0, k)``); every other lane gets the miss
    defaults. Attribute work scales with the hits, not the wavefront."""
    n = hit_mask.shape[0]
    dev = point.device
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    outs = [torch.stack([zeros, zeros, torch.ones_like(zeros)], -1),
            torch.zeros((n, 2), dtype=torch.float32, device=dev),
            torch.zeros((n, 3), dtype=torch.float32, device=dev),
            zeros.clone(), zeros.clone(), zeros.clone()]
    if isinstance(rows, int):
        rows = torch.arange(rows, device=dev)
    if rows.numel():
        sub = _attrs_block(world, point[rows], pidx[rows], src_best[rows],
                           hit_mask[rows])
        for out, val in zip(outs, sub):
            out[rows] = val
    return tuple(outs)


def _assemble_hits(world: LegacyWorldData, rays: Rays, t_best, prim_best,
                   hit_mask, normal, uv, albedo, roughness, metallic,
                   transparency) -> Hits:
    """Shared hit-record tail: legacy constants + back-face handling
    (propagate_once, 15_module.py:985-988): flip normal, invert ior, zero
    absorptivity."""
    t_safe = torch.where(hit_mask, t_best, 0.0)
    point = rays.ro + t_safe[:, None] * rays.rd
    return _assemble_hits_at(rays.rd, point, t_best, prim_best, hit_mask,
                             normal, uv, albedo, roughness, metallic,
                             transparency)


def _assemble_hits_at(rd, point, t_best, prim_best, hit_mask, normal, uv,
                      albedo, roughness, metallic, transparency) -> Hits:
    """``_assemble_hits`` for callers that already hold the hit points."""
    ior = torch.full_like(t_best, LEGACY_IOR)
    absorptivity = torch.full_like(t_best, LEGACY_ABSORPTIVITY)
    backface = (torch.sum(rd * normal, dim=-1) > 0.0) & hit_mask
    normal = torch.where(backface[:, None], -normal, normal)
    ior = torch.where(backface, 1.0 / ior, ior)
    absorptivity = torch.where(backface, 0.0, absorptivity)
    mat = Materials(albedo=albedo, roughness=roughness, metallic=metallic,
                    ior=ior, transparency=transparency,
                    absorptivity=absorptivity)
    return Hits(t=t_best, point=point, normal=normal, uv=uv,
                obj=torch.where(hit_mask, prim_best, -1), hit=hit_mask,
                material=mat)


@spanned("lpt.legacy.trace")
def trace_legacy(world: LegacyWorldData, rays: Rays, eps: float = EPSILON,
                 sort_rays: bool = True):
    """Traversal-only nearest hit across the sphere set and every mesh.

    Returns ``(t_best f32[N] (+inf on miss), prim_best i32[N] (-1 on miss),
    src_best i32[N] (-1 none / 0 spheres / 1+k mesh k))``. No attribute
    gathers or atlas taps happen here; ``shade_from_trace`` adds them.
    Each structure after the first is seeded with the best ``t`` so far.
    Meshes are traversed coherence-sorted under packet versions 1 and 3
    unless ``sort_rays`` is False (scanline-coherent primaries), and in
    lane order under version 2; spheres always in lane order. The result
    does not depend on the order.
    """
    sort = sort_rays and world.packet_version != 2
    n = rays.count
    dev = rays.ro.device
    ro, rd = rays.ro.contiguous(), rays.rd.contiguous()
    t_best = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    src_best = torch.full((n,), -1, dtype=torch.int32, device=dev)

    if world.spheres is not None:
        s = world.spheres
        if s.packet is not None:
            t, p = packet_traverse(*s.packet, ro, rd, t_init=t_best,
                                   active=rays.alive, eps=eps,
                                   leaf_kind="sphere", stack=s.stack)
            t = torch.where(p >= 0, t, _INF)
        else:
            t, p, _ = intersect_spheres_scan(ro, rd, s.scan_table, s.scan_attrs,
                                             t_min=eps)
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        prim_best = torch.where(better, p, prim_best)
        src_best = torch.where(better, 0, src_best)

    for k, mesh in enumerate(world.meshes):
        t, p = packet_traverse(*mesh.packet, ro, rd, t_init=t_best,
                               active=rays.alive, eps=eps, stack=mesh.stack,
                               version=world.packet_version, sort_rays=sort,
                               treelets=mesh.treelets)
        better = (t < t_best) & (p >= 0)
        t_best = torch.where(better, t, t_best)
        prim_best = torch.where(better, p, prim_best)
        src_best = torch.where(better, 1 + k, src_best)
    return t_best, prim_best, src_best


def shade_from_trace(world: LegacyWorldData, rays: Rays, t_best, prim_best,
                     src_best, count: int | None = None) -> Hits:
    """Attribute shading + hit assembly for ``trace_legacy`` results
    (15_module.py:864-953 semantics: triangle normal mapping disabled,
    sphere normal mapping enabled, fixed ior/absorptivity, back-face flip).
    ``count``: callers whose hit lanes are exactly the prefix ``[0,
    count)`` pass it; otherwise the hit lanes are found here."""
    hit_mask = torch.isfinite(t_best)
    t_safe = torch.where(hit_mask, t_best, 0.0)
    point = rays.ro + t_safe[:, None] * rays.rd
    pidx = torch.clamp_min(prim_best, 0)
    rows = count if count is not None else host_read(torch.nonzero, hit_mask).squeeze(1)
    attrs = _attrs_rows(world, point, pidx, src_best, hit_mask, rows)
    return _assemble_hits(world, rays, t_best, prim_best, hit_mask, *attrs)


def _restarts(world: LegacyWorldData, n: int) -> bool:
    """Whether a fused single-mesh traversal of ``n`` rays takes the treelet
    restart: ``LPT_TREELET_RESTART=1`` (read at each call, as the JAX
    package reads it in ``_hit_legacy_fused``) under packet version 2, on a
    single-mesh world without spheres, from 4,096 rays. Unset, nothing
    changes."""
    return (os.environ.get("LPT_TREELET_RESTART", "0") == "1"
            and world.packet_version == 2 and world.spheres is None
            and len(world.meshes) == 1 and n >= 4096)


def hit_legacy(world: LegacyWorldData, rays: Rays, eps: float = EPSILON,
               sort_rays: bool = True) -> Hits:
    """Nearest hit across the sphere set and every mesh, with materials from
    the texture atlas (15_module.py:838-848 + 864-953 semantics): the same
    ``Hits`` as the JAX package's fused single-mesh path. ``sort_rays`` as
    in ``trace_legacy``. Under the treelet restart (``_restarts``, and
    ``sort_rays``) the mesh is walked by ``packet_traverse_sorted(restart=
    True)`` (K2r) and put back in lane order: the same hits."""
    if sort_rays and _restarts(world, rays.count):
        mesh = world.meshes[0]
        t_s, prim_s, _, _, _, order = packet_traverse_sorted(
            *mesh.packet, rays.ro.contiguous(), rays.rd.contiguous(), rays.alive, eps=eps,
            treelets=mesh.treelets, stack=mesh.stack, restart=True)
        t_best, prim_best = torch.empty_like(t_s), torch.empty_like(prim_s)
        t_best[order], prim_best[order] = t_s, prim_s
        src_best = torch.where(prim_best >= 0, 1, -1).to(torch.int32)
    else:
        t_best, prim_best, src_best = trace_legacy(world, rays, eps=eps,
                                                   sort_rays=sort_rays)
    return shade_from_trace(world, rays, t_best, prim_best, src_best)


def trace_shade_compact(world: LegacyWorldData, ro, rd, alive, payload,
                        eps: float = EPSILON):
    """Bounce step for pool integrators whose lane order is free: traverse,
    compact the hits to a prefix, shade exactly the hit rows, and never
    restore lane order.

    Single-mesh worlds under packet versions 1 and 3 from 4,096 rays
    traverse through ``packet_traverse_sorted``, which carries ``payload``
    through its coherence sort, as the JAX package does, and so does version
    2 under the treelet restart (``_restarts``: K2r); other worlds traverse
    through ``trace_legacy``. ``payload``: the caller's per-lane
    ``[N, ...]`` state, carried through the stable hit-compaction sort.
    Returns ``(hits, rd_c, payload_c, nhits)`` in compacted order: rows
    ``[0, nhits)`` are the hits, the rest misses and inactive lanes;
    ``nhits`` is an int (one ``host_read``).
    """
    n = ro.shape[0]
    restart = _restarts(world, n)
    if ((world.packet_version != 2 or restart) and world.spheres is None
            and len(world.meshes) == 1 and n >= 4096):
        mesh = world.meshes[0]
        with span("lpt.legacy.trace"):
            t_s, prim_s, ro, rd, _, _, payload = packet_traverse_sorted(
                *mesh.packet, ro, rd, alive, eps=eps, treelets=mesh.treelets,
                version=world.packet_version, restart=restart, payload=payload,
                stack=mesh.stack)
        src_s = torch.where(prim_s >= 0, 1, -1).to(torch.int32)
    else:
        rays = Rays(ro=ro, rd=rd, throughput=torch.ones_like(ro), alive=alive)
        t_s, prim_s, src_s = trace_legacy(world, rays, eps=eps)
        prim_s = torch.where(alive, prim_s, -1)
    hit_s = prim_s >= 0
    point_s = ro + torch.where(hit_s, t_s, 0.0)[:, None] * rd
    order = torch.argsort((~hit_s).to(torch.int32), stable=True)
    nhits = host_read(int, hit_s.sum())
    t_c, prim_c, src_c = t_s[order], prim_s[order], src_s[order]
    point_c, rd_c = point_s[order], rd[order]
    payload_c = tuple(p[order] for p in payload)
    hit_c = torch.arange(t_c.shape[0], device=t_c.device) < nhits
    attrs = _attrs_rows(world, point_c, torch.clamp_min(prim_c, 0), src_c, hit_c,
                        nhits)
    hits = _assemble_hits_at(rd_c, point_c, torch.where(hit_c, t_c, _INF),
                             prim_c, hit_c, *attrs)
    return hits, rd_c, payload_c, nhits


# f32 (top - bottom) of the baked sky gradient, rounded as the JAX package
# rounds its f32 constants
_GRAD_DELTA = tuple(float(np.float32(t) - np.float32(1.0)) for t in (0.5, 0.7, 1.0))


@spanned("lpt.legacy.env")
def environment_color(envs: StripAtlas, env_id, rd, mask=None,
                      gradient_h: int | None = None):
    """Equirect IBL lookup (15_module.py:970-977) of environment ``env_id``
    in the strip-packed ``envs`` (a world's ``envs`` and ``env_id``).

    ``mask`` (bool[N], optional): lanes whose result is unused; their tap
    coordinates collapse to one texel. ``gradient_h`` (a world's
    ``env_gradient_h``): when the active environment is the baked
    sky-gradient fallback, the tap is evaluated in closed form: the rect is
    constant along u and linear in v, so the bilinear blend reduces to
    ``vv / (h-1)`` inside and ``h - vv`` on the wrap row.
    """
    phi = torch.asin(torch.clamp(rd[:, 1], -1.0, 1.0))
    v = phi / torch.pi + 0.5
    h = gradient_h
    if h is not None:
        vv = v * float(h) - 0.5
        f = torch.where(vv < h - 1, vv / float(max(h - 1, 1)), h - vv)
        return torch.stack([1.0 + dlt * f for dlt in _GRAD_DELTA], dim=-1)
    theta = torch.atan2(-rd[:, 0], -rd[:, 2])
    u = (theta / torch.pi + 1.0) / 2.0
    if mask is not None:
        u = torch.where(mask, u, 0.5)
        v = torch.where(mask, v, 0.5)
    ids = torch.full(u.shape, int(env_id), dtype=torch.int64, device=u.device)
    return sample_bilinear_strips(envs, ids, u, v, channels=3)
