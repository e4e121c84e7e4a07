"""Multi-device rendering on ``torch.distributed``.

Counterpart of ``learn_path_tracing_tpu.parallel.mesh``. The render's two
parallel axes are those of the JAX package:

- ``tile``: each rank owns a contiguous chunk of the flat pixel axis; no
  traffic between ranks while tracing;
- ``spp``: each rank renders a subset of the samples of every pixel; the
  ranks of a tile sum their accumulators at the end.

The model is SPMD, as with ``shard_map``: every rank of the initialised
process group calls the same function with the same arguments, reads its
own ``(tile, spp)`` coordinate from the mesh, renders its range, and takes
part in the collectives; every rank returns the whole image. The collectives
are an ``all_reduce`` of the accumulator over ``spp``, an
``all_gather_into_tensor`` of the tiles over ``tile``, and an ``all_reduce``
of the segment count (int64) over all ranks.

The RNG is keyed on the absolute (pixel, sample), so every rank traces the
samples of the single-device render. The persistent and hybrid engines
accumulate in int64 fixed point, whose sums do not depend on their order:
their tile and sample splits give the single-device image bit for bit. The
wavefront render sums float32 radiance, so its tile split is bit for bit
and its sample split equal up to the order of the float sum.

Process groups: ``parallel.launch`` starts the ranks (NCCL on the card,
one rank a card; gloo on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..camera.camera import CameraParams
from ..integrator.hybrid import _hybrid_core
from ..integrator.persistent import _persistent_core, radiance
from ..integrator.wavefront import trace_sample_pixels


@dataclass(frozen=True)
class Mesh:
    """A ``('tile', 'spp')`` mesh over the process group. Rank ``r`` sits at
    ``tile = r // n_spp``, ``spp = r % n_spp`` (row-major, as the JAX
    package's ``reshape(n_tile, n_spp)`` of its devices). ``tile_group``
    holds the ranks of this rank's spp index, one a tile, in tile order (the
    tile gather); ``spp_group`` the ranks of its tile (the sample sum)."""

    n_tile: int
    n_spp: int
    tile: int
    spp: int
    tile_group: object
    spp_group: object

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "spp": self.n_spp}


def make_mesh(n_tile: int | None = None, n_spp: int = 1) -> Mesh:
    """Build a ``('tile', 'spp')`` mesh over the initialised process group;
    ``n_tile`` defaults to all ranks over ``n_spp``. Every rank must call it
    (it creates the sub-groups). Raises ``ValueError`` unless ``n_tile ·
    n_spp`` is the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch starts one)")
    world = dist.get_world_size()
    if n_tile is None:
        n_tile = world // n_spp
    if n_tile < 1 or n_spp < 1 or n_tile * n_spp != world:
        raise ValueError(f"mesh {n_tile}x{n_spp} != {world} ranks")
    rank = dist.get_rank()
    tile, spp = divmod(rank, n_spp)
    spp_group = tile_group = None
    for t in range(n_tile):
        group = dist.new_group([t * n_spp + s for s in range(n_spp)])
        if t == tile:
            spp_group = group
    for s in range(n_spp):
        group = dist.new_group([t * n_spp + s for t in range(n_tile)])
        if s == spp:
            tile_group = group
    return Mesh(n_tile, n_spp, tile, spp, tile_group, spp_group)


def combine(acc, segments: int, mesh: Mesh):
    """The collectives of a sharded render: the local accumulator summed over
    the ``spp`` axis, the tiles gathered in tile order, the segment count
    summed over every rank. Returns ``(acc [n_tile · rows, ...], segments
    int)``."""
    acc = acc.contiguous()
    if mesh.n_spp > 1:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.spp_group)
    full = torch.empty((mesh.n_tile * acc.shape[0], *acc.shape[1:]), dtype=acc.dtype,
                       device=acc.device)
    dist.all_gather_into_tensor(full, acc, group=mesh.tile_group)
    segs = torch.tensor([segments], dtype=torch.int64, device=acc.device)
    dist.all_reduce(segs, op=dist.ReduceOp.SUM)
    return full, int(segs.item())


def _split(n: int, spp: int, mesh: Mesh, engine: str, exact_tiles: bool):
    """``(n_local, spp_local)`` of each rank; raises ``ValueError`` where
    the split is not whole."""
    if spp % mesh.n_spp:
        raise ValueError(f"spp={spp} not divisible by spp axis {mesh.n_spp}")
    if exact_tiles and n % mesh.n_tile:
        raise ValueError(f"{engine} sharding needs tile axis {mesh.n_tile} to divide "
                         f"n={n} pixels (pad the resolution)")
    return -(-n // mesh.n_tile), spp // mesh.n_spp


def render_sharded(world_data, cam: CameraParams, resolution, spp: int, mesh: Mesh,
                   limit: int = 32, seed=0, bsdf: str = "modern",
                   camera_model: str = "thinlens", scene: str = "spheres",
                   hit_backend: str = "auto"):
    """The wavefront render (``integrator.wavefront.render``) across the
    mesh; returns ``(image f32[W,H,3], segments int)`` on every rank.

    ``spp`` must divide by the spp axis; the pixel axis is padded to a tile
    multiple with ids clamped to the last pixel (the padding traces real
    rays, counted in ``segments`` as the JAX package counts them, and its
    radiance is dropped)."""
    w, h = resolution
    n = w * h
    n_local, spp_local = _split(n, spp, mesh, "wavefront", exact_tiles=False)
    start = mesh.tile * n_local
    pix = torch.clamp_max(torch.arange(start, start + n_local, dtype=torch.int64,
                                       device=cam.device), n - 1)
    acc = torch.zeros((n_local, 3), dtype=torch.float32, device=cam.device)
    segments = 0
    for k in range(spp_local):
        rad, segs = trace_sample_pixels(world_data, cam, resolution, pix, seed,
                                        mesh.spp * spp_local + k, limit, bsdf=bsdf,
                                        camera_model=camera_model, scene=scene,
                                        hit_backend=hit_backend)
        acc = acc + rad
        segments += segs
    acc, segments = combine(acc, segments, mesh)
    return (acc[:n] / spp).reshape(w, h, 3), segments


# the entry point of the sharded wavefront render (the JAX package's jitted
# wrapper of ``render_sharded``)
render_multichip = render_sharded


def render_persistent_multichip(world_data, cam: CameraParams, resolution, spp: int,
                                mesh: Mesh, limit: int = 32, seed=0,
                                bsdf: str = "modern", camera_model: str = "thinlens",
                                scene: str = "spheres", hit_backend: str = "auto"):
    """The persistent engine (``integrator.persistent``, modular) across the
    mesh: each rank runs ``_persistent_core`` over its pixel range (tile
    axis) and sample range (spp axis), with a range-local schedule and drain
    cascade, then ``combine``. Returns ``(image f32[W,H,3], segments int)``
    on every rank: the single-device ``render_persistent`` image bit for bit
    and its segment count. Raises ``ValueError`` unless the tile axis
    divides ``W·H`` and the spp axis ``spp``. The JAX package's pool and
    drain overrides (``pool_mult``, ``pool_div``, ``drain_ratio``) are not
    carried over, as in ``render_persistent``."""
    w, h = resolution
    n_local, spp_local = _split(w * h, spp, mesh, "persistent", exact_tiles=True)
    acc, segments, _ = _persistent_core(
        world_data, cam, resolution, n_local, mesh.tile * n_local, mesh.spp * spp_local,
        spp_local, limit, seed, bsdf, camera_model, scene, hit_backend)
    acc, segments = combine(acc, segments, mesh)
    return (radiance(acc) / spp).reshape(w, h, 3), segments


def render_hybrid_multichip(world_data, cam: CameraParams, resolution, spp: int,
                            mesh: Mesh, limit: int = 32, seed=0, bsdf: str = "legacy",
                            camera_model: str = "jitter", scene: str = "legacy",
                            hit_backend: str = "auto", chunk_spp: int = 0, cap: int = 0,
                            pool_w: int = 0, drain_ratio: int = 2):
    """The hybrid engine (``integrator.hybrid``) across the mesh: each rank
    runs ``_hybrid_core`` over its pixel and sample ranges (its own slabs,
    pool, merges and deposits; the auto ``chunk_spp``, ``cap`` and
    ``pool_w`` sized from its range), then ``combine``. Returns ``(image
    f32[W,H,3], segments int)`` on every rank: the single-device
    ``render_hybrid`` image bit for bit and its segment count. Raises
    ``ValueError`` unless the tile axis divides ``W·H`` and the spp axis
    ``spp``, for a scene other than 'legacy', and for any ``hit_backend``
    but 'auto' (``render_hybrid`` takes none)."""
    if scene != "legacy":
        raise ValueError("render_hybrid_multichip targets legacy mesh scenes; use "
                         "render_persistent_multichip for sphere scenes")
    if hit_backend != "auto":
        raise ValueError(f"render_hybrid_multichip takes only hit_backend='auto' "
                         f"(render_hybrid has none), got {hit_backend!r}")
    w, h = resolution
    n_local, spp_local = _split(w * h, spp, mesh, "hybrid", exact_tiles=True)
    acc, segments, _ = _hybrid_core(
        world_data, cam, resolution, n_local, mesh.tile * n_local, mesh.spp * spp_local,
        spp_local, limit, seed, bsdf, camera_model, chunk_spp, cap, pool_w, drain_ratio)
    acc, segments = combine(acc, segments, mesh)
    return (radiance(acc) / spp).reshape(w, h, 3), segments
