"""Persistent-wavefront integrator with path regeneration.

Counterpart of ``learn_path_tracing_tpu.integrator.persistent`` (its modular
engine). Every lane stays busy:

- the render is a list of ``n*spp`` work items. When ``spp | n`` (the
  "grouped" schedule), lane ``L`` owns sample ``L % spp`` of the pixels
  ``L // spp + k*G`` (``G = pool // spp``) for its item counter
  ``k < items_per``; otherwise item ``w = L + k*pool`` is
  (pixel ``w // spp``, sample ``w % spp``);
- when a lane's path ends (escape or bounce budget), it starts its next
  work item's primary ray in the same pass;
- once the live-lane count falls below the next drain width, a stable
  argsort compacts the live lanes into that width (8x narrower each level),
  so the straggler tail costs a fraction of a full pass.

The pool policy, the item algebra, regeneration and the drain cascade are
the JAX package's, so the pass schedule, ``pool``, the drain widths and the
segment counts are comparable with it. RNG streams are keyed on absolute
(pixel, sample, bounce), so each sample's radiance is that of
``wavefront.render``.

Accumulation differs. The JAX package accumulates through one-hot matrix
products and a sliding window because scatter-adds serialize on a TPU; here
every pass scatter-adds its escaped radiance into one ``[n, 3]`` pixel
accumulator. The accumulator is fixed point (int64, 2**-32 units): integer
addition is associative, so the image does not depend on the order in which
the card's atomics land, and runs are bit-identical. Contributions lie in
[0, 1] (sky radiance times a throughput of at most 1), so a pixel's sum
stays far inside int64 and the rounding (at most 2**-33 per contribution)
is far below float32 resolution.

The loop reads the live-lane count to the host once per pass, to decide
whether to continue or drain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels
from ..core import rng
from ..core.pytree import tree_where
from .wavefront import _scene_fns

# Smallest auto-policy pool, as in the JAX package (its measured knee).
POOL_FLOOR = 57600
# Lanes of the pool are aligned to this block when spp allows (the JAX
# package's kernel block; kept so the schedule stays comparable).
POOL_ALIGN = 1024
# Drain cascade: each level is 8x narrower, down to 256 lanes (the JAX
# package's defaults).
DRAIN_RATIO = 8
DRAIN_FLOOR = 256

_FIXED_ONE = 2.0 ** 32  # fixed-point accumulator units per unit radiance


@dataclass(frozen=True)
class Schedule:
    """Work-item schedule of one persistent render."""

    grouped: bool        # spp | n: lanes own a fixed (group, sample)
    pool: int            # full-width lane count
    items_per: int       # work items per lane (a ceiling)
    drain_widths: tuple  # lane counts of the drain levels, widest first


def schedule(n: int, spp: int) -> Schedule:
    """The JAX package's auto pool policy and drain cascade.

    When ``spp | n``, the pool halves from ``n`` while it stays at or above
    ``POOL_FLOOR``, is rounded up to a multiple of spp and aligned down to
    ``POOL_ALIGN`` lanes where spp allows; otherwise it is ``n``. The drain
    levels narrow the pool by ``DRAIN_RATIO`` per level, in multiples of
    256 lanes, down to ``DRAIN_FLOOR``.
    """
    grouped = n % spp == 0
    pool = n
    if grouped:
        while pool // 2 >= POOL_FLOOR:
            pool //= 2
        pool = -(-pool // spp) * spp
        step = math.lcm(POOL_ALIGN, spp)
        if step <= pool and (pool // step) * step * 2 >= POOL_FLOOR:
            pool = (pool // step) * step
    items_per = -(-(n * spp) // pool) if grouped else spp

    def round256(v):
        return -(-v // 256) * 256

    levels = []
    lw = round256(pool // DRAIN_RATIO)
    while grouped and lw >= DRAIN_FLOOR and lw < (levels[-1] if levels else pool):
        levels.append(lw)
        lw = round256(lw // DRAIN_RATIO)
    return Schedule(grouped, pool, items_per, tuple(levels))


def render_persistent(world_data, cam: CameraParams, resolution, spp: int,
                      limit: int = 32, seed=0, bsdf: str = "modern",
                      camera_model: str = "thinlens", scene: str = "spheres",
                      hit_backend: str = "auto", engine: str = "auto",
                      stats: bool = False):
    """Returns ``(image f32[W,H,3], segments int)``, plus a stats dict when
    ``stats``. The same sample values as ``wavefront.render``.

    ``engine``: 'auto' and 'modular' compose the per-stage ops; 'mega' (the
    fused bounce megakernel) is not ported yet. The JAX package's pool and
    drain overrides (``pool_mult``, ``pool_div``, ``drain_ratio``,
    ``drain_floor``) and its TPU-only accumulation and unroll knobs are not
    carried over: the port uses the auto policy.
    """
    if engine == "mega":
        raise NotImplementedError(
            "engine 'mega' needs the bounce megakernel, not ported yet")
    if engine not in ("auto", "modular"):
        raise ValueError(f"unknown engine: {engine!r}")
    w, h = resolution
    acc, segments, st = _persistent_core(
        world_data, cam, resolution, spp, limit, seed, bsdf, camera_model,
        scene, hit_backend, schedule(w * h, spp))
    img = (acc / spp).reshape(w, h, 3)
    if stats:
        return img, segments, st
    return img, segments


def _persistent_core(world_data, cam: CameraParams, resolution, spp: int,
                     limit: int, seed, bsdf: str, camera_model: str,
                     scene: str, hit_backend: str, sched: Schedule):
    """Persistent render of every pixel and sample of ``resolution``.
    Returns ``(acc f32[n, 3] radiance sums, segments int, stats dict)``."""
    w, h = resolution
    n = w * h
    dev = cam.device
    scatter = SCATTERERS[bsdf]
    hit_fn, background_fn = _scene_fns(scene)
    grouped, pool, items_per = sched.grouped, sched.pool, sched.items_per
    total = n * spp
    groups = pool // spp if grouped else 0
    lanes = torch.arange(pool, dtype=torch.int64, device=dev)

    def item_of(k, group=lanes // spp, sample=lanes % spp):
        """k-th work item of each lane → (valid, pixel [P], sample [P]).
        ``group``/``sample`` are the lanes' constants (compacted in drains)."""
        if grouped:
            pixel = group + k * groups
            valid = (k < items_per) & (pixel < n)
            return valid, torch.clamp_max(pixel, n - 1), sample
        witem = lanes + k * pool
        valid = witem < total
        return valid, torch.clamp_max(witem // spp, n - 1), witem % spp

    def primary(pixel, sample):
        return generate_rays_for_pixels(cam, resolution, pixel, seed, sample,
                                        model=camera_model)

    def step(rays, k, bounce, item_fn):
        """One bounce pass; shared by the full-width and drain loops.
        Returns (rays', k', bounce', pixel, contrib)."""
        _, pixel, sample = item_fn(k)
        hits = hit_fn(world_data, rays, hit_backend)
        escaped = rays.alive & ~hits.hit
        contrib = torch.where(
            escaped[:, None],
            background_fn(world_data, rays.rd, escaped) * rays.throughput, 0.0)

        base = rng.base(rng.stream(seed, sample, bounce, rng.STREAM_BSDF), pixel)
        scattered = scatter(rays, hits, base)
        survived = rays.alive & hits.hit & (bounce + 1 < limit)

        # lanes whose path ended advance to their next work item
        ended = rays.alive & ~survived
        next_k = k + ended.to(torch.int64)
        nvalid, npix, nsamp = item_fn(next_k)
        need_regen = ended & nvalid
        fresh = primary(npix, nsamp)

        rays = tree_where(survived, scattered, tree_where(need_regen, fresh, rays))
        rays = rays.with_alive(survived | need_regen)
        bounce = torch.where(survived, bounce + 1, torch.zeros_like(bounce))
        return rays, next_k, bounce, pixel, contrib

    acc = torch.zeros((n, 3), dtype=torch.int64, device=dev)

    def run(rays, k, bounce, item_fn, live, stop_at):
        """Bounce passes while more than ``stop_at`` lanes are live."""
        segments = passes = 0
        while live > stop_at:
            rays, k, bounce, pixel, contrib = step(rays, k, bounce, item_fn)
            acc.index_add_(0, pixel, torch.round(contrib * _FIXED_ONE).to(torch.int64))
            segments += live
            passes += 1
            live = int(rays.alive.sum())
        return rays, k, bounce, live, segments, passes

    k = torch.zeros((pool,), dtype=torch.int64, device=dev)
    bounce = torch.zeros((pool,), dtype=torch.int64, device=dev)
    valid0, pix0, samp0 = item_of(k)
    rays = primary(pix0, samp0).with_alive(valid0)
    live = int(valid0.sum())

    levels = sched.drain_widths
    rays, k, bounce, live, segments, passes_full = run(
        rays, k, bounce, item_of, live, levels[0] if levels else 0)

    group, sample = lanes // spp, lanes % spp
    drain_passes = []
    for li, lw in enumerate(levels):
        order = torch.argsort((~rays.alive).to(torch.int32), stable=True)
        sel = order[:lw]
        group, sample = group[sel], sample[sel]
        rays, k, bounce = rays.take(sel), k[sel], bounce[sel]

        def item_of_d(kv, group=group, sample=sample):
            return item_of(kv, group, sample)

        next_w = levels[li + 1] if li + 1 < len(levels) else 0
        rays, k, bounce, live, segs, lvl_passes = run(
            rays, k, bounce, item_of_d, live, next_w)
        segments += segs
        drain_passes.append(lvl_passes)

    acc_f32 = (acc.to(torch.float64) / _FIXED_ONE).to(torch.float32)
    return acc_f32, segments, {
        "pool": pool,
        "passes_full": passes_full,
        "drain_widths": levels,
        "drain_passes": tuple(drain_passes),
    }
