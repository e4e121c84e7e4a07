"""Persistent-wavefront integrator with path regeneration.

Counterpart of ``learn_path_tracing_tpu.integrator.persistent``, with its
modular and mega engines. Every lane stays busy:

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

The mega engine (``engine='mega'``) keeps the JAX package's schedule for
it: the grouped schedule with a pool of ``n`` lanes, no halving and no
drain. On a card each pass is one fused kernel launch
(``ops.bounce_megakernel``, K4) that also deposits into the same fixed-point
accumulator, so its image is order-free too. The passes run over a shrinking
list of lanes (``LaneList``): the lanes alive, and once more those that just
died, updated in place; the state stays the all-lanes pass's. The kernel's
plain version, ``bounce_pass_plain``, is this module's ``step`` on the
kernel's state layout, so the two engines share one step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..bsdf.bsdf import SCATTERERS, scatter_modern
from ..camera.camera import CameraParams, generate_rays_for_pixels, thin_lens_rays
from ..core import rng
from ..core.pytree import tree_where
from ..core.types import Rays
from ..ops import bounce_megakernel as mk
from ..ops.sphere_scan import intersect_spheres_scan_plain
from ..scene import world as world_mod
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

_FIXED_ONE = mk.FIXED_ONE  # fixed-point accumulator units per unit radiance


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
        align = math.lcm(POOL_ALIGN, spp)
        if align <= pool and (pool // align) * align * 2 >= POOL_FLOOR:
            pool = (pool // align) * align
    items_per = -(-(n * spp) // pool) if grouped else spp

    def round256(v):
        return -(-v // 256) * 256

    levels = []
    lw = round256(pool // DRAIN_RATIO)
    while grouped and lw >= DRAIN_FLOOR and lw < (levels[-1] if levels else pool):
        levels.append(lw)
        lw = round256(lw // DRAIN_RATIO)
    return Schedule(grouped, pool, items_per, tuple(levels))


def mega_schedule(n: int, spp: int) -> Schedule:
    """The mega engine's schedule: grouped, a pool of all ``n`` lanes, no
    drain (``spp | n``)."""
    return Schedule(True, n, spp, ())


def item_fn(sched: Schedule, n: int, spp: int, device):
    """``item_of(k, group, sample)``: the ``k``-th work item of each lane →
    ``(valid, pixel, sample)``, each ``[P]``. ``group``/``sample`` default to
    the pool's lane constants (a drain passes its compacted ones)."""
    grouped, pool, items_per = sched.grouped, sched.pool, sched.items_per
    groups = pool // spp if grouped else 0
    lanes = torch.arange(pool, dtype=torch.int64, device=device)

    def item_of(k, group=lanes // spp, sample=lanes % spp):
        if grouped:
            pixel = group + k * groups
            valid = (k < items_per) & (pixel < n)
            return valid, torch.clamp_max(pixel, n - 1), sample
        witem = lanes + k * pool
        valid = witem < n * spp
        return valid, torch.clamp_max(witem // spp, n - 1), witem % spp

    return item_of


def step(world_data, rays, k, bounce, item_of, *, hit, background, scatter, primary,
         seed, limit: int, pixel_base: int = 0, sample_base: int = 0):
    """One bounce pass of a lane wavefront, the one step of both engines.

    ``hit(world_data, rays) -> Hits``, ``background(world_data, rd, escaped)
    -> f32[N,3]``, ``scatter(rays, hits, base) -> Rays`` and
    ``primary(pixel, sample) -> Rays`` are the scene's, the BSDF's and the
    camera's; ``item_of`` is ``item_fn``'s. Lanes whose path ends (escape or
    bounce budget) advance to their next work item and start its primary
    ray. Returns ``(rays', k', bounce', pixel, contrib, hits)``: ``contrib``
    is the escaped radiance, due at ``pixel``, the item before the advance.

    ``item_of``'s pixels and samples are local to a range that starts at
    ``pixel_base`` and ``sample_base``; the BSDF stream keys on the
    absolute ids (``primary`` takes the local ones and offsets them too).
    """
    _, pixel, sample = item_of(k)
    hits = hit(world_data, rays)
    escaped = rays.alive & ~hits.hit
    contrib = torch.where(
        escaped[:, None], background(world_data, rays.rd, escaped) * rays.throughput, 0.0)

    base = rng.base(rng.stream(seed, sample + sample_base, bounce, rng.STREAM_BSDF),
                    pixel + pixel_base)
    scattered = scatter(rays, hits, base)
    survived = rays.alive & hits.hit & (bounce + 1 < limit)

    # lanes whose path ended advance to their next work item
    ended = rays.alive & ~survived
    next_k = k + ended.to(torch.int64)
    nvalid, npix, nsamp = item_of(next_k)
    need_regen = ended & nvalid
    fresh = primary(npix, nsamp)

    nxt = tree_where(survived, scattered, tree_where(need_regen, fresh, rays))
    nxt = nxt.with_alive(survived | need_regen)
    bounce = torch.where(survived, bounce + 1, torch.zeros_like(bounce))
    return nxt, next_k, bounce, pixel, contrib, hits


def render_persistent(world_data, cam: CameraParams, resolution, spp: int,
                      limit: int = 32, seed=0, bsdf: str = "modern",
                      camera_model: str = "thinlens", scene: str = "spheres",
                      hit_backend: str = "auto", engine: str = "auto",
                      stats: bool = False):
    """Returns ``(image f32[W,H,3], segments int)``, plus a stats dict when
    ``stats``. The same sample values as ``wavefront.render``.

    ``engine``: 'auto' and 'modular' compose the per-stage ops; 'mega' runs
    each pass as one fused bounce kernel (``ops.bounce_megakernel``, K4) over
    a full-width pool of ``W·H`` lanes. The mega engine takes only the
    sphere scene with the modern BSDF and the thin-lens camera, and needs
    ``spp | W·H``; it raises ``ValueError`` on any other argument, where the
    JAX package drops the arguments silently. Its samples are the modular
    engine's, so on the CPU the two images agree. The JAX package's pool
    and drain overrides (``pool_mult``, ``pool_div``, ``drain_ratio``,
    ``drain_floor``) and its TPU-only accumulation and unroll knobs are not
    carried over: the port uses the auto policy.
    """
    w, h = resolution
    if engine == "mega":
        _check_mega(w * h, spp, bsdf, camera_model, scene, hit_backend)
        acc, segments, st = _render_mega(world_data, cam, resolution, spp, limit, seed)
    elif engine in ("auto", "modular"):
        acc, segments, st = _persistent_core(
            world_data, cam, resolution, w * h, 0, 0, spp, limit, seed, bsdf,
            camera_model, scene, hit_backend)
    else:
        raise ValueError(f"unknown engine: {engine!r}")
    img = (radiance(acc) / spp).reshape(w, h, 3)
    if stats:
        return img, segments, st
    return img, segments


def radiance(acc):
    """Radiance sums f32 from a fixed-point accumulator (int64, 2**-32 units),
    as every engine rounds them."""
    return (acc.to(torch.float64) / _FIXED_ONE).to(torch.float32)


def _persistent_core(world_data, cam: CameraParams, resolution, n: int,
                     pixel_base: int, sample_base: int, spp: int, limit: int,
                     seed, bsdf: str, camera_model: str, scene: str,
                     hit_backend: str):
    """Persistent render over a pixel range and a sample range: samples
    ``[sample_base, sample_base + spp)`` of pixels ``[pixel_base,
    pixel_base + n)`` of the ``resolution`` image. The schedule, the drain
    cascade and the accumulator are local to the range (``schedule(n,
    spp)``; ``acc`` row ``i`` is pixel ``pixel_base + i``), and the camera
    and the RNG key on absolute ids, so a range's samples are those of the
    whole render: ``parallel.mesh`` runs one range a rank. Returns ``(acc
    int64[n, 3] fixed-point radiance sums, segments int, stats dict)``."""
    sched = schedule(n, spp)
    dev = cam.device
    hit_fn, background_fn = _scene_fns(scene)
    item_of = item_fn(sched, n, spp, dev)
    lanes = torch.arange(sched.pool, dtype=torch.int64, device=dev)

    def primary(pixel, sample):
        return generate_rays_for_pixels(cam, resolution, pixel + pixel_base, seed,
                                        sample + sample_base, model=camera_model)

    def hit(wd, rays):
        return hit_fn(wd, rays, hit_backend)

    fns = dict(hit=hit, background=background_fn, scatter=SCATTERERS[bsdf],
               primary=primary, seed=seed, limit=limit, pixel_base=pixel_base,
               sample_base=sample_base)

    acc = torch.zeros((n, 3), dtype=torch.int64, device=dev)

    def run(rays, k, bounce, items, live, stop_at):
        """Bounce passes while more than ``stop_at`` lanes are live."""
        segments = passes = 0
        while live > stop_at:
            rays, k, bounce, pixel, contrib, _ = step(world_data, rays, k, bounce, items,
                                                      **fns)
            acc.index_add_(0, pixel, torch.round(contrib * _FIXED_ONE).to(torch.int64))
            segments += live
            passes += 1
            live = int(rays.alive.sum())
        return rays, k, bounce, live, segments, passes

    k = torch.zeros((sched.pool,), dtype=torch.int64, device=dev)
    bounce = torch.zeros((sched.pool,), dtype=torch.int64, device=dev)
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

    return acc, segments, {
        "pool": sched.pool,
        "passes_full": passes_full,
        "drain_widths": levels,
        "drain_passes": tuple(drain_passes),
    }


def _check_mega(n: int, spp: int, bsdf: str, camera_model: str, scene: str,
                hit_backend: str):
    """The arguments the mega engine takes, each named where it is not."""
    for name, value, want in (("bsdf", bsdf, "modern"),
                              ("camera_model", camera_model, "thinlens"),
                              ("scene", scene, "spheres"),
                              ("hit_backend", hit_backend, "auto")):
        if value != want:
            raise ValueError(f"engine 'mega' takes only {name}={want!r}, got {value!r}")
    if spp < 1 or n % spp:
        raise ValueError(f"engine 'mega' needs spp | W*H: spp={spp}, W*H={n}")


def _render_mega(world_data, cam: CameraParams, resolution, spp: int, limit: int, seed):
    """The mega engine: ``mega_schedule``'s ``W·H`` lanes, lane ``L`` owning
    sample ``L % spp`` of the pixels ``L // spp + k·(W·H/spp)``. While a lane
    lives, one ``mega_pass`` over the list of lanes that can still change
    (``ops.bounce_megakernel.LaneList``) advances them in place and deposits
    their escaped radiance into the fixed-point accumulator. Returns
    ``(acc int64[n,3], segments int, {"passes": int, "listed": [int]})``, where
    ``listed`` holds the lanes each pass visited."""
    w, h = resolution
    n = w * h
    stf, sti = mk.initial_state(cam, resolution, spp, seed)
    scalf = mk.pack_camera(cam, resolution)
    acc = torch.zeros((n, 3), dtype=torch.int64, device=cam.device)
    lanes = mk.LaneList.of_state(stf, sti)
    live, segments, listed = lanes.alive, 0, []
    while live > 0:
        segments += live
        listed.append(lanes.count)
        mega_pass(stf, sti, world_data, scalf, seed, resolution, spp, lanes, limit=limit,
                  acc=acc)
        live = lanes.advance()
    return acc, segments, {"passes": len(listed), "listed": listed}


def mega_pass(stf, sti, world_data, scalf, seed, resolution, spp: int, lanes,
              limit: int = 32, t_min: float = mk.T_MIN, acc=None):
    """One pass of the mega engine over the lanes of ``lanes`` (an
    ``ops.bounce_megakernel.LaneList``), on that module's state layout:
    kernel K4 (``ops.bounce_megakernel.bounce_pass``) for CUDA tensors, its
    plain version ``bounce_pass_plain`` for CPU tensors, and ``ValueError``
    for any other device. The listed lanes are updated in place and the
    next list and its counts are written into ``lanes``."""
    if stf.device.type == "cpu":
        mk.check_operands(stf, sti, world_data, scalf, resolution, spp, acc, lanes)
        bounce_pass_plain(stf, sti, world_data, scalf, seed, resolution, spp, limit, t_min,
                          acc, lanes)
    else:
        mk.bounce_pass(stf, sti, world_data, scalf, seed, resolution, spp, lanes, limit,
                       t_min, acc)


def bounce_pass_plain(stf, sti, world_data, scalf, seed, resolution, spp: int,
                      limit: int = 32, t_min: float = mk.T_MIN, acc=None, lanes=None):
    """Kernel K4's plain version, on any device: ``step`` on the kernel's
    state layout and ``mega_schedule``, with the plain sphere scan, the sky,
    ``scatter_modern`` and thin-lens primaries from ``scalf``. So on the CPU
    it gives the modular engine's samples exactly. With ``lanes`` it is
    ``ops.bounce_megakernel.bounce_pass``: it steps the listed lanes only,
    in place, and writes the next list in the kernel's order by kind (lanes
    alive after the pass, then those that died in it; each in lane order
    here). Without it, the reference form: every lane, into new tensors,
    returned as ``(stf', sti', live i32[1])``."""
    w, h = resolution
    n = w * h
    if lanes is None:
        lane = torch.arange(n, dtype=torch.int64, device=stf.device)
        stf_in, sti_in = stf, sti
    else:
        lane = lanes.lanes[:lanes.count].to(torch.int64)
        stf_in, sti_in = stf[:, lane], sti[:, lane]
    alive = stf_in[mk.ALIVE] > 0.5
    rays = Rays(ro=stf_in[mk.RO:mk.RO + 3].T.contiguous(),
                rd=stf_in[mk.RD:mk.RD + 3].T.contiguous(),
                throughput=stf_in[mk.THP:mk.THP + 3].T.contiguous(), alive=alive)
    frame = mk.unpack_camera(scalf)
    item_of = item_fn(mega_schedule(n, spp), n, spp, stf.device)

    def items(k):
        return item_of(k, lane // spp, lane % spp)

    def hit(wd, r):
        scan = intersect_spheres_scan_plain(r.ro, r.rd, wd.scan_table, wd.scan_attrs,
                                            t_min=t_min)
        return world_mod.hit_record(r, *scan)

    def primary(pixel, sample):
        ro, rd = thin_lens_rays(frame, resolution, pixel, seed, sample)
        return Rays(ro=ro, rd=rd, throughput=torch.ones_like(ro), alive=alive)

    nxt, k, bounce, pixel, contrib, hits = step(
        world_data, rays, sti_in[mk.K].to(torch.int64), sti_in[mk.BOUNCE].to(torch.int64),
        items, hit=hit, background=_scene_fns("spheres")[1], scatter=scatter_modern,
        primary=primary, seed=seed, limit=limit)

    stf_out = torch.zeros_like(stf_in)
    stf_out[mk.RO:mk.RO + 3] = nxt.ro.T
    stf_out[mk.RD:mk.RD + 3] = nxt.rd.T
    stf_out[mk.THP:mk.THP + 3] = nxt.throughput.T
    stf_out[mk.ALIVE] = nxt.alive.to(torch.float32)
    stf_out[mk.CONTRIB:mk.CONTRIB + 3] = contrib.T
    sti_out = torch.zeros_like(sti_in)
    sti_out[mk.K] = k.to(torch.int32)
    sti_out[mk.BOUNCE] = bounce.to(torch.int32)
    sti_out[mk.OBJ] = torch.where(alive, hits.obj, -1).to(torch.int32)
    if acc is not None:
        acc.index_add_(0, pixel, torch.round(contrib * _FIXED_ONE).to(torch.int64))
    live = nxt.alive.sum().to(torch.int32).reshape(1)
    if lanes is None:
        return stf_out, sti_out, live
    stf[:, lane] = stf_out
    sti[:, lane] = sti_out
    died = alive & ~nxt.alive
    order = torch.cat([lane[nxt.alive], lane[died]]).to(torch.int32)
    lanes.next[:order.numel()] = order
    lanes.counters[0] = live[0]
    lanes.counters[1] = died.sum()
