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

The item algebra, regeneration and the drain cascade are the JAX
package's. So is the pool policy off the card (``schedule``), so there the
pass schedule, ``pool``, the drain widths and the segment counts are
comparable with it. On a CUDA device the auto pool follows the card's rule
(``card_schedule``): a pass there costs its ~600 eager launches more than its
width, so the pool is the widest that a lane budget allows, and a frame
takes far fewer passes. The pool only changes which lane traces which
sample: every rule gives the same image and segments. RNG streams are keyed
on absolute (pixel, sample, bounce), so each sample's radiance is that of
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
whether to continue or drain; in the drain levels ``drain_unroll`` passes
share one read. The JAX package's pool and drain knobs (``pool_mult``,
``pool_div``, ``drain_ratio``, ``drain_floor``, ``drain_unroll``) set the
schedule as there; none changes the image.

A sphere world's modular render on the card runs as CUDA graphs
(``ModularGraphs``): the start and one bounce pass at each pool width, each
captured once and replayed, with the same schedule, reads and bits as the
eager loop (``_EagerLanes``), which the CPU and the legacy world run.

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

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from ..bsdf.bsdf import SCATTERERS, scatter_modern
from ..camera.camera import CameraParams, generate_rays_for_pixels, thin_lens_rays
from ..core import rng
from ..core.pytree import tree_where
from ..core.types import Rays
from ..ops import bounce_megakernel as mk
from ..ops import kernel_counters
from ..ops.packet_traverse import check_flags
from ..ops.sphere_scan import intersect_spheres_scan_plain
from ..scene import world as world_mod
from ..utils.profiling import host_read, recording, span
from . import graphs
from .wavefront import _scene_fns

# Smallest pool of the JAX rule, as in the JAX package: the TPU's knee, the
# width at which a TPU pass begins to cost more as it widens.
POOL_FLOOR = 57600
# Widest pool of the card's rule (CUDA devices), in lanes. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W (the cover scene at 1280x720, depth 32, the
# frame rendered in turns at each pool in one process): a full pass's host
# issue takes ~9 ms at any width, its device time 1.5 ms at 57,344 lanes,
# 3.9 at 921,600, 7.0 at 1,843,200, 15.0 at 3,686,400 and 30.3 at 7,372,800,
# so passes turn device-bound at ~2M lanes. At 8 spp the frame still
# shortens up to 7,372,800 lanes (one work item a lane: 32 passes in
# 0.35-0.37 s, against 64 passes in 0.58-0.59 s at 3,686,400 and 461 passes
# in 3.9 s under the JAX rule); at 64 spp it is flat from 3,686,400 to
# 29,491,200 lanes (1.55-1.70 s). Past 2**23 lanes nothing measured gained;
# the peak of allocated memory is ~0.56 KiB a lane (4.1 GiB at 7,372,800).
CARD_POOL_LANES = 8 * 1024 * 1024
# Lanes of the pool are aligned to this block when spp allows (the JAX
# package's kernel block; kept so the schedule stays comparable).
POOL_ALIGN = 1024
# Drain cascade: each level is 8x narrower, down to 256 lanes (the JAX
# package's defaults).
DRAIN_RATIO = 8
DRAIN_FLOOR = 256

_FIXED_ONE = mk.FIXED_ONE  # fixed-point accumulator units per unit radiance
PASS_SPAN = "lpt.persistent.pass"


@dataclass(frozen=True)
class Schedule:
    """Work-item schedule of one persistent render."""

    grouped: bool        # spp | n: lanes own a fixed (group, sample)
    pool: int            # full-width lane count
    items_per: int       # work items per lane (a ceiling)
    drain_widths: tuple  # lane counts of the drain levels, widest first


def schedule(n: int, spp: int, pool_mult: int = 0, pool_div: int = 0,
             drain_ratio: int = DRAIN_RATIO, drain_floor: int = 0,
             scene: str = "spheres") -> Schedule:
    """The JAX package's pool policy and drain cascade (the JAX rule, the
    auto pool off the card), with its overrides and their errors.

    Auto (no override): when ``spp | n``, the pool halves from ``n`` while
    it stays at or above ``POOL_FLOOR`` (the TPU's knee), is rounded up to a
    multiple of spp and aligned down to ``POOL_ALIGN`` lanes where spp
    allows; otherwise it is ``n``. For ``scene='legacy'`` the auto pool is ``n`` (mesh passes
    carry more fixed cost, so the JAX package keeps them few and wide). ``pool_mult = q`` (a divisor of spp) makes it ``q·n`` lanes,
    each running ``spp / q`` items; ``pool_div = d`` makes it ``n // d``
    rounded up to a multiple of spp (at least spp), each lane running about
    ``d·spp`` items. Both need ``spp | n`` and exclude each other. The drain
    levels narrow the pool by ``drain_ratio`` per level, in multiples of 256
    lanes, down to ``drain_floor`` (0: ``DRAIN_FLOOR``).
    """
    if pool_mult and pool_div:
        raise ValueError("pool_mult and pool_div are mutually exclusive")
    grouped = n % spp == 0
    pool = n
    if not grouped:
        if pool_mult or pool_div:
            raise ValueError(f"pool_mult/pool_div need spp | n (n={n}, spp={spp})")
    elif pool_mult:
        if spp % pool_mult:
            # a non-divisor would drop the last spp % q samples of a pixel
            raise ValueError(f"pool_mult={pool_mult} must divide spp={spp} "
                             f"(each lane runs spp/pool_mult work items)")
        pool = pool_mult * n
    elif pool_div:
        pool = -(-(n // pool_div) // spp) * spp
        if pool < spp:
            raise ValueError(f"pool_div={pool_div} leaves a pool below spp={spp}")
    elif scene != "legacy":
        pool = _halved_pool(n, spp, lambda p: p // 2 >= POOL_FLOOR, POOL_FLOOR // 2)
    return _with_drain(grouped, n, spp, pool, drain_ratio, drain_floor)


def _halved_pool(n: int, spp: int, halve, min_aligned: int = 0) -> int:
    """``n`` halved while ``halve(pool)``, rounded up to a multiple of spp,
    then aligned down to ``POOL_ALIGN`` lanes where spp allows and the
    aligned pool keeps at least ``min_aligned`` lanes."""
    pool = n
    while halve(pool):
        pool //= 2
    pool = -(-pool // spp) * spp
    align = math.lcm(POOL_ALIGN, spp)
    if align <= pool and (pool // align) * align >= min_aligned:
        pool = (pool // align) * align
    return pool


def card_schedule(n: int, spp: int, drain_ratio: int = DRAIN_RATIO,
                  drain_floor: int = 0) -> Schedule:
    """The card's auto pool (``spp | n``): the JAX rule's algorithm with the
    card's parameter. Where the JAX rule takes the narrowest pool at or
    above the TPU's knee, this takes the widest grouped pool ``q·n``, ``q``
    a divisor of spp, within ``CARD_POOL_LANES``; each lane then runs
    ``spp / q`` work items. When ``n`` alone exceeds the budget, the pool
    halves from ``n`` until it fits, and is rounded up to a multiple of spp
    and aligned down to ``POOL_ALIGN`` lanes where spp allows, as in the JAX
    rule. The drain cascade is the JAX rule's, from this pool."""
    if n <= CARD_POOL_LANES:
        q = max(q for q in range(1, spp + 1) if spp % q == 0 and q * n <= CARD_POOL_LANES)
        return schedule(n, spp, pool_mult=q, drain_ratio=drain_ratio, drain_floor=drain_floor)
    pool = _halved_pool(n, spp, lambda p: p > CARD_POOL_LANES)
    return _with_drain(True, n, spp, pool, drain_ratio, drain_floor)


def pool_rule(device, n: int, spp: int, scene: str = "spheres", pool_mult: int = 0,
              pool_div: int = 0) -> str:
    """Which rule sets the modular engine's pool: 'override' when
    ``pool_mult`` or ``pool_div`` is given, 'card' (``card_schedule``) for a
    grouped sphere render (``spp | n``) on a CUDA device, else 'jax'
    (``schedule``: the CPU, ungrouped renders, whose pool is ``n``, and the
    legacy scene, whose pool is ``n``)."""
    if pool_mult or pool_div:
        return "override"
    if torch.device(device).type == "cuda" and n % spp == 0 and scene == "spheres":
        return "card"
    return "jax"


def rule_schedule(device, n: int, spp: int, pool_mult: int = 0, pool_div: int = 0,
                  drain_ratio: int = DRAIN_RATIO, drain_floor: int = 0,
                  scene: str = "spheres") -> tuple:
    """``(rule, Schedule)`` of a modular render of ``n`` pixels at ``spp``
    on ``device``: the rule that ``pool_rule`` picks, and its schedule
    (``card_schedule`` for 'card', else ``schedule`` with the knobs)."""
    rule = pool_rule(device, n, spp, scene, pool_mult, pool_div)
    if rule == "card":
        return rule, card_schedule(n, spp, drain_ratio, drain_floor)
    return rule, schedule(n, spp, pool_mult, pool_div, drain_ratio, drain_floor, scene)


def _with_drain(grouped: bool, n: int, spp: int, pool: int, drain_ratio: int,
                drain_floor: int) -> Schedule:
    """The schedule of a pool: its items a lane and the drain levels, which
    narrow it by ``drain_ratio`` a level, in multiples of 256 lanes, down to
    ``drain_floor`` (0: ``DRAIN_FLOOR``)."""
    if drain_ratio < 1:
        raise ValueError(f"drain_ratio={drain_ratio} must be at least 1")
    items_per = -(-(n * spp) // pool) if grouped else spp
    floor = drain_floor if drain_floor > 0 else DRAIN_FLOOR

    def round256(v):
        return -(-v // 256) * 256

    levels = []
    lw = round256(pool // drain_ratio)
    while grouped and lw >= floor and lw < (levels[-1] if levels else pool):
        levels.append(lw)
        lw = round256(lw // drain_ratio)
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
                      pool_mult: int = 0, pool_div: int = 0,
                      drain_ratio: int = DRAIN_RATIO, drain_floor: int = 0,
                      drain_unroll: int = 0, stats: bool = False):
    """Returns ``(image f32[W,H,3], segments int)``, plus a stats dict when
    ``stats``. The same sample values as ``wavefront.render``.

    ``engine``: 'auto' and 'modular' compose the per-stage ops; 'mega' runs
    each pass as one fused bounce kernel (``ops.bounce_megakernel``, K4) over
    a full-width pool of ``W·H`` lanes. The mega engine takes only the
    sphere scene with the modern BSDF and the thin-lens camera, needs
    ``spp | W·H`` and has no pool or drain to set; it raises ``ValueError``
    on any other argument, where the JAX package drops the arguments
    silently. Its samples are the modular engine's, so on the CPU the two
    images agree.

    The modular engine's auto pool depends on the device (``pool_rule``): on
    a CUDA device, for a grouped sphere render, the card's rule
    (``card_schedule``: the widest pool of ``q·n`` lanes within
    ``CARD_POOL_LANES``, so few passes); elsewhere the JAX package's
    (``schedule``). The stats name it (``pool_rule``: 'card', 'jax' or
    'override') beside the ``pool``.

    The stats of either engine carry ``utils.profiling``'s ``spans``,
    ``host_reads`` (the device→host reads: the modular engine's live-count
    reads, the mega engine's ``LaneList`` reads) and ``kernels``.

    The modular engine's schedule knobs, the JAX package's: ``pool_mult``,
    ``pool_div``, ``drain_ratio`` and ``drain_floor`` set the pool and the
    drain levels (``schedule``; ``pool_mult`` and ``pool_div`` override
    either rule, ``drain_ratio`` and ``drain_floor`` apply under each);
    ``drain_unroll = k`` runs ``k`` passes per read of the live-lane count
    in the drain levels (0 or 1: every pass),
    counting each pass and its live lanes on the device, so a level may
    overshoot its boundary by up to ``k - 1`` passes, exact no-ops once the
    pool is empty. Every setting gives the auto image bit for bit and its
    segment count; the passes and the host reads change (``stats``). The
    JAX package's ``acc_split`` picks the TPU's matrix-product accumulation
    windows and has no counterpart (the accumulator is int64 fixed point).
    """
    w, h = resolution
    knobs = dict(pool_mult=pool_mult, pool_div=pool_div, drain_ratio=drain_ratio,
                 drain_floor=drain_floor, drain_unroll=drain_unroll)
    if engine == "mega":
        _check_mega(w * h, spp, bsdf, camera_model, scene, hit_backend, knobs)
    elif engine not in ("auto", "modular"):
        raise ValueError(f"unknown engine: {engine!r}")
    with recording(stats, "lpt.render.mega" if engine == "mega" else
                   "lpt.render.modular", kernel_counters) as table:
        if engine == "mega":
            acc, segments, st = _render_mega(world_data, cam, resolution, spp, limit, seed)
        else:
            acc, segments, st = _persistent_core(
                world_data, cam, resolution, w * h, 0, 0, spp, limit, seed, bsdf,
                camera_model, scene, hit_backend, **knobs)
        img = (radiance(acc) / spp).reshape(w, h, 3)
    if stats:
        return img, segments, {**st, **table.stats()}
    return img, segments


def radiance(acc):
    """Radiance sums f32 from a fixed-point accumulator (int64, 2**-32 units),
    as every engine rounds them."""
    return (acc.to(torch.float64) / _FIXED_ONE).to(torch.float32)


def _persistent_core(world_data, cam: CameraParams, resolution, n: int,
                     pixel_base: int, sample_base: int, spp: int, limit: int,
                     seed, bsdf: str, camera_model: str, scene: str,
                     hit_backend: str, pool_mult: int = 0, pool_div: int = 0,
                     drain_ratio: int = DRAIN_RATIO, drain_floor: int = 0,
                     drain_unroll: int = 0):
    """Persistent render over a pixel range and a sample range: samples
    ``[sample_base, sample_base + spp)`` of pixels ``[pixel_base,
    pixel_base + n)`` of the ``resolution`` image. The schedule, the drain
    cascade and the accumulator are local to the range
    (``rule_schedule(cam.device, n, spp, ...)``: the rule that ``pool_rule``
    picks from the camera's device, ``card_schedule`` or ``schedule``, with
    the knobs of ``render_persistent``; ``acc`` row ``i`` is pixel ``pixel_base + i``),
    and the camera and the RNG key on absolute ids, so a range's samples are
    those of the whole render: ``parallel.mesh`` runs one range a rank.
    Returns ``(acc int64[n, 3] fixed-point radiance sums, segments int,
    stats dict)``; the stats hold the schedule, its rule, the passes and
    ``graph`` (the CUDA graphs the call captured and replayed).

    A sphere world on the card replays ``ModularGraphs`` (``modular_graphs``);
    elsewhere the eager loop runs (``_EagerLanes``). Both run ``_cascade``'s
    schedule, each pass a ``lpt.persistent.pass`` span and its live-count
    read a ``host_read``, with the same bits."""
    dev = cam.device
    rule, sched = rule_schedule(dev, n, spp, pool_mult, pool_div, drain_ratio, drain_floor,
                                scene)
    graphs_before = dict(graphs.GRAPH_COUNTS)
    lanes = modular_graphs(world_data, cam, resolution, n, spp, limit, sched, bsdf,
                           camera_model, scene, hit_backend)
    if lanes is None:
        lanes = _EagerLanes(world_data, sched, spp, item_fn(sched, n, spp, dev),
                            _pass_fns(cam, resolution, seed, pixel_base, sample_base, limit,
                                      bsdf, camera_model, scene, hit_backend),
                            torch.zeros((n, 3), dtype=torch.int64, device=dev))
    else:
        lanes.load(cam, seed, pixel_base, sample_base)
    segments, passes_full, drain_passes = _cascade(lanes, sched.drain_widths,
                                                   max(drain_unroll, 1))
    return lanes.finish(), segments, {
        "pool": sched.pool,
        "pool_rule": rule,
        "passes_full": passes_full,
        "drain_widths": sched.drain_widths,
        "drain_passes": drain_passes,
        "graph": graphs.graph_stats(graphs_before),
    }


def _pass_fns(cam: CameraParams, resolution, seed, pixel_base, sample_base, limit: int,
              bsdf: str, camera_model: str, scene: str, hit_backend: str, err=None) -> dict:
    """``step``'s keywords for a modular render: the scene's hit query, its
    background, the BSDF and the camera's primaries, each in its span, and
    the values they key on. ``seed``, ``pixel_base`` and ``sample_base`` are
    Python ints (the eager loop) or 0-d int64 tensors (``ModularGraphs``),
    which the camera and ``rng.stream`` hash to the same bits; ``err``: K3's
    error word for the hit query (``world.hit``)."""
    hit_fn, background_fn = _scene_fns(scene)
    scatter_fn = SCATTERERS[bsdf]

    def primary(pixel, sample):
        with span("lpt.camera.primary"):
            return generate_rays_for_pixels(cam, resolution, pixel + pixel_base, seed,
                                            sample + sample_base, model=camera_model)

    def hit(wd, rays):
        with span("lpt.persistent.hit"):
            return hit_fn(wd, rays, hit_backend, err)

    def scatter(rays, hits, base):
        with span("lpt.bsdf.scatter"):
            return scatter_fn(rays, hits, base)

    return dict(hit=hit, background=background_fn, scatter=scatter, primary=primary,
                seed=seed, limit=limit, pixel_base=pixel_base, sample_base=sample_base)


def _accumulate(acc, pixel, contrib):
    """A pass's escaped radiance into the fixed-point accumulator."""
    with span("lpt.persistent.accumulate"):
        acc.index_add_(0, pixel, torch.round(contrib * _FIXED_ONE).to(torch.int64))


def _live_first(alive, width: int):
    """The drain's compaction: the indices of the first ``width`` lanes in a
    stable order that puts the live lanes first."""
    return torch.argsort((~alive).to(torch.int32), stable=True)[:width]


def _read(*counts):
    """The device counts to the host, one transfer."""
    return host_read(torch.Tensor.tolist, torch.stack(counts))


def _cascade(lanes, levels: tuple, unroll: int):
    """The modular engine's pass schedule over ``lanes`` (``_EagerLanes`` or
    ``ModularGraphs``): passes over the full pool while more lanes live than
    the first drain width, then, at each drain level, the live lanes
    compacted into its width and passes while more live than the next
    width (0 after the last), ``unroll`` passes a read there. Returns
    ``(segments, passes_full, drain_passes)``: the live lanes of every pass
    summed, and the passes of the full pool and of each level."""
    def run(live, stop_at, unroll):
        segments = passes = 0
        while live > stop_at:
            extra, next_live = lanes.passes(unroll)
            segments += live + extra
            passes += unroll
            live = next_live
        return live, segments, passes

    live, segments, passes_full = run(lanes.start(), levels[0] if levels else 0, 1)
    drain_passes = []
    for li, lw in enumerate(levels):
        with span("lpt.persistent.drain"):
            lanes.drain(lw)
        live, segs, passes = run(live, levels[li + 1] if li + 1 < len(levels) else 0, unroll)
        segments += segs
        drain_passes.append(passes)
    return segments, passes_full, tuple(drain_passes)


class _EagerLanes:
    """The modular engine's lanes as tensors that every pass replaces, each
    op launched from the host: the CPU and the legacy world
    (``graphs.takes_graphs``). ``_cascade`` drives it."""

    def __init__(self, world_data, sched: Schedule, spp: int, item_of, fns: dict, acc):
        self.world, self.sched, self.spp, self.fns, self.acc = world_data, sched, spp, fns, acc
        self.item_of = self.items = item_of     # a drain level's closes over its lanes
        self.group = self.sample = None         # a drain level's lane constants

    def start(self) -> int:
        """Each lane's first work item's primary ray; returns the live lanes."""
        dev = self.acc.device
        self.k = torch.zeros((self.sched.pool,), dtype=torch.int64, device=dev)
        self.bounce = torch.zeros((self.sched.pool,), dtype=torch.int64, device=dev)
        valid, pixel, sample = self.item_of(self.k)
        self.rays = self.fns["primary"](pixel, sample).with_alive(valid)
        (live,) = _read(valid.sum())
        return live

    def passes(self, unroll: int) -> tuple:
        """``unroll`` bounce passes and one read: ``(extra, live)``, the live
        lanes entering each pass after the first, summed on the device, and
        those after the last."""
        later = torch.zeros((), dtype=torch.int64, device=self.acc.device)
        for j in range(unroll):
            with span(PASS_SPAN):
                if j:
                    later += self.rays.alive.sum()
                self.rays, self.k, self.bounce, pixel, contrib, _ = step(
                    self.world, self.rays, self.k, self.bounce, self.items, **self.fns)
                _accumulate(self.acc, pixel, contrib)
        if unroll > 1:
            return tuple(_read(later, self.rays.alive.sum()))
        (live,) = _read(self.rays.alive.sum())
        return 0, live

    def drain(self, width: int):
        """The live lanes compacted into the next level's ``width``."""
        if self.group is None:                # the full pool's lane constants
            lanes = torch.arange(self.sched.pool, dtype=torch.int64, device=self.acc.device)
            self.group, self.sample = lanes // self.spp, lanes % self.spp
        sel = _live_first(self.rays.alive, width)
        self.rays, self.k, self.bounce = self.rays.take(sel), self.k[sel], self.bounce[sel]
        self.group, self.sample = self.group[sel], self.sample[sel]
        self.items = functools.partial(self.item_of, group=self.group, sample=self.sample)

    def finish(self):
        return self.acc


# ``(key, ModularGraphs)`` of the last modular render that took the graphs
# (``modular_graphs``): a render of another key replaces it, and its graphs'
# memory goes with it
_GRAPHS = (None, None)


def modular_graphs(world_data, cam: CameraParams, resolution, n: int, spp: int, limit: int,
                   sched: Schedule, bsdf: str, camera_model: str, scene: str,
                   hit_backend: str):
    """The ``ModularGraphs`` of a modular render of ``n`` pixels at ``spp``
    on ``sched``, captured at the first call of its key and kept until a
    call of another key, or None where the render runs eagerly
    (``graphs.takes_graphs``: off the card, on the legacy world, under a
    dispatch mode). A sphere world takes the graphs under every hit backend.

    The key is what the graphs were captured from: the world's tables where
    they lie (``graphs.signature``), the camera's layout (its values are
    copied in), the resolution, the pixels, spp, the depth, the schedule,
    the BSDF, hit and camera functions, and the hit backend. The seed and
    the range's bases are data (``ModularGraphs.load``)."""
    if not graphs.takes_graphs(scene, cam.device, n):
        return None
    global _GRAPHS
    scatter, hit = SCATTERERS[bsdf], world_mod.hit
    key = (graphs.signature(world_data), graphs.signature(cam, address=False),
           tuple(resolution), n, spp, limit, sched, scatter, hit, camera_model, hit_backend)
    if _GRAPHS[0] != key:
        _GRAPHS = (None, None)      # the old graphs' memory goes before the capture
        _GRAPHS = (key, ModularGraphs(world_data, cam, resolution, n, spp, limit, sched, bsdf,
                                      camera_model, hit_backend))
    return _GRAPHS[1]


@dataclass
class _LaneBuffers:
    """One pool width's lanes in device buffers: the rays, each lane's work
    item counter ``k`` and bounce, and its ``(group, sample)`` constants
    (``item_fn``)."""

    rays: Rays
    k: torch.Tensor
    bounce: torch.Tensor
    group: torch.Tensor
    sample: torch.Tensor

    @classmethod
    def zeros(cls, width: int, device) -> "_LaneBuffers":
        def z(*shape, dtype=torch.int64):
            return torch.zeros((width, *shape), dtype=dtype, device=device)

        return cls(Rays(z(3, dtype=torch.float32), z(3, dtype=torch.float32),
                        z(3, dtype=torch.float32), z(dtype=torch.bool)), z(), z(), z(), z())

    def tensors(self) -> list:
        return [*(t for _, t in graphs.tensor_fields(self.rays)), self.k, self.bounce,
                self.group, self.sample]

    def store_rays(self, rays: Rays):
        for (_, t), (_, new) in zip(graphs.tensor_fields(self.rays), graphs.tensor_fields(rays)):
            t.copy_(new)


class ModularGraphs:
    """A modular sphere-world render on the card as CUDA graphs: its start
    (each lane's first primary ray) and one bounce pass at each pool width
    (the full pool and each drain level: six for the 1280x720, 8-spp card
    frame), each captured once (``graphs.capture``) and replayed for every
    pass of the calls that share its key (``modular_graphs``).
    ``_cascade`` drives it as it drives the eager loop, with the same bits.

    The graphs run the eager loop's own functions (``step``,
    ``_accumulate``, ``_pass_fns``' closures) over static device buffers:
    the camera (``load`` copies its values in); the seed's 32 bits, the
    pixel base and the sample base (0-d int64s that ``load`` fills, which
    the camera and ``rng.stream`` hash as they hash the eager loop's ints);
    each width's lanes (``_LaneBuffers``: each pass copies its next state
    back into them, and the drain's compaction, eager once a level, gathers
    the live lanes into the next width's); the accumulator; ``counts``, the
    live lanes after the last pass and their running sum over the call's
    passes, the one read a pass; and, under the 'bvh' hit backend, K3's
    error word, read once a call. Each replay runs in the span of what it
    replays (``lpt.camera.primary``, ``lpt.persistent.pass``); the spans
    inside them open only at the capture."""

    def __init__(self, world_data, cam: CameraParams, resolution, n: int, spp: int,
                 limit: int, sched: Schedule, bsdf: str, camera_model: str, hit_backend: str):
        dev = cam.device
        self.world = world_data
        self.cam = dataclasses.replace(
            cam, **{k: t.clone() for k, t in graphs.tensor_fields(cam)})
        self.ints = torch.zeros((3,), dtype=torch.int64, device=dev)
        self.acc = torch.zeros((n, 3), dtype=torch.int64, device=dev)
        self.counts = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.err = (torch.zeros((1,), dtype=torch.int32, device=dev)
                    if hit_backend == "bvh" else None)
        self.item_of = item_fn(sched, n, spp, dev)
        self.fns = _pass_fns(self.cam, resolution, *self.ints.unbind(), limit, bsdf,
                             camera_model, "spheres", hit_backend, self.err)
        self.levels = [_LaneBuffers.zeros(w, dev) for w in (sched.pool, *sched.drain_widths)]
        lanes = torch.arange(sched.pool, dtype=torch.int64, device=dev)
        self.levels[0].group.copy_(lanes // spp)
        self.levels[0].sample.copy_(lanes % spp)
        self.level, self.total = 0, 0
        self.start_graph, *self.pass_graphs = graphs.capture(
            dev, [self._start, *(functools.partial(self._pass, lv) for lv in self.levels)])

    def _start(self):
        lv = self.levels[0]
        lv.k.zero_()
        lv.bounce.zero_()
        valid, pixel, sample = self.item_of(lv.k, lv.group, lv.sample)
        lv.store_rays(self.fns["primary"](pixel, sample).with_alive(valid))
        self.acc.zero_()
        self.counts[0].copy_(valid.sum())
        self.counts[1].zero_()
        if self.err is not None:
            self.err.zero_()

    def _pass(self, lv: _LaneBuffers):
        rays, k, bounce, pixel, contrib, _ = step(
            self.world, lv.rays, lv.k, lv.bounce,
            functools.partial(self.item_of, group=lv.group, sample=lv.sample), **self.fns)
        _accumulate(self.acc, pixel, contrib)
        lv.store_rays(rays)
        lv.k.copy_(k)
        lv.bounce.copy_(bounce)
        live = rays.alive.sum()
        self.counts[0].copy_(live)
        self.counts[1].add_(live)

    def load(self, cam: CameraParams, seed, pixel_base: int, sample_base: int):
        """Start a render call: the camera's values, the seed's 32 bits (all
        that ``rng.stream`` reads of it) and the range's bases into the
        buffers."""
        for name, t in graphs.tensor_fields(self.cam):
            t.copy_(getattr(cam, name))
        for t, v in zip(self.ints.unbind(), (int(seed) & 0xFFFFFFFF, pixel_base, sample_base)):
            t.fill_(v)

    def start(self) -> int:
        """The start's replay (the accumulator, the counts and the error
        word to 0); returns the live lanes."""
        with span("lpt.camera.primary"):
            self.start_graph.replay()
        self.level, self.total = 0, 0
        live, _ = host_read(torch.Tensor.tolist, self.counts)
        return live

    def passes(self, unroll: int) -> tuple:
        """``unroll`` replays of the level's pass and one read of ``counts``:
        ``(extra, live)`` as ``_EagerLanes.passes`` returns them (the sum's
        growth less the last pass's live lanes is the live lanes entering
        each pass after the first)."""
        graph = self.pass_graphs[self.level]
        for _ in range(unroll):
            with span(PASS_SPAN):
                graph.replay()
        live, total = host_read(torch.Tensor.tolist, self.counts)
        extra, self.total = total - self.total - live, total
        return extra, live

    def drain(self, width: int):
        """The live lanes gathered into the next level's buffers."""
        src, dst = self.levels[self.level], self.levels[self.level + 1]
        sel = _live_first(src.rays.alive, width)
        for a, b in zip(src.tensors(), dst.tensors()):
            torch.index_select(a, 0, sel, out=b)
        self.level += 1

    def finish(self):
        """The accumulator, copied out of the buffer the next call
        overwrites; under the 'bvh' hit backend K3's error word is read
        first and raises the error its launches would have
        (``check_flags``)."""
        if self.err is not None:
            check_flags(host_read(int, self.err))
        return self.acc.clone()


MODULAR_KNOBS = dict(pool_mult=0, pool_div=0, drain_ratio=DRAIN_RATIO, drain_floor=0,
                     drain_unroll=0)


def _check_mega(n: int, spp: int, bsdf: str, camera_model: str, scene: str,
                hit_backend: str, knobs=None):
    """The arguments the mega engine takes, each named where it is not;
    ``knobs``: the schedule knobs, which it takes only at their defaults
    (``MODULAR_KNOBS``: its pool is ``n`` lanes and it has no drain)."""
    wanted = [("bsdf", bsdf, "modern"), ("camera_model", camera_model, "thinlens"),
              ("scene", scene, "spheres"), ("hit_backend", hit_backend, "auto")]
    wanted += [(name, value, MODULAR_KNOBS[name]) for name, value in (knobs or {}).items()]
    for name, value, want in wanted:
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
