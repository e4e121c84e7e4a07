"""Hybrid integrator: dense primary slabs feeding one shared secondary pool.

Counterpart of ``learn_path_tracing_tpu.integrator.hybrid`` for the legacy
mesh scenes, whose mean path is short (most traversal work is coherent
camera rays):

- **phase A (per spp chunk)**: all ``n * chunk_spp`` camera rays of the
  chunk are traced in one dense, pixel-major, traversal-only pass
  (``scene.legacy_world.trace_legacy``: no attributes, no atlas taps; in
  lane order under every packet version, the rays being coherent already).
  Escapes deposit their radiance at once.
- **survivor extraction**: a sort on ``t`` moves the hits to a prefix;
  primaries are regenerable from (pixel, sample), so only the work-item id,
  ``t``, prim and source ride along, and ray state, hit attributes and the
  bounce-0 scatter are recomputed at batch width (``cap`` lanes).
- **phase B (shared pool)**: survivor batches from every chunk SPLICE into
  never-touched pool slots (no pool pass until every chunk has delivered);
  if the pool cannot take a batch, the make-room fallback runs pool passes
  until enough lanes died and merges the batch into dead slots. Then one
  end-of-render cascade traces the pool at widths that follow the live
  count (halving by ``drain_ratio``), each pass through
  ``trace_shade_compact``, which leaves the live lanes in a prefix so that
  narrowing is a slice. Escape radiance is carried per lane and deposited
  when the lane's slot is overwritten, dropped, or at the final flush.

RNG streams key on absolute (pixel, sample, bounce), so each sample's
radiance is that of ``persistent.render_persistent`` and
``wavefront.render``, and the traced-segment count is the same.

Differences from the JAX package: its ``lax.while_loop``/``cond`` are
Python loops that read the live count to the host once per pass (as
``persistent.py`` does; the hit count, which sizes the attribute batch,
and the traversal kernel's error flag are read too); the pool keeps ``[W,3]`` tensors instead of TPU
column arrays; and radiance is deposited into the int64 fixed-point
accumulator of ``persistent.py`` (2**-32 units), which is order-free, so
two renders on the card are bit-identical where the JAX package's f32
scatter-adds are not. The 1024-row ``fill`` alignment and the 1M-lane
``pool_w`` cap are the JAX package's defaults, kept so the pass schedule
stays comparable; the image and the segment count do not depend on them.
"""

from __future__ import annotations

import torch

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels
from ..core import rng
from ..core.types import Rays
from ..ops import kernel_counters
from ..utils.profiling import host_read, recording, span, spanned
from .persistent import radiance
from .wavefront import _scene_fns

_FIXED_ONE = 2.0 ** 32  # fixed-point accumulator units per unit radiance (persistent.py)
POOL_CAP = 1 << 20      # auto pool width cap (lanes)
FILL_ALIGN = 1024       # splice offsets advance in whole blocks of this many rows
# hit backend names the hybrid accepts: the JAX package's ``scene.world.hit``
# names ('pallas' there is the TPU kernel) plus the port's 'cuda'
HIT_BACKENDS = ("auto", "cuda", "xla", "pallas", "bvh")


def check_hit_backend(hit_backend: str) -> None:
    """``ValueError`` unless ``hit_backend`` is one of ``HIT_BACKENDS``."""
    if hit_backend not in HIT_BACKENDS:
        raise ValueError(f"unknown hit_backend {hit_backend!r} "
                         f"(one of {', '.join(HIT_BACKENDS)})")


def _r256(v):
    return max(-(-v // 256) * 256, 256)


def _fixed(x):
    """f32 radiance → int64 fixed point, as ``persistent.py`` rounds it."""
    return torch.round(x * _FIXED_ONE).to(torch.int64)


def render_hybrid(world_data, cam: CameraParams, resolution, spp: int,
                  limit: int = 32, seed=0, bsdf: str = "legacy",
                  camera_model: str = "jitter", scene: str = "legacy",
                  hit_backend: str = "auto", chunk_spp: int = 0, cap: int = 0,
                  pool_w: int = 0, drain_ratio: int = 2, sample_base: int = 0,
                  stats: bool = False):
    """Returns ``(image f32[W,H,3], segments int)`` (plus a stats dict when
    ``stats``): the same sample values as the persistent and wavefront
    renders.

    ``chunk_spp``: samples per dense primary slab (0 = auto: the largest
    power-of-two divisor of spp keeping the slab at most 2M lanes).
    ``cap``: survivor batch width (0 = auto: slab/8); larger batches spill
    into several merge rounds. ``pool_w``: secondary pool width (0 = auto:
    every primary survivor of the render at a 1/8 hit fraction, at most 1M
    lanes). ``drain_ratio``: narrowing ratio of the end-of-render cascade.
    ``sample_base``: absolute index of this call's first sample, so
    progressive accumulation draws the one-shot render's RNG counters.
    ``hit_backend``: any name of ``HIT_BACKENDS``, and none changes the
    render (the JAX package takes it and never reads it either: both walk
    the legacy world's packet tables); another name raises ``ValueError``.

    The stats carry ``utils.profiling``'s ``spans``, ``host_reads`` (each
    chunk's hit count, each pool pass's live and hit counts, and on the card
    every traversal launch's error flag) and ``kernels``.
    """
    if scene != "legacy":
        raise ValueError("render_hybrid targets legacy mesh scenes; use "
                         "render_persistent for sphere scenes")
    check_hit_backend(hit_backend)
    w, h = resolution
    with recording(stats, "lpt.render.hybrid", kernel_counters) as table:
        acc, segments, st = _hybrid_core(world_data, cam, resolution, w * h, 0, sample_base,
                                         spp, limit, seed, bsdf, camera_model, chunk_spp,
                                         cap, pool_w, drain_ratio)
        img = (radiance(acc) / spp).reshape(w, h, 3)
    if stats:
        return img, segments, {**st, **table.stats()}
    return img, segments


def _hybrid_core(world_data, cam: CameraParams, resolution, n: int, pixel_base: int,
                 sample_base: int, spp: int, limit: int, seed, bsdf: str,
                 camera_model: str, chunk_spp: int, cap: int, pool_w: int,
                 drain_ratio: int):
    """Hybrid render over a pixel range and a sample range: samples
    ``[sample_base, sample_base + spp)`` of pixels ``[pixel_base,
    pixel_base + n)`` of the ``resolution`` image. Slabs, pool, merges and
    deposits are local to the range (work item ``wid = local pixel * spp +
    local sample``; ``acc`` row ``i`` is pixel ``pixel_base + i``; the auto
    ``chunk_spp``, ``cap`` and ``pool_w`` are sized from ``n``), and the
    camera and the RNG key on absolute ids, so a range's samples are those
    of the whole render: ``parallel.mesh`` runs one range a rank. Returns
    ``(acc int64[n, 3] fixed-point radiance sums, segments int, stats
    dict)``. Spans (``utils.profiling``): ``lpt.hybrid.slab`` (phase A of a
    chunk), ``lpt.hybrid.survivors`` (the sort and extraction),
    ``lpt.hybrid.batch`` (a batch's regeneration, shading, bounce-0 scatter
    and splice or merge), ``lpt.hybrid.pool_pass``, ``lpt.hybrid.flush``
    (deposits of carried radiance: a narrowing's dropped rows, the final
    flush)."""
    from ..scene.legacy_world import shade_from_trace, trace_legacy, trace_shade_compact

    dev = cam.device
    if chunk_spp <= 0:
        chunk_spp = 1
        while spp % (chunk_spp * 2) == 0 and n * (chunk_spp * 2) <= (1 << 21):
            chunk_spp *= 2
    if spp % chunk_spp != 0:
        raise ValueError(f"chunk_spp={chunk_spp} must divide spp={spp}")
    if drain_ratio < 1:
        raise ValueError(f"drain_ratio={drain_ratio} must be >= 1 "
                         f"(cascade levels narrow by this factor)")
    n_chunks = spp // chunk_spp
    slab = n * chunk_spp
    if cap <= 0:
        cap = _r256(slab // 8)
    cap = min(cap, _r256(slab))
    if pool_w <= 0:
        pool_w = min(max(n * spp // 8, 2 * cap), POOL_CAP)
    pool_w = max(_r256(min(pool_w, n * spp)), cap)

    scatter = SCATTERERS[bsdf]
    _, background_fn = _scene_fns("legacy")
    acc = torch.zeros((n, 3), dtype=torch.int64, device=dev)

    def deposit(wid, rad):
        acc.index_add_(0, wid // spp, _fixed(rad))

    def regen(wid):
        """Primary rays of work items ``wid`` (pixel-major: wid = pixel*spp +
        sample), with their absolute pixel and sample ids."""
        pixel, sample = wid // spp + pixel_base, wid % spp + sample_base
        return generate_rays_for_pixels(cam, resolution, pixel, seed, sample,
                                        model=camera_model), pixel, sample

    # Pool state: ro, rd, throughput, carried radiance [W,3]; work-item id,
    # bounce [W] int64; alive [W]. Dead rows are inert unit rays.
    def empty_pool(width):
        z3 = torch.zeros((width, 3), dtype=torch.float32, device=dev)
        rd = z3.clone()
        rd[:, 2] = 1.0
        zi = torch.zeros((width,), dtype=torch.int64, device=dev)
        return {"ro": z3, "rd": rd, "th": z3.clone(), "rad": z3.clone(),
                "wid": zi, "bounce": zi.clone(),
                "alive": torch.zeros((width,), dtype=torch.bool, device=dev)}

    pool = empty_pool(pool_w)
    keys = tuple(pool)
    segments = passes = primary_hits = 0

    @spanned("lpt.hybrid.pool_pass")
    def pool_pass(pool, live):
        """One compacting bounce pass over ``live`` live lanes: returns the
        pool with its live lanes in the prefix ``[0, nhits)``, the live
        count after the pass (the pass's one host read besides nhits), and
        nhits."""
        nonlocal segments
        segments += live
        payload = tuple(pool[k] for k in ("th", "rad", "wid", "bounce", "alive"))
        hits, rd_c, (th, rad, wid, bounce, alive), nhits = trace_shade_compact(
            world_data, pool["ro"], pool["rd"], pool["alive"], payload)
        escaped = alive & ~hits.hit
        env = background_fn(world_data, rd_c, escaped)
        rad = rad + torch.where(escaped[:, None], env * th, 0.0)
        pixel = wid // spp + pixel_base
        sample = wid % spp + sample_base
        base = rng.base(rng.stream(seed, sample, bounce, rng.STREAM_BSDF), pixel)
        with span("lpt.bsdf.scatter"):
            sc = scatter(Rays(ro=hits.point, rd=rd_c, throughput=th, alive=alive), hits,
                         base)
        survived = alive & hits.hit & (bounce + 1 < limit)
        s3 = survived[:, None]
        # dead lanes keep finite ray state (a miss lane's point is its origin)
        new = {"ro": torch.where(s3, sc.ro, hits.point),
               "rd": torch.where(s3, sc.rd, rd_c),
               "th": torch.where(s3, sc.throughput, th),
               "rad": rad, "wid": wid,
               "bounce": torch.where(survived, bounce + 1, bounce),
               "alive": survived}
        return new, host_read(int, survived.sum()), nhits

    def run_until_live(pool, live, threshold):
        """Pool passes until at most ``threshold`` lanes are live (make-room:
        the merge needs dead slots, wherever they sit)."""
        nonlocal passes
        while live > threshold:
            pool, live, _ = pool_pass(pool, live)
            passes += 1
        return pool, live

    def run_until_marker(pool, live, marker, threshold):
        """Pool passes until the live-holding prefix ``[0, marker)`` fits
        ``threshold`` rows, or nothing is live."""
        nonlocal passes
        while marker > threshold and live > 0:
            pool, live, marker = pool_pass(pool, live)
            passes += 1
        return pool, live, marker

    def merge(pool, batch, batch_n):
        """Put a batch (valid prefix ``batch_n``) into dead slots: a stable
        dead-first sort brings ``batch_n`` dead rows to the front (the
        caller made room), their carried radiance is deposited, and the
        batch overwrites them."""
        order = torch.argsort(pool["alive"].to(torch.int32), stable=True)
        pool = {k: v[order] for k, v in pool.items()}
        deposit(pool["wid"][:batch_n], pool["rad"][:batch_n])
        for k in keys:
            pool[k][:batch_n] = batch[k][:batch_n]
        return pool

    def compact_slice(pool, lw):
        """Narrow the pool to ``lw`` rows (every live lane sits in
        ``[0, lw)``); deposit the dropped rows' carried radiance."""
        with span("lpt.hybrid.flush"):
            deposit(pool["wid"][lw:], pool["rad"][lw:])
        return {k: v[:lw] for k, v in pool.items()}

    # ---------------------------------------------------------- chunks --
    lanes = torch.arange(slab, dtype=torch.int64, device=dev)
    live, fill = 0, 0
    for ci in range(n_chunks):
        with span("lpt.hybrid.slab"):
            # phase A: dense pixel-major primaries, traversal only
            wid_a = (lanes // chunk_spp) * spp + ci * chunk_spp + lanes % chunk_spp
            rays, _, _ = regen(wid_a)
            # scanline-coherent already: no coherence sort (packet versions 1, 3)
            t, prim, src = trace_legacy(world_data, rays, sort_rays=False)
            segments += slab
            hitm = torch.isfinite(t)
            esc = ~hitm
            contrib = torch.where(esc[:, None],
                                  background_fn(world_data, rays.rd, esc) * rays.throughput,
                                  0.0)
            acc += _fixed(contrib).reshape(n, chunk_spp, 3).sum(dim=1)
        if limit <= 1:
            continue

        with span("lpt.hybrid.survivors"):
            # survivor extraction: ascending t puts the hits (finite t) first
            count = host_read(int, hitm.sum())
            primary_hits += count
            order = torch.argsort(t, stable=True)[:count]
            wid_s, t_s, prim_s, src_s = wid_a[order], t[order], prim[order], src[order]

        for off in range(0, count, cap):
            with span("lpt.hybrid.batch"):
                batch_n = min(cap, count - off)
                sl = slice(off, off + batch_n)
                # regeneration, deferred shading and the bounce-0 scatter at
                # batch width (rows past batch_n are inert padding)
                widb = torch.zeros((cap,), dtype=torch.int64, device=dev)
                widb[:batch_n] = wid_s[sl]
                tb = torch.full((cap,), float("inf"), device=dev)
                tb[:batch_n] = t_s[sl]
                primb = torch.full((cap,), -1, dtype=torch.int32, device=dev)
                primb[:batch_n] = prim_s[sl]
                srcb = torch.full((cap,), -1, dtype=torch.int32, device=dev)
                srcb[:batch_n] = src_s[sl]
                raysb, pixb, smpb = regen(widb)
                hitsb = shade_from_trace(world_data, raysb, tb, primb, srcb, count=batch_n)
                base = rng.base(rng.stream(seed, smpb, 0, rng.STREAM_BSDF), pixb)
                with span("lpt.bsdf.scatter"):
                    scb = scatter(raysb, hitsb, base)
                batch = empty_pool(cap)
                batch["ro"][:batch_n] = scb.ro[:batch_n]
                batch["rd"][:batch_n] = scb.rd[:batch_n]
                batch["th"][:batch_n] = scb.throughput[:batch_n]
                batch["wid"][:batch_n] = widb[:batch_n]
                batch["bounce"][:batch_n] = 1
                batch["alive"][:batch_n] = True

                if fill + cap <= pool_w:
                    # splice into never-touched rows (their rad is 0): no pass
                    for k in keys:
                        pool[k][fill:fill + cap] = batch[k]
                    fill = -(-(fill + batch_n) // FILL_ALIGN) * FILL_ALIGN
                else:
                    # make room: live lanes are scattered from here on, so
                    # every later batch merges too
                    pool, live = run_until_live(pool, live, pool_w - batch_n)
                    pool = merge(pool, batch, batch_n)
                    fill = pool_w
                live += batch_n
    passes_chunkphase = passes

    # ------------------------------------------- end-of-render cascade --
    levels = []
    if limit > 1:
        lw = _r256(pool_w // drain_ratio)
        while 256 <= lw < (levels[-1] if levels else pool_w):
            levels.append(lw)
            lw = _r256(lw // drain_ratio)
    by_level = []
    pool, live, marker = run_until_marker(pool, live, pool_w,
                                          levels[0] if levels else 0)
    by_level.append(passes)
    for li, lw in enumerate(levels):
        pool = compact_slice(pool, lw)
        marker = min(marker, lw)
        nxt = levels[li + 1] if li + 1 < len(levels) else 0
        pool, live, marker = run_until_marker(pool, live, marker, nxt)
        by_level.append(passes)
    with span("lpt.hybrid.flush"):
        deposit(pool["wid"], pool["rad"])   # final flush: every lane is dead

    # passes_by_width: chunk-phase make-room passes at pool_w, the cascade
    # head (also at pool_w), then each cascade level
    widths = [pool_w, pool_w] + levels
    cum = [passes_chunkphase] + by_level
    per = [cum[0]] + [cum[i + 1] - cum[i] for i in range(len(cum) - 1)]
    return acc, segments, {
        "chunk_spp": chunk_spp, "n_chunks": n_chunks, "cap": cap,
        "pool_w": pool_w, "levels": tuple(levels), "passes": passes,
        "passes_chunkphase": passes_chunkphase,
        "passes_by_width": tuple(zip(widths, per)),
        "primary_hits": primary_hits,
    }
