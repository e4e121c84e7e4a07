"""Masked-wavefront path-tracing integrator.

Counterpart of ``learn_path_tracing_tpu.integrator.wavefront``: a loop of
bounce passes over the whole flat wavefront with an ``alive`` mask. A path
contributes ``background(rd) * throughput`` only if it escapes within the
bounce budget; paths that exhaust the budget contribute nothing.

``render``, ``render_accumulate`` (the progressive viewer's wavefront
engine) and ``render_chunked`` add samples in the same order, so for the
same samples they give the same bits. Each takes the JAX package's
``early_exit``: True stops the bounce loop once no lane is live, False runs
all ``limit`` passes; both give the same bits.

Spans (``utils.profiling``): the root ``lpt.render.wavefront``; a sample's
primaries in ``lpt.camera.primary``; each bounce pass in
``lpt.wavefront.pass``, and inside it the world's hit query
(``lpt.wavefront.hit``: K3 under ``hit_backend='bvh'`` on the card, and
the hit record), the escape term (``lpt.wavefront.escape``) and the BSDF
(``lpt.bsdf.scatter``). With ``stats=True`` the three renders also return
a stats dict: ``passes`` (the bounce passes of every sample, one hit query
each) and the tables of ``utils.profiling.recording``.
"""

from __future__ import annotations

import torch

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels, pixel_grid
from ..core import rng
from ..core.pytree import tree_where
from ..ops import kernel_counters
from ..scene import world as world_mod
from ..utils.profiling import host_read, recording, span

ROOT_SPAN = "lpt.render.wavefront"
PASS_SPAN = "lpt.wavefront.pass"


def sky_background(rd):
    """White→blue vertical gradient (10_final/__main__.py:58-62)."""
    t = 0.5 * (rd[..., 1] + 1.0)
    # white (1, 1, 1) and blue (0.5, 0.7, 1.0) as scalars, so no constant
    # tensor is copied to the device on every pass
    return torch.stack([(1.0 - t) + t * b for b in (0.5, 0.7, 1.0)], dim=-1)


def _scene_fns(scene: str):
    """(hit_fn(world, rays, backend), background_fn(world, rd)) per scene kind.

    'spheres': the modern-stage sphere world with the gradient sky.
    'legacy' : textured mesh/sphere world (``scene.legacy_world``) with
    equirect IBL escape; ``hit_backend`` does not apply to it.
    """
    if scene == "spheres":
        return (lambda w, r, hb: world_mod.hit(w, r, backend=hb),
                lambda w, rd, mask=None: sky_background(rd))
    if scene == "legacy":
        from ..scene.legacy_world import environment_color, hit_legacy

        return (lambda w, r, hb: hit_legacy(w, r),
                lambda w, rd, mask=None: environment_color(
                    w.envs, w.env_id, rd, mask=mask, gradient_h=w.env_gradient_h))
    raise ValueError(f"unknown scene kind: {scene!r}")


def trace_sample_pixels(world_data, cam: CameraParams, resolution, pixel_ids,
                        seed, sample, limit: int, bsdf: str = "modern",
                        camera_model: str = "thinlens",
                        scene: str = "spheres", hit_backend: str = "auto",
                        early_exit: bool = True):
    """Trace one sample for each absolute pixel id; returns
    (radiance f32[N,3], segments int). RNG keys on absolute pixel ids.

    ``early_exit=True`` stops the bounce loop as soon as every lane is dead
    (one host read per pass); ``False`` runs all ``limit`` passes and reads
    nothing back until the segment count at the end. The skipped passes are
    all-masked no-ops, so both give the same radiance, that of the JAX
    package's fixed ``limit``-pass scan.
    """
    with span("lpt.camera.primary"):
        rays = generate_rays_for_pixels(cam, resolution, pixel_ids, seed, sample,
                                        model=camera_model)
    n = rays.count
    scatter = SCATTERERS[bsdf]
    hit_fn, background_fn = _scene_fns(scene)
    pix = pixel_ids.to(torch.int64)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=pix.device)
    segments = torch.zeros((), dtype=torch.int64, device=pix.device)
    for b in range(limit):
        if early_exit and not host_read(bool, rays.alive.any()):
            break
        with span(PASS_SPAN):
            with span("lpt.wavefront.hit"):
                hits = hit_fn(world_data, rays, hit_backend)
            segments = segments + rays.alive.sum()

            escaped = rays.alive & ~hits.hit
            with span("lpt.wavefront.escape"):
                radiance = radiance + torch.where(
                    escaped[:, None],
                    background_fn(world_data, rays.rd, escaped) * rays.throughput,
                    0.0,
                )

            base = rng.base(rng.stream(seed, sample, b, rng.STREAM_BSDF), pix)
            with span("lpt.bsdf.scatter"):
                scattered = scatter(rays, hits, base)
            survived = rays.alive & hits.hit
            rays = tree_where(survived, scattered, rays).with_alive(survived)
    return radiance, host_read(int, segments)


def trace_sample(world_data, cam: CameraParams, resolution, seed, sample,
                 limit: int, bsdf: str = "modern", camera_model: str = "thinlens",
                 scene: str = "spheres", hit_backend: str = "auto",
                 early_exit: bool = True):
    """Trace one sample per pixel over the full pixel grid."""
    return trace_sample_pixels(
        world_data, cam, resolution, pixel_grid(resolution, cam.device), seed,
        sample, limit, bsdf=bsdf, camera_model=camera_model, scene=scene,
        hit_backend=hit_backend, early_exit=early_exit,
    )


def render(world_data, cam: CameraParams, resolution, spp: int, limit: int = 32,
           seed=0, bsdf: str = "modern", camera_model: str = "thinlens",
           scene: str = "spheres", hit_backend: str = "auto",
           early_exit: bool = True, stats: bool = False):
    """Render ``spp`` samples/pixel; returns (image f32[W,H,3], segments),
    and the stats dict (module docstring) with ``stats``.

    The image is mean linear radiance. ``segments`` counts live ray segments
    actually traced — the Mrays metric numerator.
    """
    return render_chunked(world_data, cam, resolution, spp, limit=limit, seed=seed,
                          chunk_spp=max(spp, 1), bsdf=bsdf, camera_model=camera_model,
                          scene=scene, hit_backend=hit_backend, early_exit=early_exit,
                          stats=stats)


def _stats(table) -> dict:
    """A render's stats from its table: the passes are its pass spans."""
    return {"passes": table.spans.get(PASS_SPAN, [0])[0], **table.stats()}


def _accumulate(world_data, cam, acc, sample_start, resolution, spp_per_call, limit, seed,
                bsdf, camera_model, scene, hit_backend, early_exit):
    """``acc`` plus the radiance of samples ``sample_start + k``, ``k <
    spp_per_call``, added one sample at a time; returns ``(acc, segments)``."""
    segs = 0
    for k in range(spp_per_call):
        radiance, segments = trace_sample(
            world_data, cam, resolution, seed, sample_start + k, limit,
            bsdf=bsdf, camera_model=camera_model, scene=scene,
            hit_backend=hit_backend, early_exit=early_exit,
        )
        acc = acc + radiance
        segs += segments
    return acc, segs


def render_accumulate(world_data, cam: CameraParams, acc, sample_start: int,
                      resolution, spp_per_call: int, limit: int = 32, seed=0,
                      bsdf: str = "modern", camera_model: str = "thinlens",
                      scene: str = "spheres", hit_backend: str = "auto",
                      early_exit: bool = True, stats: bool = False):
    """Progressive step: add samples ``sample_start + k`` for ``k <
    spp_per_call`` into ``acc f32[N,3]`` (radiance sums, one row per
    pixel). Returns ``(acc, segments int)``, and the stats dict with
    ``stats``: a new tensor, ``acc`` itself is not written."""
    with recording(stats, ROOT_SPAN, kernel_counters) as table:
        acc, segs = _accumulate(world_data, cam, acc, sample_start, resolution, spp_per_call,
                                limit, seed, bsdf, camera_model, scene, hit_backend,
                                early_exit)
    return (acc, segs, _stats(table)) if stats else (acc, segs)


def render_chunked(world_data, cam: CameraParams, resolution, spp: int,
                   limit: int = 32, seed=0, chunk_spp: int = 8,
                   bsdf: str = "modern", camera_model: str = "thinlens",
                   scene: str = "spheres", hit_backend: str = "auto",
                   early_exit: bool = True, stats: bool = False):
    """``render`` dispatched in chunks of ``chunk_spp`` samples (the same
    RNG counters and order of adds, so the same image). Returns (image
    f32[W,H,3], segments int), and the stats dict with ``stats``."""
    w, h = resolution
    with recording(stats, ROOT_SPAN, kernel_counters) as table:
        acc = torch.zeros((w * h, 3), dtype=torch.float32, device=cam.device)
        segs = 0
        for s0 in range(0, spp, chunk_spp):
            acc, segments = _accumulate(
                world_data, cam, acc, s0, resolution, min(chunk_spp, spp - s0), limit, seed,
                bsdf, camera_model, scene, hit_backend, early_exit)
            segs += segments
        image = (acc / spp).reshape(w, h, 3)
    return (image, segs, _stats(table)) if stats else (image, segs)
