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
each), the tables of ``utils.profiling.recording`` and ``graph`` (the CUDA
graphs the call captured and replayed: ``captures``, ``replays``).

A sphere world on the card runs as CUDA graphs (``PassGraphs``): a
sample's primaries and the bounce pass (``bounce_pass``), each captured
once, at the first call of its shape, and replayed for every sample and
pass of that call and later ones, in the spans above, with the same bits
and the same kernel counts as the eager loop. Between the pass replays the
host reads only the live check (``early_exit``); the segment count and K3's
error word are read once a render call. The legacy world and the CPU run
the eager loop (``_trace_eager``), which launches every op from the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels, pixel_grid
from ..core import rng
from ..core.pytree import tree_where
from ..core.types import Rays
from ..ops import kernel_counters
from ..ops.packet_traverse import check_flags
from ..scene import world as world_mod
from ..utils.profiling import host_read, recording, span
from . import graphs

ROOT_SPAN = "lpt.render.wavefront"
PASS_SPAN = "lpt.wavefront.pass"
# ``(key, PassGraphs)`` of the last render that took the graphs
# (``pass_graphs``): a render of another key replaces it, and its graphs'
# memory goes with it
_GRAPHS = (None, None)


def sky_background(rd):
    """White→blue vertical gradient (10_final/__main__.py:58-62)."""
    t = 0.5 * (rd[..., 1] + 1.0)
    # white (1, 1, 1) and blue (0.5, 0.7, 1.0) as scalars, so no constant
    # tensor is copied to the device on every pass
    return torch.stack([(1.0 - t) + t * b for b in (0.5, 0.7, 1.0)], dim=-1)


def _scene_fns(scene: str):
    """(hit_fn(world, rays, backend, err=None), background_fn(world, rd)) per
    scene kind.

    'spheres': the modern-stage sphere world with the gradient sky.
    'legacy' : textured mesh/sphere world (``scene.legacy_world``) with
    equirect IBL escape; ``hit_backend`` and ``err`` do not apply to it (its
    traversal reads its own error word, ``hit_legacy``).
    """
    if scene == "spheres":
        return (lambda w, r, hb, err=None: world_mod.hit(w, r, backend=hb, err=err),
                lambda w, rd, mask=None: sky_background(rd))
    if scene == "legacy":
        from ..scene.legacy_world import environment_color, hit_legacy

        return (lambda w, r, hb, err=None: hit_legacy(w, r),
                lambda w, rd, mask=None: environment_color(
                    w.envs, w.env_id, rd, mask=mask, gradient_h=w.env_gradient_h))
    raise ValueError(f"unknown scene kind: {scene!r}")


def bounce_pass(world_data, rays, radiance, segments, stream_h, pix, hit_fn,
                background_fn, scatter, hit_backend: str, err=None):
    """One bounce pass over the whole wavefront: the hit query, the segment
    count, the escape term, the BSDF's RNG base and scatter, and the
    survivor select. Returns the next ``(rays, radiance, segments)``.

    ``stream_h``: the pass's BSDF stream hash, ``rng.stream(seed, sample,
    bounce, rng.STREAM_BSDF)``, a Python int (the eager loop) or a 0-d
    int64 tensor (``PassGraphs``); ``pix``: the lanes' int64 pixel ids;
    ``hit_fn``, ``background_fn``: ``_scene_fns``'; ``err``: K3's error word
    for the hit query (``world.hit``)."""
    with span("lpt.wavefront.hit"):
        hits = hit_fn(world_data, rays, hit_backend, err)
    segments = segments + rays.alive.sum()

    escaped = rays.alive & ~hits.hit
    with span("lpt.wavefront.escape"):
        radiance = radiance + torch.where(
            escaped[:, None],
            background_fn(world_data, rays.rd, escaped) * rays.throughput,
            0.0,
        )

    base = rng.base(stream_h, pix)
    with span("lpt.bsdf.scatter"):
        scattered = scatter(rays, hits, base)
    survived = rays.alive & hits.hit
    return tree_where(survived, scattered, rays).with_alive(survived), radiance, segments


def _trace_eager(world_data, cam, resolution, pix, seed, sample, limit, bsdf,
                 camera_model, scene, hit_backend, early_exit):
    """``trace_sample_pixels`` with a launch of every op from the host:
    ``(radiance f32[N,3], segments int)``."""
    with span("lpt.camera.primary"):
        rays = generate_rays_for_pixels(cam, resolution, pix, seed, sample,
                                        model=camera_model)
    scatter = SCATTERERS[bsdf]
    hit_fn, background_fn = _scene_fns(scene)
    radiance = torch.zeros((rays.count, 3), dtype=torch.float32, device=pix.device)
    segments = torch.zeros((), dtype=torch.int64, device=pix.device)
    for b in range(limit):
        if early_exit and not host_read(bool, rays.alive.any()):
            break
        with span(PASS_SPAN):
            rays, radiance, segments = bounce_pass(
                world_data, rays, radiance, segments,
                rng.stream(seed, sample, b, rng.STREAM_BSDF), pix, hit_fn, background_fn,
                scatter, hit_backend)
    return radiance, host_read(int, segments)


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
    package's fixed ``limit``-pass scan. A sphere world on the card replays
    ``PassGraphs``; the same bits.
    """
    pix = pixel_ids.to(torch.int64)
    pg = pass_graphs(world_data, cam, resolution, pix.shape[0], bsdf, camera_model, scene,
                     hit_backend)
    if pg is None:
        return _trace_eager(world_data, cam, resolution, pix, seed, sample, limit, bsdf,
                            camera_model, scene, hit_backend, early_exit)
    pg.load(cam, pix)
    radiance = pg.sample(seed, sample, limit, early_exit).clone()
    return radiance, pg.finish()


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


def _stats(table, graphs_before) -> dict:
    """A render's stats from its table: the passes are its pass spans;
    ``graph``, the CUDA graphs it captured and replayed since the snapshot
    ``graphs_before`` (``graphs.graph_stats``)."""
    return {"passes": table.spans.get(PASS_SPAN, [0])[0], **table.stats(),
            "graph": graphs.graph_stats(graphs_before)}


def _accumulate(world_data, cam, acc, sample_start, resolution, spp_per_call, limit, seed,
                bsdf, camera_model, scene, hit_backend, early_exit):
    """``acc`` plus the radiance of samples ``sample_start + k``, ``k <
    spp_per_call``, added one sample at a time; returns ``(acc, segments)``.
    ``PassGraphs`` read their segments and K3's error word once, at the end."""
    pix = pixel_grid(resolution, cam.device)
    pg = pass_graphs(world_data, cam, resolution, pix.shape[0], bsdf, camera_model, scene,
                     hit_backend)
    if pg is not None:
        pg.load(cam, pix)
        for k in range(spp_per_call):
            acc = acc + pg.sample(seed, sample_start + k, limit, early_exit)
        return acc, pg.finish()
    segs = 0
    for k in range(spp_per_call):
        radiance, segments = _trace_eager(
            world_data, cam, resolution, pix, seed, sample_start + k, limit, bsdf,
            camera_model, scene, hit_backend, early_exit)
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
    graphs_before = dict(graphs.GRAPH_COUNTS)
    with recording(stats, ROOT_SPAN, kernel_counters) as table:
        acc, segs = _accumulate(world_data, cam, acc, sample_start, resolution, spp_per_call,
                                limit, seed, bsdf, camera_model, scene, hit_backend,
                                early_exit)
    return (acc, segs, _stats(table, graphs_before)) if stats else (acc, segs)


def render_chunked(world_data, cam: CameraParams, resolution, spp: int,
                   limit: int = 32, seed=0, chunk_spp: int = 8,
                   bsdf: str = "modern", camera_model: str = "thinlens",
                   scene: str = "spheres", hit_backend: str = "auto",
                   early_exit: bool = True, stats: bool = False):
    """``render`` dispatched in chunks of ``chunk_spp`` samples (the same
    RNG counters and order of adds, so the same image). Returns (image
    f32[W,H,3], segments int), and the stats dict with ``stats``."""
    w, h = resolution
    graphs_before = dict(graphs.GRAPH_COUNTS)
    with recording(stats, ROOT_SPAN, kernel_counters) as table:
        acc = torch.zeros((w * h, 3), dtype=torch.float32, device=cam.device)
        segs = 0
        for s0 in range(0, spp, chunk_spp):
            acc, segments = _accumulate(
                world_data, cam, acc, s0, resolution, min(chunk_spp, spp - s0), limit, seed,
                bsdf, camera_model, scene, hit_backend, early_exit)
            segs += segments
        image = (acc / spp).reshape(w, h, 3)
    return (image, segs, _stats(table, graphs_before)) if stats else (image, segs)


# ------------------------------------------------------------ CUDA graphs --

def pass_graphs(world_data, cam: CameraParams, resolution, n: int, bsdf: str,
                camera_model: str, scene: str, hit_backend: str):
    """The ``PassGraphs`` of a render of ``n`` lanes, captured at the first
    call of its key and kept until a call of another key, or None where
    the render runs eagerly (``graphs.takes_graphs``: off the card, on the
    legacy world, whose traversal reads its error word on every call, and
    under a dispatch mode). A sphere world takes the graphs under every hit
    backend: none reads the device (K3 defers its error word).

    The key is what the graphs were captured from: the world's tables
    where they lie (``graphs.signature``), the camera's layout (its values are
    copied in), the resolution, the lane count, the BSDF, hit and camera
    functions, and the hit backend."""
    if not graphs.takes_graphs(scene, cam.device, n):
        return None
    global _GRAPHS
    scatter, hit = SCATTERERS[bsdf], world_mod.hit
    key = (graphs.signature(world_data), graphs.signature(cam, address=False),
           tuple(resolution), n, scatter, hit, camera_model, hit_backend)
    if _GRAPHS[0] != key:
        _GRAPHS = (None, None)      # the old graphs' memory goes before the capture
        _GRAPHS = (key, PassGraphs(world_data, cam, resolution, n, scatter, camera_model,
                                   hit_backend))
    return _GRAPHS[1]


class PassGraphs:
    """A sphere-world render's primaries and bounce pass on the card, each
    captured once as a CUDA graph (``torch.cuda.CUDAGraph``) and replayed
    for every sample and pass of the calls that share its key
    (``pass_graphs``).

    The graphs run the eager loop's own functions,
    ``generate_rays_for_pixels`` and ``bounce_pass``, over static device
    buffers: the camera and the pixel ids (``load`` copies them in), the
    stream hash (a 0-d int64, filled with the eager loop's
    ``rng.stream(...)`` before each replay), the rays (each pass copies its
    next rays back into them), the radiance, the segment count and K3's
    error word. They read the world's tables where they lie, and hold the
    world. Each replay runs in the span of what it replays; the capture and
    its counts are ``graphs.capture``'s."""

    def __init__(self, world_data, cam: CameraParams, resolution, n: int, scatter,
                 camera_model: str, hit_backend: str):
        dev = cam.device
        self.world, self.resolution = world_data, tuple(resolution)
        self.scatter, self.camera_model, self.hit_backend = scatter, camera_model, hit_backend
        self.hit_fn, self.background_fn = _scene_fns("spheres")
        self.cam = dataclasses.replace(
            cam, **{k: t.clone() for k, t in graphs.tensor_fields(cam)})
        self.pix = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.stream_h = torch.zeros((), dtype=torch.int64, device=dev)
        self.rays = Rays(*(torch.zeros((n, 3), dtype=torch.float32, device=dev)
                           for _ in range(3)),
                         alive=torch.zeros((n,), dtype=torch.bool, device=dev))
        self.radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        self.segments = torch.zeros((), dtype=torch.int64, device=dev)
        self.err = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.primaries, self.bounce = graphs.capture(dev, [self._primaries, self._pass])

    def _store(self, rays: Rays):
        for name, t in graphs.tensor_fields(self.rays):
            t.copy_(getattr(rays, name))

    def _primaries(self):
        self._store(generate_rays_for_pixels(self.cam, self.resolution, self.pix, None, None,
                                             model=self.camera_model,
                                             stream_h=self.stream_h))
        self.radiance.zero_()

    def _pass(self):
        rays, radiance, segments = bounce_pass(
            self.world, self.rays, self.radiance, self.segments, self.stream_h, self.pix,
            self.hit_fn, self.background_fn, self.scatter, self.hit_backend, err=self.err)
        self._store(rays)
        self.radiance.copy_(radiance)
        self.segments.copy_(segments)

    def load(self, cam: CameraParams, pix):
        """Start a render call: the camera's values and the int64 pixel ids
        into the buffers, the segment count and the error word to 0."""
        for name, t in graphs.tensor_fields(self.cam):
            t.copy_(getattr(cam, name))
        self.pix.copy_(pix)
        self.segments.zero_()
        self.err.zero_()

    def sample(self, seed, sample, limit: int, early_exit: bool):
        """Sample ``sample``'s primaries and up to ``limit`` bounce passes,
        with the eager loop's live check before each under ``early_exit``.
        Returns the radiance buffer, which the next sample overwrites."""
        self.stream_h.fill_(rng.stream(seed, sample, 0, rng.STREAM_CAMERA))
        with span("lpt.camera.primary"):
            self.primaries.replay()
        for b in range(limit):
            if early_exit and not host_read(bool, self.rays.alive.any()):
                break
            with span(PASS_SPAN):
                self.stream_h.fill_(rng.stream(seed, sample, b, rng.STREAM_BSDF))
                self.bounce.replay()
        return self.radiance

    def finish(self) -> int:
        """The segments traced since ``load``, in one read with K3's error
        word; raises the error its launches would have (``check_flags``)."""
        segments, flags = host_read(torch.Tensor.tolist, torch.cat(
            [self.segments.view(1), self.err.to(torch.int64)]))
        check_flags(flags)
        return segments
