#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths and checks them:

- the 10_final sphere path: the stage-10 cover scene through the CLI's
  ``render --stage 10`` → ``stages.common.run_path_traced`` →
  ``integrator.persistent`` (modular engine) → ``scene.world.hit`` → the
  sphere-scan kernel (K1), and through the bench's modular cell;
- the mega engine: the same scene through
  ``integrator.persistent.render_persistent(engine='mega')``, one fused
  bounce-pass kernel (K4) per pass;
- the legacy mesh path: ``stages.l14_mesh`` on a saved ``.world.npy`` →
  ``viewer.progressive`` → ``integrator.hybrid`` →
  ``scene.legacy_world`` → the packet-traversal kernel of the packet
  version: K2 (version 2, triangle leaves), K5a (version 1, the v1 packet
  walk) or K5b (version 3, the tile-ranged walk); a world of 8,192 spheres
  takes K2's template with sphere leaves (K3); the viewer's wavefront
  engine reaches the same kernels through ``hit_legacy``. Every shading
  call of the path fetches its triangle-attribute row through K6a and its
  strip-atlas pair rows (material and environment) through K6b
  (``ops.row_gather``);
- stage l13: ``stages.l13_texture`` (one textured sphere under the
  environment, the wavefront integrator), whose taps run K6b;
- the bench (``bench_torch.run_cell``): the modular 10_final cell (K1),
  the mega cell (K4) and the mesh cell on the stand-in's ``.world.npy``
  (K2, K6a, K6b); stages l11 (K1 under ``--hit-backend auto``, K3 under
  ``bvh``), l12 (the progressive renderer's wavefront engine over the
  sphere BVH: K3) and l15 (the stand-in as an OBJ + MTL + PNG + EXR asset
  tree, built, saved and accumulated through the hybrid engine: K2, K6a,
  K6b); and ``python -m learn_path_tracing_tpu_torch smoke``;
- multi-device rendering (``parallel.mesh`` over an NCCL group of one rank
  on the card): ``render_hybrid_multichip`` on the stand-in (K2, K6a,
  K6b), ``render_persistent_multichip`` and ``render_multichip`` on the
  cover scene (K1); with more than one card, the same on every card as
  every tile and, with an even count, as (cards / 2) tiles x 2 spp
  (``parallel.launch`` of ``bench_torch.sharded_cells``), with the
  collectives timed between the cards;
- the HTTP viewer (``viewer.serve``): its loop on the sphere scene (K1
  through the wavefront engine) and on the stand-in's ``.world.npy`` (K2,
  K6a, K6b through the hybrid engine), with the native BVH builder
  (``accel.native``) building every stand-in tree.

Phases:

1. prints the card, its power limit, and the torch and CUDA versions;
2. builds every kernel from the sources in the checkout (one ``nvcc`` per
   source, all started together, and the native BVH builder's ``g++``
   beside them) and prints ``ptxas``'s register, memory and spill lines;
3. holds each kernel against its plain PyTorch twin on the card, at the
   paths' shapes, timed with CUDA events (median of 20 runs), with the
   bound of its work: K1 on the cover scene's wavefronts and on their
   first 7,168, 1,024 and 256 rays, bitwise, then timed at each of those
   pass widths;
   ``hit(backend='bvh')`` (the cover scene's sphere BVH through K3) on the
   same four wavefronts against ``hit(backend='auto')``, counting the rays
   that differ (none may); K4 one pass over its lane list from three states
   of the 1280x720, 64 spp headline (primary, after 10 passes, under 1 %
   live), in place on a copy, against the twin's all-lanes pass: its
   integer rows, deposits, live count and next list bitwise and any
   differing float row named, counted and bounded; each state's pass timed
   with its own bound;
   K2, K5a and K5b on the stand-in mesh's 1,843,200-ray primary slab
   (640x360, 8 samples), its first-bounce survivors, random rays with
   random ``t_init`` and half the lanes inactive, rays starting on the
   surface and exactly axis-parallel rays (which K5a hits and K2 misses),
   bitwise in ``(t, prim)``, then timed in turns in lane order and in
   coherence-sorted order with their mean pops per ray; K3 on the first
   four kinds of ray sets over the 8,192 spheres, bitwise; K6a and K6b at
   ``scripts/profile_gather2.py``'s shapes (231,424 random and sorted
   indices into f32 [23,425 x 32] and bf16 [1,122,305 x 256]), on the
   stand-in's four gathered tables with one headline shading call's
   indices, and with wrapping and out-of-range indices (fill rows),
   bitwise, timed beside ``torch.index_select``;
4. renders small images on the card and on the CPU (cover scene,
   persistent modular and mega, two mega card renders bitwise equal; the
   CLI's ``render --stage 10`` at 64x36, K1 once per hit call; stand-in
   mesh + a sphere, hybrid) and holds each pair to the agreement bounds of
   ``utils.checks``;
5. with every launch count set to 0 just before each and read just after:
   a hybrid render of the sphere world (the K3 path); the 640x360, 64 spp,
   depth-32 stand-in render through ``stages.l14_mesh`` under packet
   versions 2, 1 and 3, each after a warm-up, checking that the version's
   kernel launches equal the traversal calls the integrator counts (slabs
   plus pool passes) and no other kernel runs, that K6a and K6b launch as
   often as the frame's attribute blocks and environment taps imply
   (``expected_gathers``), that the image is finite
   with a sane mean (``outputs/chip_smoke_l14_standin*.png``), and that
   versions 1 and 3 give version 2's segments and linear image bit for
   bit; the viewer cell (640x360, 8 spp, depth 10) through
   ``ProgressiveRenderer(engine='wavefront')`` under each version, held to
   the hybrid engine's frame by ``render_agreement``; stage l13 on the
   stand-in's texture set and EXR at the viewer cell's shape
   (``outputs/chip_smoke_l13.png``), its K6b launches checked the same
   way, and at 64x36 on the card and the CPU, held to
   ``render_agreement``; the bench's mesh cell on the stand-in's
   ``.world.npy`` (1280x720, 64 spp, depth 32, three frames: K2 once per
   traversal call, K6a/K6b as its shading calls imply); stage l15 at its
   preset (1500x1000, 32 spp, one pass) on the stand-in's asset tree, the
   same launch checks, and its saved world reloaded with its own trees
   (``rebuild_bvh=False``) held to the rebuilt world at 64x36; K1 and
   ``hit(backend='bvh')`` (K3) bitwise against their twins on l11's world
   (the 230,400 primary rays of its first orbit frame and the bounce pass
   after them); stage l11 at its preset (640x360, 128 spp, depth 10) under ``auto`` (K1 once per
   hit call, no K3) and ``bvh`` (the reverse), bit for bit the same frame;
   stage l12 at its preset on the script ``w,.,.`` (K3 once per hit call,
   no K1; spp 128, 256, 384; its peak device memory); the bench's modular
   10_final cell (1280x720, 64 spp, depth 32, one frame;
   ``outputs/chip_smoke_10_final.png``: one K1 launch per hit call,
   156,430,643 segments) and its mega cell (three frames; one K4 launch
   per pass, the modular cell's segments and linear image bit for bit),
   then one mega frame under the profiler (device busy time, K4's share);
   each bench row is printed as the CLI prints it; before the stand-in's
   build, ``[native bvh]``: its BVH with the numpy and the C++ builder,
   byte for byte equal, both timed (the stand-in's build then asserts that
   the C++ builder ran); after l15, ``[multichip]`` (``multichip_phase``:
   the three sharded functions against their single-device frames, bit for
   bit, with the same launches; the collectives timed, which at world
   size 1 are a single-rank copy),
   ``[multichip split]`` (a 2 tile x 2 spp split by ranges on one card)
   and ``[serve]`` (the viewer's loop on both scenes, served frames and
   input checked);
6. the kernels' own device times from ``torch.profiler``: K1 at each pass
   width with every slice count (and K1's device ms in the modular frame:
   its passes at each width times its time there), K3 and K1 under
   ``hit()`` on the primary rays at every pass width, K4's pass from each
   of its three states, K2, K3, K5a and K5b on
   every ray set in lane and sorted order with their pops per ray, and K6a
   and K6b on every gather set. They
   come last because a profiler run can slow the process's later
   launches, which every CUDA-event time and timed frame above would show;
7. the CLI's ``smoke`` command and its ``multichip --nproc <cards>`` dry
   run (``parallel.launch``: one NCCL rank a card), run as subprocesses,
   must exit 0.

The stand-in world (``standin_world``) takes the place of the reference's
Yoimiya character, whose assets are not in the repository: one closed mesh
of 23,424 triangles (a displaced, subdivided icosphere 16 units tall on a
tessellated base), a 1024² PBR texture set and a 2048x1024 HDR
environment, all made from a seed.

``python3 chip_smoke.py --profile-mesh [--packet-version 1|2|3]`` runs only
the kernel build and ``mesh_profile``: where the stand-in frame's time goes
under that packet version (frame times, the profiler's device busy time,
the traversal kernel's and the row gathers' device time and share, the
traversal kernel's device time by the lanes its launches listed, peak
memory, synchronised per-layer host times), printed as one JSON line.
``python3 chip_smoke.py --packet-times`` runs only the build and
``packet_times``: the packet kernels against their twins and their device
times on every ray set. ``python3 chip_smoke.py --multichip`` runs only the
build, ``[multichip]`` (on every card of the host when there are several,
as tiles and as tiles x 2 spp, the collectives timed across the cards) and
the CLI's ``multichip --nproc <cards>`` dry run.

Any failed phase raises, so the script exits non-zero. The last lines are
the ``nvidia-smi`` name and power limit, a JSON line of the kernels, and
``{"ok": true, "device": {...}}``. Each kernel's ``launches`` in the
kernels line is from its first path's run (K1: the bench's modular cell;
K2, K5a, K5b, K6a, K6b: the l14 frame under its version; K3: the sphere
world's render; K4: the bench's mega cell) and ``paths`` holds its
launches on every further path of this slice, each run with the counts
set to 0 just before. Every kernel's ``ms`` in the kernels
line is CUDA events around one wrapper call (the host's issue time
included, and for the packet kernels the read-back of their error word,
one host round trip); every kernel also gives ``device_ms``, its own
duration from ``torch.profiler``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

RES = (1280, 720)
SPP = 64
DEPTH = 32
SCENE_SEED = 20230328
SMALL_RES, SMALL_SPP, SMALL_LIMIT = (64, 36), 4, 8

# legacy mesh path: the shape of bench.py --scene yoimiya
MESH_RES, MESH_SPP, MESH_DEPTH, MESH_CHUNK = (640, 360), 64, 32, 8
STANDIN_SEED = 20231016
STANDIN_TEX, STANDIN_ENV = 1024, (2048, 1024)   # PBR set side, EXR (w, h)
N_SPHERES = 8192          # past the 4,096-sphere brute-scan ceiling: K3
TWIN_RAYS = 65536         # rays of the random, on-surface and axis twin sets
# the viewer-fps cell (scripts/measure_viewer_fps.py): the wavefront engine
VIEWER_RES, VIEWER_SPP, VIEWER_DEPTH = (640, 360), 8, 10


def _log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3, setup=None):
    """Median milliseconds of ``fn()`` on the card, from CUDA events;
    ``setup()``, when given, runs before each call, outside the events."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(iters):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, name, iters=20, warmup=3, setup=None):
    """Median device milliseconds of the kernel whose name contains
    ``name``, launched once by each ``fn()``, from ``torch.profiler``'s
    device events (``setup()`` runs before each call; a session that lost
    more than half of them is run again). Unlike ``cuda_ms``
    it leaves out the host's time to issue the call, which exceeds a small
    kernel's own. A profiler session can leave the process's later
    launches slower, which a host-bound frame or a CUDA-event time would
    show, so ``main`` takes every such time before the first session."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(3):      # the profiler can drop some of a session's events
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if setup is not None:
                    setup()
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        if len(times) >= iters // 2:
            return statistics.median(times)
    raise AssertionError(f"the profiler saw {len(times)} launches of {name}, not {iters}")


def bitwise_equal(x, y) -> bool:
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return bool(torch.equal(x, y))


# the least time the card could take for a kernel's work (bound_ms in the
# kernels line): bytes over the memory rate or FP32 operations over the
# FP32 rate outside the tensor cores, whichever is longer (NVIDIA's H100
# SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SCAN_FLOP_PER_PAIR = 20       # K1/K4: oc, half_b, c0, disc, sqrt, roots
SLAB_FLOP_PER_CHILD = 24      # K2/K3/K5: 6 mul, 6 sub, 6 min/max, 6 compares


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops) -> dict:
    """``bound_ms`` and ``bound_by`` of moving ``n_bytes`` (each input read
    once, each output written once) and doing ``flops`` FP32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_inputs(device):
    """Ray sets for the sphere-scan check, at the main path's shapes."""
    import torch

    from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_modern
    from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels
    from learn_path_tracing_tpu_torch.core import rng
    from learn_path_tracing_tpu_torch.integrator.persistent import schedule
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
    from learn_path_tracing_tpu_torch.scene.world import hit

    wd = random_scene(seed=SCENE_SEED).device(device)
    cp = stage10_camera(RES).params(device)
    sched = schedule(RES[0] * RES[1], SPP)
    lanes = torch.arange(sched.pool, dtype=torch.int64, device=device)
    pixel, sample = lanes // SPP, lanes % SPP
    primary = generate_rays_for_pixels(cp, RES, pixel, 0, sample)

    # first bounce: origins on sphere surfaces, where t_min and the far-root
    # rule of glass matter; hit on the CPU (the plain twin), so this set does
    # not depend on the kernel under test
    primary_cpu = primary.to("cpu")
    hits = hit(wd.to("cpu"), primary_cpu)
    base = rng.base(rng.stream(0, sample.cpu(), 0, rng.STREAM_BSDF), pixel.cpu())
    bounce = scatter_modern(primary_cpu, hits, base)

    # random rays over the scene, and rays that start inside glass spheres
    g = torch.Generator(device="cpu").manual_seed(1234)
    m = 16384
    ro = torch.rand((m, 3), generator=g) * torch.tensor([24.0, 4.0, 24.0]) \
        - torch.tensor([12.0, 0.5, 12.0])
    rd = torch.nn.functional.normalize(torch.randn((m, 3), generator=g), dim=-1)
    glass = torch.nonzero((wd.materials.transparency > 0) & (wd.radii > 0)).flatten().cpu()
    pick = glass[torch.randint(len(glass), (m,), generator=g)]
    centers, radii = wd.centers.cpu()[pick], wd.radii.cpu()[pick]
    inside = centers + 0.9 * radii[:, None] * torch.nn.functional.normalize(
        torch.randn((m, 3), generator=g), dim=-1) * torch.rand((m, 1), generator=g)
    rd_in = torch.nn.functional.normalize(torch.randn((m, 3), generator=g), dim=-1)
    sets = {
        "primary": (primary.ro, primary.rd),
        "bounce1": (bounce.ro.contiguous().to(device), bounce.rd.contiguous().to(device)),
        "random": (ro.to(device), rd.to(device)),
        "inside_glass": (inside.to(device), rd_in.to(device)),
    }
    return wd, sets


# the modular 10_final frame's pass widths: the full pool, then the drains
K1_WIDTHS = (57344, 7168, 1024, 256)


def check_sphere_scan(device):
    """K1 against its plain twin on the card, on the four ray sets and on
    the first rays of the primary and bounce sets at each drain width; then
    the call timed by CUDA events at every pass width of the frame
    (``K1_WIDTHS``). Returns the kernels-line entry (at 57,344 rays) and
    ``device_times()``, to be called after the timed frames: the kernel's
    own time at each width from the profiler, with the slice count the
    wrapper picks and with each other one, as ``{width: ms}`` (it sets the
    entry's ``device_ms``)."""
    import torch

    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss

    wd, sets = scan_inputs(device)
    table, attrs = wd.scan_table, wd.scan_attrs
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = dict(sets)
    for w in K1_WIDTHS[1:]:
        for name in ("primary", "bounce1"):
            cases[f"{name}[:{w}]"] = tuple(x[:w].contiguous() for x in sets[name])
    max_err = 0.0
    for name, (ro, rd) in cases.items():
        t, idx, attr = ss.intersect_spheres_scan(ro, rd, table, attrs)
        t2, idx2, attr2 = ss.intersect_spheres_scan_plain(ro, rd, table, attrs)
        torch.cuda.synchronize()
        hit_k, hit_p = torch.isfinite(t), torch.isfinite(t2)
        both = hit_k & hit_p
        err = float(torch.max(torch.abs(t[both] - t2[both]))) if bool(both.any()) else 0.0
        err = max(err, float(torch.max(torch.abs(attr - attr2))))
        max_err = max(max_err, err)
        same = (bitwise_equal(t, t2) and bitwise_equal(idx, idx2)
                and bitwise_equal(attr, attr2))
        _log(f"[k1] {name}: {ro.shape[0]} rays, slices "
             f"{ss.team_slices(ro.shape[0], table.shape[0], sms)}, hit rate "
             f"{float(hit_k.float().mean()):.4f}, bitwise equal: {same}, "
             f"max |diff| {err:.3g}, hit/miss mismatches "
             f"{int((hit_k != hit_p).sum())}, idx mismatches {int((idx != idx2).sum())}")
        if not same:
            raise AssertionError(f"sphere-scan kernel differs from its twin on '{name}'")

    ro_all, rd_all = sets["primary"]
    widths = {w: (ro_all[:w].contiguous(), rd_all[:w].contiguous()) for w in K1_WIDTHS}
    bounds, entry = {}, None
    for w, (ro, rd) in widths.items():
        call_ms = cuda_ms(lambda: ss.intersect_spheres_scan(ro, rd, table, attrs))
        b = bounds[w] = bound(
            nbytes(ro, rd, table, attrs, *ss.intersect_spheres_scan(ro, rd, table, attrs)),
            w * table.shape[0] * SCAN_FLOP_PER_PAIR)
        _log(f"[k1] time at {w} rays x {table.shape[0]} spheres: the call {call_ms:.4f} ms "
             f"by CUDA events (median of 20); bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        if w == K1_WIDTHS[0]:
            plain_ms = cuda_ms(lambda: ss.intersect_spheres_scan_plain(ro, rd, table, attrs))
            _log(f"[k1] plain twin at {w} rays: {plain_ms:.4f} ms (median of 20)")
            entry = {"name": "sphere_scan", "id": "k1", "route": "cuda",
                     "source": "learn_path_tracing_tpu_torch/csrc/sphere_scan.cu",
                     "replaces": "learn_path_tracing_tpu/ops/sphere_scan.py:49",
                     "max_abs_err": max_err, "ms": call_ms, "plain_ms": plain_ms, **b,
                     "library_ms": None}

    def device_times():
        widths_ms = {}
        for w, (ro, rd) in widths.items():
            by_slices = {p: kernel_ms(lambda p=p: ss._launch(ro, rd, table, attrs, ss.T_MIN, p),
                                      "sphere_scan_kernel")
                         for p in ss.SLICE_CHOICES}
            ms = widths_ms[w] = kernel_ms(lambda: ss.intersect_spheres_scan(ro, rd, table, attrs),
                                          "sphere_scan_kernel")
            _log(f"[k1 device] {w} rays x {table.shape[0]} spheres: kernel {ms:.4f} ms on the "
                 f"device with {ss.team_slices(w, table.shape[0], sms)} slices (profiler, median "
                 f"of 20), by slice count "
                 f"{', '.join(f'{p}: {t:.4f}' for p, t in by_slices.items())} ms; "
                 f"{bounds[w]['bound_ms'] / ms:.3f} of the bound")
        entry["device_ms"] = widths_ms[K1_WIDTHS[0]]
        return widths_ms

    return entry, device_times


def k1_frame_ms(widths_ms, st) -> float:
    """K1's device ms in the modular 10_final frame: its passes at each
    width (the frame's render stats ``st``) times the kernel's time at that
    width."""
    ms = st["passes_full"] * widths_ms[st["pool"]]
    for w, passes in zip(st["drain_widths"], st["drain_passes"]):
        ms += passes * widths_ms[w]
    return ms


def bvh_phase(device):
    """``hit(backend='bvh')`` on the card (the sphere BVH through K3) over
    the cover scene's four K1 ray sets, held to ``hit(backend='auto')`` (K1):
    the rays whose ``t``, sphere or hit flag differ are counted, and must
    be none. Then both calls are timed on the primary set by CUDA events.
    Returns ``device_times()``, to be called after the timed frames: their
    kernels' own times from the profiler on the first rays of the primary
    set at each pass width of the modular frame (``K1_WIDTHS``)."""
    import torch

    from learn_path_tracing_tpu_torch.core.types import Rays
    from learn_path_tracing_tpu_torch.models import random_scene
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.scene.world import hit

    t0 = time.time()
    wd = random_scene(seed=SCENE_SEED).device(device, use_bvh=True)
    _log(f"[bvh] cover scene BVH: {wd.bvh[0].shape[0]} wide nodes, {wd.bvh[2].shape[0]} run "
         f"rows, stack {wd.bvh_stack}; built in {time.time() - t0:.2f} s")
    _, sets = scan_inputs(device)
    for name, (ro, rd) in sets.items():
        n = ro.shape[0]
        rays = Rays(ro=ro, rd=rd, throughput=torch.ones_like(ro),
                    alive=torch.ones((n,), dtype=torch.bool, device=device))
        before = pt.traverse.launches["k3"]
        a, b = hit(wd, rays, backend="bvh"), hit(wd, rays, backend="auto")
        torch.cuda.synchronize()
        differ = ((a.t.view(torch.int32) != b.t.view(torch.int32)) | (a.obj != b.obj)
                  | (a.hit != b.hit))
        count = int(differ.sum())
        _log(f"[bvh] {name}: {n} rays, K3 launches {pt.traverse.launches['k3'] - before}, "
             f"hit rate {float(a.hit.float().mean()):.4f}, rays differing from "
             f"hit(backend='auto'): {count}")
        if count or pt.traverse.launches["k3"] != before + 1:
            raise AssertionError(f"hit(backend='bvh') differs from the scan on '{name}' "
                                 f"({count} rays)")
    ro, rd = sets["primary"]
    rays = Rays(ro=ro, rd=rd, throughput=torch.ones_like(ro),
                alive=torch.ones((ro.shape[0],), dtype=torch.bool, device=device))
    ms = {backend: cuda_ms(lambda backend=backend: hit(wd, rays, backend=backend))
          for backend in ("bvh", "auto")}
    _log(f"[bvh] hit() on {ro.shape[0]} primary rays: backend 'bvh' {ms['bvh']:.4f} ms, "
         f"'auto' {ms['auto']:.4f} ms (CUDA events, median of 20, hit records included)")

    def device_times():
        for w in K1_WIDTHS:
            part = Rays(ro=ro[:w].contiguous(), rd=rd[:w].contiguous(),
                        throughput=rays.throughput[:w], alive=rays.alive[:w])
            dev_ms = {backend: kernel_ms(lambda backend=backend: hit(wd, part, backend=backend),
                                         name)
                      for backend, name in (("bvh", "packet_traverse_kernel"),
                                            ("auto", "sphere_scan_kernel"))}
            _log(f"[bvh device] the kernels of hit() on {w} primary rays: K3 "
                 f"{dev_ms['bvh']:.4f} ms, K1 {dev_ms['auto']:.4f} ms (profiler, median of 20)")

    return device_times


def check_gpu_vs_cpu(device):
    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement

    world = random_scene(seed=SCENE_SEED)
    cam = stage10_camera(SMALL_RES)
    out = {}
    for dev in (device, "cpu"):
        img, segs = render_persistent(world.device(dev), cam.params(dev), SMALL_RES,
                                      spp=SMALL_SPP, limit=SMALL_LIMIT)
        out[dev] = (img.cpu().numpy(), segs)
    rep = render_agreement(out[device][0], out["cpu"][0], out[device][1], out["cpu"][1])
    _log(f"[gpu-vs-cpu] {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP} limit "
         f"{SMALL_LIMIT}: segments {out[device][1]} vs {out['cpu'][1]}, {rep}")
    if not rep["ok"]:
        raise AssertionError(f"GPU render disagrees with the CPU render: {rep}")


# the 10_final frame's exact count of live segments (1280x720, 64 spp, depth 32)
HEADLINE_SEGMENTS = 156_430_643


def bench_modular(device):
    """The bench's modular 10_final cell through ``bench_torch.run_cell``
    (1280x720, 64 spp, depth 32), one timed frame after its spp-1 warm-up,
    with the counts set to 0 just before: one K1 launch per hit call of both
    renders, ``HEADLINE_SEGMENTS`` segments, a sane image
    (``outputs/chip_smoke_10_final.png``). Prints the row as the CLI does
    and returns it."""
    import numpy as np

    import bench_torch
    from learn_path_tracing_tpu_torch.core import color, image
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss

    ss.intersect_spheres_scan.launches = 0
    row = bench_torch.run_cell(engine="persistent", resolution=RES, spp=SPP, limit=DEPTH,
                               device=device, frames=1)
    launches = ss.intersect_spheres_scan.launches
    print(bench_torch.row_line(row), flush=True)
    st = row["stats"]
    post = color.post_process(row["image"])
    image.write_png(post, "outputs/chip_smoke_10_final.png")
    mean = float(post.mean())
    _log(f"[bench modular] {RES[0]}x{RES[1]} spp {SPP} depth {DEPTH}: frame "
         f"{row['frames'][0]:.3f} s, {row['segments']} segments, {row['value']:.3f} Mrays/s, "
         f"pool {st['pool']}, full-width passes {st['passes_full']}, drain widths "
         f"{st['drain_widths']}, drain passes {st['drain_passes']}; K1 launches {launches} "
         f"for hit calls {row['calls']} (warm-up, frame); image mean {mean:.5f}")
    if launches != sum(row["calls"]):
        raise AssertionError(f"sphere-scan launches {launches} != hit calls {row['calls']}")
    if row["segments"] != HEADLINE_SEGMENTS:
        raise AssertionError(f"{row['segments']} segments, not {HEADLINE_SEGMENTS}")
    if not np.isfinite(row["image"].cpu().numpy()).all() or not 0.05 < mean < 0.95:
        raise AssertionError(f"the 10_final image is not sane: mean {mean}")
    return launches, row


# ------------------------------------------------- the mega engine (K4) --

MEGA_ROWS = {"ro": (0, 3), "rd": (3, 6), "throughput": (6, 9), "contrib": (10, 13)}
MEGA_LATE = 0.01          # the late state: fewer live lanes than this share


def mega_states(wd, cp, scalf, device):
    """Three states at the headline shape for the K4 check: the primary
    state, the state after 10 passes (advanced by the plain twin, so it does
    not depend on the kernel under test) and a late state with fewer than
    ``MEGA_LATE`` of the lanes live (advanced by the kernel: the twin takes
    a few hundred passes to get there)."""
    from learn_path_tracing_tpu_torch.integrator.persistent import bounce_pass_plain, mega_pass
    from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk

    n = RES[0] * RES[1]
    stf, sti = mk.initial_state(cp, RES, SPP, 0)
    states = {"primary": (stf, sti)}
    for _ in range(10):
        stf, sti, _ = bounce_pass_plain(stf, sti, wd, scalf, 0, RES, SPP, limit=DEPTH)
    states["pass10"] = (stf, sti)
    stf, sti = stf.clone(), sti.clone()
    lanes = mk.LaneList.of_state(stf, sti)
    passes, live = 10, n
    while live >= MEGA_LATE * n:
        mega_pass(stf, sti, wd, scalf, 0, RES, SPP, lanes, limit=DEPTH)
        live, passes = lanes.advance(), passes + 1
    if live == 0:
        raise AssertionError("the render ended before a late state was reached")
    states[f"late (pass {passes})"] = (stf, sti)
    return states


# bytes a pass moves per listed lane: reads ro, rd, throughput, alive, k,
# bounce and its list entry (52 B); writes 16 + 8 state rows and its next
# list entry (100 B); and per escaped lane a 3 x int64 deposit read and
# written (48 B)
K4_LANE_BYTES, K4_DEPOSIT_BYTES = 152, 48


def check_bounce_megakernel(device):
    """K4 against its plain twin on the card, one pass from each of
    ``mega_states``: the kernel over the state's lane list
    (``LaneList.of_state``), in place on a copy of the state, the twin over
    every lane. Every row must be equal bit for bit, as measured on the
    H100: the integer rows (k, bounce, nearest sphere), the alive row, the
    live count, the fixed-point deposits and the float rows (a float row
    that differs is named with its count of differing lanes and its max
    |diff| before the check fails); and the next list must hold the lanes
    alive after the pass, then those that died in it. Then each state's
    pass is timed by CUDA events (the state restored before each run,
    outside the timing) beside the twin's, with its own bound: its live
    lanes' pair tests and its listed lanes' bytes. Returns the kernels-line
    entry (the primary state's pass, without ``launches``) and
    ``device_times()``, to be called after the timed frames: each state's
    pass timed on the device by the profiler (it sets the entry's
    ``device_ms``)."""
    import torch

    from learn_path_tracing_tpu_torch.integrator.persistent import bounce_pass_plain, mega_pass
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
    from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk

    n = RES[0] * RES[1]
    wd = random_scene(seed=SCENE_SEED).device(device)
    cp = stage10_camera(RES).params(device)
    scalf = mk.pack_camera(cp, RES)
    s = wd.scan_table.shape[0]
    max_err, entry, timers = 0.0, None, []
    for name, (stf, sti) in mega_states(wd, cp, scalf, device).items():
        lanes = mk.LaneList.of_state(stf, sti)
        accs = [torch.zeros((n, 3), dtype=torch.int64, device=device) for _ in range(2)]
        ks, ki = stf.clone(), sti.clone()
        mega_pass(ks, ki, wd, scalf, 0, RES, SPP, lanes, limit=DEPTH, acc=accs[0])
        kl = lanes.counters[:1].clone()
        ps, pi, pl = bounce_pass_plain(stf, sti, wd, scalf, 0, RES, SPP, limit=DEPTH,
                                       acc=accs[1])
        torch.cuda.synchronize()
        ka, pa = accs
        alive_out = ps[mk.ALIVE] > 0.5
        nxt = lanes.next[:lanes.alive].long()
        live = int(pl)
        exact = {"k": bitwise_equal(ki[mk.K], pi[mk.K]),
                 "bounce": bitwise_equal(ki[mk.BOUNCE], pi[mk.BOUNCE]),
                 "sphere": bitwise_equal(ki[mk.OBJ], pi[mk.OBJ]),
                 "unused rows": bitwise_equal(ki[3:], pi[3:]) and bitwise_equal(ks[13:], ps[13:]),
                 "alive": bitwise_equal(ks[mk.ALIVE], ps[mk.ALIVE]),
                 "live count": bitwise_equal(kl, pl), "deposits": bitwise_equal(ka, pa),
                 "next list": (torch.equal(torch.sort(nxt).values,
                                           torch.sort(lanes.lanes[:lanes.alive].long()).values)
                               and bool(alive_out[nxt[:live]].all())
                               and not bool(alive_out[nxt[live:]].any()))}
        rows = []
        for row, (lo, hi) in MEGA_ROWS.items():
            diff = (ks[lo:hi].view(torch.int32) != ps[lo:hi].view(torch.int32)).any(0)
            lanes_differ = int(diff.sum())
            err = float((ks[lo:hi] - ps[lo:hi]).abs().max())
            max_err = max(max_err, err)
            if lanes_differ:
                rows.append(f"{row}: {lanes_differ} lanes differ, max |diff| {err:.3g}")
        _log(f"[k4] {name}: {lanes.alive} live lanes in, {live} out, {lanes.count} listed, "
             f"hit lanes {int((pi[mk.OBJ] >= 0).sum())}, bitwise equal: "
             f"{', '.join(f'{k} {v}' for k, v in exact.items())}; float rows "
             f"{'; '.join(rows) if rows else 'all bitwise equal'}")
        if not all(exact.values()) or rows:
            raise AssertionError(f"K4 differs from its twin on '{name}': {exact}; {rows}")

        restore, run = _k4_pass(stf, sti, lanes, wd, scalf)
        call_ms = cuda_ms(run, setup=restore)
        plain_ms = cuda_ms(lambda: bounce_pass_plain(stf, sti, wd, scalf, 0, RES, SPP,
                                                     limit=DEPTH, acc=accs[1]))
        escaped = int((ps[mk.CONTRIB:mk.CONTRIB + 3] != 0).any(0).sum())
        b = bound(lanes.count * K4_LANE_BYTES + escaped * K4_DEPOSIT_BYTES
                  + nbytes(wd.scan_table, wd.scan_attrs, scalf),
                  lanes.alive * s * SCAN_FLOP_PER_PAIR)
        label = (f"a pass from the {name} state, {lanes.count} listed lanes ({lanes.alive} "
                 f"live) x {s} spheres")
        _log(f"[k4] time of {label}: the call {call_ms:.4f} ms by CUDA events, plain twin "
             f"(all {n} lanes) {plain_ms:.4f} ms (median of 20 each), bound "
             f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        timers.append((label, restore, run, b))
        if entry is None:
            entry = {"name": "bounce_megakernel", "id": "k4", "route": "cuda",
                     "source": "learn_path_tracing_tpu_torch/csrc/bounce_megakernel.cu",
                     "replaces": "learn_path_tracing_tpu/ops/bounce_megakernel.py:167",
                     "ms": call_ms, "plain_ms": plain_ms, **b, "library_ms": None}
    entry["max_abs_err"] = max_err

    def device_times():
        for label, restore, run, b in timers:
            ms = kernel_ms(run, "bounce_pass_kernel", setup=restore)
            entry.setdefault("device_ms", ms)
            _log(f"[k4 device] {label}: kernel {ms:.4f} ms on the device (profiler, median "
                 f"of 20), {b['bound_ms'] / ms:.3f} of the bound")

    return entry, device_times


def _k4_pass(stf, sti, lanes, wd, scalf):
    """``(restore, run)`` for timing K4's pass from ``(stf, sti)`` over
    ``lanes``: ``restore()`` copies the state into a work copy, ``run()``
    runs the pass on it, depositing into an accumulator of its own."""
    import torch

    from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk

    acc = torch.zeros((stf.shape[1], 3), dtype=torch.int64, device=stf.device)
    work_stf, work_sti = stf.clone(), sti.clone()

    def restore():
        work_stf.copy_(stf)
        work_sti.copy_(sti)

    def run():
        mk.bounce_pass(work_stf, work_sti, wd, scalf, 0, RES, SPP, lanes, limit=DEPTH, acc=acc)

    return restore, run


def check_mega_gpu_vs_cpu(device):
    """The mega engine on the card twice (bit-identical) and on the CPU,
    held to ``render_agreement``."""
    import torch

    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement

    world = random_scene(seed=SCENE_SEED)
    cam = stage10_camera(SMALL_RES)
    runs = [render_persistent(world.device(dev), cam.params(dev), SMALL_RES, spp=SMALL_SPP,
                              limit=SMALL_LIMIT, engine="mega")
            for dev in (device, device, "cpu")]
    same = runs[0][1] == runs[1][1] and bitwise_equal(runs[0][0], runs[1][0])
    rep = render_agreement(runs[0][0].cpu().numpy(), runs[2][0].numpy(), runs[0][1],
                           runs[2][1])
    _log(f"[gpu-vs-cpu mega] {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP} limit "
         f"{SMALL_LIMIT}: two card renders bitwise equal: {same}; segments "
         f"{runs[0][1]} vs {runs[2][1]}, {rep}")
    if not same:
        raise AssertionError("two mega renders on the card differ")
    if not rep["ok"]:
        raise AssertionError(f"GPU mega render disagrees with the CPU render: {rep}")
    torch.cuda.synchronize()


def mega_headline(device, modular):
    """The bench's mega 10_final cell through ``bench_torch.run_cell``
    (three frames after its spp-1 warm-up), with the counts set to 0 just
    before: one K4 launch per pass of every render, and the modular cell's
    (``modular``: ``bench_modular``'s row) segments and linear image bit
    for bit (``outputs/chip_smoke_10_final_mega.png``). Then one frame under
    ``torch.profiler`` (device busy time, K4's share and its device ms by
    the lanes each pass listed). Returns K4's launches in the cell."""
    import numpy as np
    import torch

    import bench_torch
    from learn_path_tracing_tpu_torch.core import color, image
    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
    from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk

    mk.bounce_pass.launches = 0
    row = bench_torch.run_cell(engine="mega", resolution=RES, spp=SPP, limit=DEPTH,
                               device=device)
    launches = mk.bounce_pass.launches
    print(bench_torch.row_line(row), flush=True)
    image.write_png(color.post_process(row["image"]), "outputs/chip_smoke_10_final_mega.png")
    arr = row["image"].cpu().numpy()
    mean = float(arr.mean())
    same = (row["segments"] == modular["segments"]
            and bitwise_equal(row["image"], modular["image"]))
    med = statistics.median(row["frames"])
    _log(f"[mega headline] {RES[0]}x{RES[1]} spp {SPP} depth {DEPTH}: frames "
         f"{', '.join(f'{w:.4f}' for w in row['frames'])} s (median {med:.4f} s = "
         f"{row['value']:.3f} Mrays/s), {row['segments']} segments, passes {row['calls']} "
         f"(warm-up, frames), K4 launches {launches}, image mean {mean:.5f}; segments and "
         f"linear image bit for bit the modular cell's ({modular['frames'][0]:.3f} s): {same}")
    if launches != sum(row["calls"]):
        raise AssertionError(f"K4 launches {launches} != passes {row['calls']}")
    if not np.isfinite(arr).all() or not 0.05 < mean < 0.95:
        raise AssertionError(f"mega headline image is not sane: mean {mean}")
    if not same:
        raise AssertionError("the mega cell differs from the modular cell")

    wd = random_scene(seed=SCENE_SEED).device(device)
    cp = stage10_camera(RES).params(device)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, st = render_persistent(wd, cp, RES, spp=SPP, limit=DEPTH, seed=0, engine="mega",
                                     stats=True)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    listed = st["listed"]     # the lanes each pass listed
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    k4 = sorted((e for e in dev if "bounce_pass_kernel" in e.name),
                key=lambda e: e.time_range.start)
    k4_ms = sum(e.time_range.elapsed_us() for e in k4) / 1e3
    _log(f"[mega headline] profiled frame {prof_wall:.4f} s: {len(dev)} device events, device "
         f"busy {busy_ms:.3f} ms, K4 {k4_ms:.3f} ms, idle {1.0 - busy_ms / (med * 1e3):.4f} of "
         f"the median frame")
    if not dev:
        raise AssertionError("torch.profiler recorded no device events")
    if len(k4) != len(listed):
        raise AssertionError(f"{len(k4)} K4 events for {len(listed)} passes")
    n = RES[0] * RES[1]
    cells = []
    for lo, hi in ((n // 2, n), (n // 10, n // 2), (n // 100, n // 10), (0, n // 100)):
        sel = [e.time_range.elapsed_us() / 1e3 for e, c in zip(k4, listed) if lo < c <= hi]
        cells.append(f"({lo}, {hi}]: {len(sel)} passes, {sum(sel):.3f} ms"
                     + (f" ({sum(sel) / len(sel):.4f} ms each)" if sel else ""))
    _log(f"[mega headline] K4 device ms of the profiled frame by listed lanes: "
         f"{'; '.join(cells)}")
    return launches


# ------------------------------------------------------- the mesh path --

def _icosphere(level):
    """Unit icosphere: ``(verts f64[V,3], faces i64[F,3])``, F = 20 * 4**level."""
    import numpy as np

    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    return np.array(verts), np.array(faces, np.int64)


def _standin_mesh(level, seed, segments=64, rings=6, rows=12):
    """One closed figure on a base, as a ``MeshData``: an icosphere of
    ``level`` subdivisions displaced by seeded smooth noise and stretched
    into a 16-unit-tall body (centre (0, 8.5, 0)), on a cylinder of radius
    4 and height 0.5 tessellated with ``segments`` x (``rings`` per cap,
    ``rows`` on the side). ``level`` 5 gives 20,480 + 2,944 = 23,424
    triangles, the size of the reference's Yoimiya mesh."""
    import numpy as np

    from learn_path_tracing_tpu_torch.io.obj import MeshData

    rs = np.random.default_rng(seed)
    unit, faces = _icosphere(level)
    waves = rs.normal(size=(8, 3)) * 2.5
    phase = rs.uniform(0, 2 * np.pi, 8)
    amp = rs.uniform(0.02, 0.05, 8)
    bump = 1.0 + np.sin(unit @ waves.T + phase) @ amp
    body = unit * bump[:, None] * np.array([3.0, 8.0, 3.0]) + np.array([0.0, 8.5, 0.0])
    # area-weighted vertex normals of the displaced body
    fn = np.cross(body[faces[:, 1]] - body[faces[:, 0]], body[faces[:, 2]] - body[faces[:, 0]])
    vn = np.zeros_like(body)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    uv = np.stack([np.arctan2(unit[:, 2], unit[:, 0]) / (2 * np.pi) + 0.5,
                   (unit[:, 1] + 1.0) / 2.0], axis=1)

    # base: two capped discs of concentric rings plus the side wall, each
    # with its own vertices (flat normals), closed where they meet
    ang = np.arange(segments) * (2 * np.pi / segments)
    ring_xz = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    pos, nrm, tex, tris = [body], [vn], [uv], [faces]
    count = body.shape[0]

    def add(p, n, t, f):
        nonlocal count
        pos.append(p)
        nrm.append(n)
        tex.append(t)
        tris.append(f + count)
        count += p.shape[0]

    for y, up in ((0.5, 1.0), (0.0, -1.0)):
        radii = np.arange(1, rings + 1) * (4.0 / rings)
        p = [np.array([[0.0, y, 0.0]])]
        for r in radii:
            p.append(np.stack([r * ring_xz[:, 0], np.full(segments, y), r * ring_xz[:, 1]], 1))
        p = np.concatenate(p)
        f = []
        nxt = np.roll(np.arange(segments), -1)
        f += [(0, 1 + j, 1 + nxt[j]) for j in range(segments)]
        for k in range(rings - 1):
            a, b = 1 + k * segments, 1 + (k + 1) * segments
            for j in range(segments):
                f += [(a + j, b + j, b + nxt[j]), (a + j, b + nxt[j], a + nxt[j])]
        f = np.array(f, np.int64)
        if up < 0:
            f = f[:, ::-1]
        add(p, np.tile([0.0, up, 0.0], (p.shape[0], 1)),
            (p[:, [0, 2]] / 8.0) + 0.5, f)
    ys = np.linspace(0.0, 0.5, rows + 1)
    p = np.concatenate([np.stack([4.0 * ring_xz[:, 0], np.full(segments, y),
                                  4.0 * ring_xz[:, 1]], 1) for y in ys])
    n = np.tile(np.stack([ring_xz[:, 0], np.zeros(segments), ring_xz[:, 1]], 1), (rows + 1, 1))
    t = np.stack([np.tile(ang / (2 * np.pi), rows + 1), np.repeat(ys * 2.0, segments)], 1)
    nxt = np.roll(np.arange(segments), -1)
    f = []
    for k in range(rows):
        a, b = k * segments, (k + 1) * segments
        for j in range(segments):
            f += [(a + j, b + nxt[j], b + j), (a + j, a + nxt[j], b + nxt[j])]
    add(p, n, t, np.array(f, np.int64))

    faces = np.concatenate(tris).astype(np.int32)
    return MeshData(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        uvs=np.concatenate(tex).astype(np.float32),
        face_p=faces, face_n=faces.copy(), face_t=faces.copy(),
        face_tex=np.zeros(faces.shape[0], np.int32))


def _standin_assets(directory, seed, tex_size, env_size):
    """A PBR texture set ``<dir>/standin_{albedo,roughness,metallic,normal}.png``
    of ``tex_size``² and an equirect HDR ``<dir>/standin_env.exr`` of
    ``env_size`` (w, h): a sky gradient over a dark ground with a sun of
    radiance ~40. Returns ``(texture base path, exr path)``."""
    import numpy as np
    from PIL import Image

    from learn_path_tracing_tpu_torch.io.exr import write_exr

    rs = np.random.default_rng(seed)
    s = tex_size
    y, x = np.mgrid[0:s, 0:s] / s
    stripes = (np.sin(2 * np.pi * 12 * y + 3 * np.sin(2 * np.pi * 3 * x)) > 0).astype(np.float32)
    noise = rs.uniform(0, 1, (s // 16, s // 16)).repeat(16, 0).repeat(16, 1)
    albedo = np.stack([0.75 * stripes + 0.2, 0.35 + 0.3 * noise, 0.25 + 0.5 * (1 - stripes)], -1)
    rough = 0.25 + 0.6 * noise
    metal = ((np.sin(2 * np.pi * 4 * y) > 0.7) * 1.0).astype(np.float32)
    nrm = np.stack([0.5 + 0.1 * np.sin(2 * np.pi * 32 * x), 0.5 + 0.1 * np.cos(2 * np.pi * 32 * y),
                    np.ones_like(x)], -1)
    base = os.path.join(directory, "standin")
    for name, img in (("albedo", albedo), ("roughness", rough), ("metallic", metal),
                      ("normal", nrm)):
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(
            f"{base}_{name}.png")

    w, h = env_size
    el = (0.5 - (np.arange(h) + 0.5) / h) * np.pi                # row 0 = zenith
    az = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    sky = np.array([0.25, 0.45, 1.2]) + (np.array([1.1, 1.0, 0.9]) - np.array([0.25, 0.45, 1.2])) \
        * np.exp(-np.abs(el) * 4.0)[:, None]
    ground = np.array([0.25, 0.2, 0.15])
    env = np.where((el > 0)[:, None, None], sky[:, None, :], ground)[:, :, :] * np.ones((h, w, 3))
    sun_el, sun_az = 0.6, 0.8
    cosang = (np.sin(el)[:, None] * np.sin(sun_el)
              + np.cos(el)[:, None] * np.cos(sun_el) * np.cos(az[None, :] - sun_az))
    env += 40.0 * np.exp((cosang - 1.0) * 400.0)[:, :, None]
    exr = os.path.join(directory, "standin_env.exr")
    write_exr(exr, env.astype(np.float32), half=True)
    return base, exr


def standin_world(directory, level=5, tex_size=STANDIN_TEX, env_size=STANDIN_ENV,
                  seed=STANDIN_SEED, sphere=False):
    """The stand-in for the reference's character worlds, as a populated
    ``LegacyWorld`` (call ``build()``): ``_standin_mesh(level)``, its
    texture set and environment written to ``directory``, and optionally a
    glass-free sphere beside the figure (the GPU-vs-CPU world)."""
    from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld

    tex, exr = _standin_assets(directory, seed, tex_size, env_size)
    world = LegacyWorld()
    world.add_mesh(_standin_mesh(level, seed))
    if sphere:
        world.add_sphere((6.0, 3.0, -2.0), 3.0, transparency=0, texture_id=0)
    world.textures.add(tex, 0)
    world.environments.add(exr, 0, size=env_size)
    world.set_environment(0)
    return world


def _obj_rows(tag, rows, fmt):
    return "".join(f"{tag} {fmt % tuple(r)}\n" for r in rows.tolist())


def standin_asset_tree(root, level=5, tex_size=STANDIN_TEX, env_size=STANDIN_ENV,
                       seed=STANDIN_SEED, **base):
    """The stand-in as the reference's asset tree for ``stages.l15_module``
    under ``root``: ``models/Yoimiya/Yoimiya_ShapeChange.obj`` with its MTL
    (one material whose ``map_Kd`` names the PBR set ``standin``, the key
    ``io.obj.load_obj`` turns into a texture) and the set beside it, and
    ``textures/cayley_interior_2k.exr``. The OBJ holds ``_standin_mesh``
    mirrored in x and with v flipped, which l15's 180° turn, ``flip_z`` and
    ``flip_textcoord`` undo, so the stage's world is the stand-in's figure
    (``base``: ``_standin_mesh``'s tessellation of the base). Returns the
    OBJ's path."""
    import numpy as np

    model_dir = os.path.join(root, "models", "Yoimiya")
    tex_dir = os.path.join(root, "textures")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(tex_dir, exist_ok=True)
    _, exr = _standin_assets(model_dir, seed, tex_size, env_size)
    os.replace(exr, os.path.join(tex_dir, "cayley_interior_2k.exr"))
    mesh = _standin_mesh(level, seed, **base)
    mirror = np.array([-1.0, 1.0, 1.0], np.float32)
    uv = np.stack([mesh.uvs[:, 0], 1.0 - mesh.uvs[:, 1].astype(np.float64)], 1)
    faces = np.stack([mesh.face_p, mesh.face_t, mesh.face_n], -1) + 1     # [F, 3, 3]
    with open(os.path.join(model_dir, "Yoimiya_ShapeChange.mtl"), "w") as f:
        f.write("newmtl standin\nmap_Kd standin\n")
    path = os.path.join(model_dir, "Yoimiya_ShapeChange.obj")
    with open(path, "w") as f:
        f.write("mtllib Yoimiya_ShapeChange.mtl\n")
        f.write(_obj_rows("v", mesh.positions * mirror, "%.9g %.9g %.9g"))
        f.write(_obj_rows("vt", uv, "%.17g %.17g"))
        f.write(_obj_rows("vn", mesh.normals * mirror, "%.9g %.9g %.9g"))
        f.write("usemtl standin\n")
        f.write(_obj_rows("f", faces.reshape(-1, 9), "%d/%d/%d %d/%d/%d %d/%d/%d"))
    return path


def l14_camera(res):
    """The camera of ``stages.l14_mesh``."""
    from learn_path_tracing_tpu_torch.camera import LegacyCamera

    cam = LegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))
    return cam


def sphere_world():
    """8,192 seeded spheres (a tenth of them glass) in a 60-unit box: past
    the brute-scan ceiling, so ``build`` packs sphere tables for K3."""
    import numpy as np

    from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld

    rs = np.random.default_rng(STANDIN_SEED + 1)
    world = LegacyWorld()
    centers = rs.uniform(-30, 30, (N_SPHERES, 3)) + np.array([0.0, 8.0, 40.0])
    for c, r, glass in zip(centers, rs.uniform(0.2, 1.2, N_SPHERES),
                           rs.uniform(size=N_SPHERES) < 0.1):
        world.add_sphere(tuple(c), float(r), transparency=int(glass))
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    return world


def _build_quiet(world, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the sphere world's missing texture
        return world.build(**kw)


def traversal_sets(wd, tables, stack, leaf_kind, device, seed):
    """Ray sets for a packet-kernel check, at the mesh path's shapes:
    ``{name: (ro, rd, t_init, active)}``. The bounce set is traced with
    the plain twin, so it does not depend on the kernel under test. For
    triangle tables a fifth set, ``axis``, shoots exactly axis-parallel
    rays from outside the figure at surface points: v1's slab form hits
    them, the hoisted form of K2/K5b gives ``inf - inf`` and misses."""
    import torch

    from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_legacy
    from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels
    from learn_path_tracing_tpu_torch.core import rng
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.scene.legacy_world import shade_from_trace

    # the primary slab of render_hybrid's first chunk (pixel-major)
    n = MESH_RES[0] * MESH_RES[1]
    lanes = torch.arange(n * MESH_CHUNK, dtype=torch.int64, device=device)
    pixel, sample = lanes // MESH_CHUNK, lanes % MESH_CHUNK
    cam = l14_camera(MESH_RES).params(device)
    prim = generate_rays_for_pixels(cam, MESH_RES, pixel, 0, sample, model="jitter")
    inf = torch.full((prim.count,), float("inf"), device=device)
    sets = {"primary": (prim.ro, prim.rd, inf, prim.alive)}

    # first-bounce survivors
    t, p, _ = pt.packet_traverse_plain(*tables, prim.ro, prim.rd, inf, prim.alive,
                                       leaf_kind=leaf_kind, stack=stack)
    hit = p >= 0
    src = torch.where(hit, 1 if leaf_kind == "tri" else 0, -1).to(torch.int32)
    hits = shade_from_trace(wd, prim, torch.where(hit, t, float("inf")), p, src)
    base = rng.base(rng.stream(0, sample, 0, rng.STREAM_BSDF), pixel)
    bounce = scatter_legacy(prim, hits, base)
    sel = torch.nonzero(hit).squeeze(1)
    ro_b, rd_b = bounce.ro[sel].contiguous(), bounce.rd[sel].contiguous()
    sets["bounce1"] = (ro_b, rd_b, inf[sel], torch.ones_like(hit[sel]))

    # random rays with random t_init, half inactive; rays from the surface
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = TWIN_RAYS
    lo, hi = wd_bounds(tables)
    ro = lo + (hi - lo) * torch.rand((m, 3), generator=g) * 1.4 - 0.2 * (hi - lo)
    rd = torch.nn.functional.normalize(torch.randn((m, 3), generator=g), dim=-1)
    t_init = torch.where(torch.rand(m, generator=g) < 0.5,
                         torch.rand(m, generator=g) * float((hi - lo).norm()),
                         torch.tensor(float("inf")))
    active = torch.rand(m, generator=g) < 0.5
    sets["random"] = tuple(x.to(device) for x in (ro, rd, t_init, active))
    k = torch.randint(len(ro_b), (m,), generator=g).to(device)
    surf = hits.point[sel][k]
    rd_s = torch.nn.functional.normalize(torch.randn((m, 3), generator=g), dim=-1).to(device)
    ones = torch.ones_like(active, device=device)
    sets["surface"] = (surf.contiguous(), rd_s, inf[:m], ones)
    if leaf_kind == "tri":
        k = torch.randint(len(ro_b), (m,), generator=g).to(device)
        rd_a = torch.zeros((m, 3))
        rd_a[torch.arange(m), torch.randint(3, (m,), generator=g)] = torch.where(
            torch.rand(m, generator=g) < 0.5, -1.0, 1.0)
        rd_a = rd_a.to(device)
        ro_a = hits.point[sel][k] - rd_a * float((hi - lo).norm())
        sets["axis"] = (ro_a.contiguous(), rd_a, inf[:m], ones)
    return sets


def wd_bounds(tables):
    """Root box ``(lo, hi)`` of the traversal tables (CPU tensors)."""
    import torch

    root = tables[0][0].cpu()
    lo = torch.stack([root[d * 8:(d + 1) * 8].min() for d in range(3)])
    hi = torch.stack([root[(3 + d) * 8:(4 + d) * 8].max() for d in range(3)])
    return lo, hi


PACKET_ENTRIES = {   # kernels-line name and TPU kernel of each packet kernel
    "k2": ("packet_traverse_tri", "learn_path_tracing_tpu/ops/packet_traverse.py:390"),
    "k3": ("packet_traverse_sphere", "learn_path_tracing_tpu/ops/packet_traverse.py:390"),
    "k5a": ("packet_walk_v1", "learn_path_tracing_tpu/ops/packet_traverse.py:239"),
    "k5b": ("packet_walk_v3", "learn_path_tracing_tpu/ops/packet_traverse.py:733"),
}


def zero_launches():
    """Every kernel's launch count to 0 (``all_launches`` reads them)."""
    from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import row_gather as rg
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss

    ss.intersect_spheres_scan.launches = 0
    mk.bounce_pass.launches = 0
    pt.traverse.launches.update(dict.fromkeys(pt.traverse.launches, 0))
    rg.gather.launches.update(dict.fromkeys(rg.gather.launches, 0))


@contextlib.contextmanager
def shading_calls():
    """Counts the calls that launch the row gathers on the mesh path while
    the block runs: attribute blocks (``_attrs_block``, on at least one
    lane) and environment taps (``environment_color`` on at least one lane,
    off the sky-gradient closed form)."""
    import learn_path_tracing_tpu_torch.scene.legacy_world as lw

    counts = {"attrs": 0, "env": 0}
    attrs, env = lw._attrs_block, lw.environment_color

    def attrs_counted(world, point, *args):
        counts["attrs"] += point.shape[0] > 0
        return attrs(world, point, *args)

    def env_counted(world, rd, mask=None):
        counts["env"] += world.env_gradient_h is None and rd.shape[0] > 0
        return env(world, rd, mask=mask)

    lw._attrs_block, lw.environment_color = attrs_counted, env_counted
    try:
        yield counts
    finally:
        lw._attrs_block, lw.environment_color = attrs, env


def expected_gathers(wd, counts) -> dict:
    """Row-gather launches the shading ``counts`` imply on world ``wd``: an
    attribute block gathers the triangle-attribute row (K6a, mesh worlds),
    the atlas info row (K6a, multi-texture atlases only: one texture's row
    is broadcast) and the material pair row (K6b); an environment tap its
    info row (K6a, likewise) and its pair row (K6b)."""
    per_attrs = bool(wd.meshes) + (wd.atlas.info.shape[0] > 1)
    per_env = int(wd.envs.info.shape[0] > 1)
    return {"k6a": counts["attrs"] * per_attrs + counts["env"] * per_env,
            "k6b": counts["attrs"] + counts["env"]}


def check_packet(wd, tables, stack, leaf_kind, device, seed):
    """The packet kernels of ``leaf_kind`` against the plain twin on the
    card: K2, K5a and K5b for triangles (the twin with the version's slab
    form), K3 for spheres, bit for bit in ``(t, prim)`` on every set (and
    in the pops for K2/K3, whose pops are per ray like the twin's). Then
    each kernel is timed in turns in lane order and in coherence-sorted
    order on every set by CUDA events (the wrapper's read-back of the
    kernel's error word, one host round trip, included). Returns ``{kernel:
    kernels-line entry (without launches)}`` and ``device_times()``, to be
    called after the timed frames: every kernel's own time on every set and
    order from the profiler, beside its pops per ray (it sets each entry's
    ``device_ms``, the primary slab in lane order)."""
    import torch

    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt

    versions = (2, 1, 3) if leaf_kind == "tri" else (2,)
    kern = {v: pt.KERNELS[(leaf_kind, v)] for v in versions}
    sets = traversal_sets(wd, tables, stack, leaf_kind, device, seed)
    max_err = dict.fromkeys(versions, 0.0)
    for name, (ro, rd, t_init, active) in sets.items():
        plain, hit = {}, {}
        for v in versions:
            slab = pt.SLABS[v]
            if slab not in plain:
                plain[slab] = pt.packet_traverse_plain(*tables, ro, rd, t_init, active,
                                                       leaf_kind=leaf_kind, stack=stack,
                                                       slab=slab)
            t2, p2, it2 = plain[slab]
            t, p, it = pt.traverse(*tables, ro, rd, t_init, active, leaf_kind=leaf_kind,
                                   stack=stack, version=v)
            torch.cuda.synchronize()
            hit[v], hit_p = p >= 0, p2 >= 0
            both = hit[v] & hit_p
            err = float(torch.max(torch.abs(t[both] - t2[both]))) if bool(both.any()) else 0.0
            max_err[v] = max(max_err[v], err)
            same = (bitwise_equal(t, t2) and bitwise_equal(p, p2)
                    and (v != 2 or bitwise_equal(it, it2)))
            _log(f"[{kern[v]}] {name}: {ro.shape[0]} rays ({int(active.sum())} active), "
                 f"hit rate {float(hit[v].float().mean()):.4f}, pops per ray mean "
                 f"{float(it.float().mean()):.2f} max {int(it.max())} (the twin's per-ray "
                 f"walk: mean {float(it2.float().mean()):.2f}), bitwise equal (t, prim"
                 f"{', pops' if v == 2 else ''}): {same}, max |dt| {err:.3g}, hit/miss "
                 f"mismatches {int((hit[v] != hit_p).sum())}, prim mismatches "
                 f"{int((p != p2).sum())}")
            if not same:
                raise AssertionError(f"{kern[v]} differs from its twin on '{name}'")
        if name == "axis":
            gained = int((hit[1] & ~hit[2]).sum())
            _log(f"[axis] K5a hits {int(hit[1].sum())}, K2 {int(hit[2].sum())}, K5b "
                 f"{int(hit[3].sum())} of {ro.shape[0]}; K5a hits {gained} that K2 misses")
            if gained == 0:
                raise AssertionError("K5a hits no axis-parallel ray that K2 misses")

    # times in turns, lane order and coherence-sorted (the sort outside the timing)
    treelets = tuple(torch.as_tensor(x, device=device) for x in
                     pt.treelet_boxes(tables[0].cpu().numpy(), tables[1].cpu().numpy()))
    ms, ordered = {}, {}
    for name, rays in sets.items():
        order = torch.argsort(pt._coherence_key(tables[0], rays[0], rays[1], treelets),
                              stable=True)
        ordered[name] = (("lane", rays), ("sorted", tuple(x[order] for x in rays)))
        for kind, args in ordered[name]:
            cells = []
            for v in versions:
                ms[name, kind, v] = cuda_ms(lambda v=v, args=args: pt.traverse(
                    *tables, *args, leaf_kind=leaf_kind, stack=stack, version=v))
                pops = float(pt.traverse(*tables, *args, leaf_kind=leaf_kind, stack=stack,
                                         version=v)[2].float().mean())
                cells.append(f"{kern[v]} {ms[name, kind, v]:.4f} ms ({pops:.2f} pops/ray)")
            _log(f"[{leaf_kind} time] {name}, {rays[0].shape[0]} rays, {kind} order: "
                 f"{', '.join(cells)} (median of 20)")

    ro, rd, t_init, active = sets["primary"]
    n = ro.shape[0]
    out = {}
    for v in versions:
        slab = pt.SLABS[v]
        plain_ms = cuda_ms(lambda: pt.packet_traverse_plain(
            *tables, ro, rd, t_init, active, leaf_kind=leaf_kind, stack=stack, slab=slab))
        # the per-ray walk's pops on this set: 8 slab tests each (leaf tests
        # not counted); the tables read once, the rays and (t, prim, pops) once
        pops = int(pt.packet_traverse_plain(*tables, ro, rd, t_init, active, leaf_kind=leaf_kind,
                                            stack=stack, slab=slab)[2].sum())
        b = bound(nbytes(*tables, ro, rd, t_init, active) + 12 * n,
                  pops * 8 * SLAB_FLOP_PER_CHILD)
        _log(f"[{kern[v]}] time at {n} primary rays in lane order, {tables[0].shape[0]} "
             f"nodes, {tables[2].shape[0]} run rows: kernel {ms['primary', 'lane', v]:.4f} ms, "
             f"plain twin {plain_ms:.4f} ms (median of 20), bound {b['bound_ms']:.4f} ms "
             f"({b['bound_by']})")
        name, replaces = PACKET_ENTRIES[kern[v]]
        out[kern[v]] = {"name": name, "id": kern[v], "route": "cuda",
                        "source": "learn_path_tracing_tpu_torch/csrc/packet_traverse.cu",
                        "replaces": replaces, "max_abs_err": max_err[v],
                        "ms": ms["primary", "lane", v], "plain_ms": plain_ms, **b,
                        "library_ms": None}

    def device_times():
        for name, orders in ordered.items():
            for kind, args in orders:
                cells = []
                for v in versions:
                    dev_ms = kernel_ms(lambda v=v, args=args: pt.traverse(
                        *tables, *args, leaf_kind=leaf_kind, stack=stack, version=v),
                        TRAVERSAL_KERNEL_NAMES[v])
                    pops = float(pt.traverse(*tables, *args, leaf_kind=leaf_kind, stack=stack,
                                             version=v)[2].float().mean())
                    cells.append(f"{kern[v]} {dev_ms:.4f} ms ({pops:.2f} pops/ray)")
                    if (name, kind) == ("primary", "lane"):
                        out[kern[v]]["device_ms"] = dev_ms
                _log(f"[{leaf_kind} device] {name}, {args[0].shape[0]} rays, {kind} order: "
                     f"{', '.join(cells)} (profiler, median of 20)")
        for k, e in out.items():
            _log(f"[{k} device] {n} primary rays in lane order: {e['device_ms']:.4f} ms on "
                 f"the device against {e['ms']:.4f} ms by CUDA events, "
                 f"{e['bound_ms'] / e['device_ms']:.3f} of the bound")

    return out, device_times


def check_mesh_gpu_vs_cpu(device, directory):
    """render_hybrid of a small mesh + sphere world on the card and on the
    CPU, held to ``render_agreement``."""
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement

    # a directory of its own: the headline's world reloads its 1024² set and
    # EXR from ``directory`` by path
    directory = os.path.join(directory, "small")
    os.makedirs(directory, exist_ok=True)
    world = standin_world(directory, level=3, tex_size=256, env_size=(256, 128),
                          sphere=True)
    _build_quiet(world)
    cam = l14_camera(SMALL_RES)
    out = {}
    for dev in (device, "cpu"):
        img, segs = render_hybrid(world.device(dev), cam.params(dev), SMALL_RES,
                                  spp=SMALL_SPP, limit=SMALL_LIMIT)
        out[dev] = (img.cpu().numpy(), segs)
    rep = render_agreement(out[device][0], out["cpu"][0], out[device][1], out["cpu"][1])
    _log(f"[gpu-vs-cpu mesh] {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP} limit "
         f"{SMALL_LIMIT}: segments {out[device][1]} vs {out['cpu'][1]}, {rep}")
    if not rep["ok"]:
        raise AssertionError(f"GPU mesh render disagrees with the CPU render: {rep}")


def sphere_path(wd, device):
    """The K3 path: a hybrid render of the sphere world, counts from 0."""
    from learn_path_tracing_tpu_torch.camera import Camera
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt

    res = (320, 180)
    cam = Camera(res, fov=60)
    cam.set_position((0.0, 8.0, -10.0))
    cam.look_at((0.0, 8.0, 40.0))
    zero_launches()
    img, segs, st = render_hybrid(wd, cam.params(device), res, spp=4, limit=8, stats=True)
    launches = dict(pt.traverse.launches)
    _log(f"[sphere path] {res[0]}x{res[1]} spp 4 limit 8 over {N_SPHERES} spheres: "
         f"{segs} segments, {st['n_chunks']} slabs + {st['passes']} pool passes, "
         f"launches {launches}, image mean {float(img.mean()):.5f}")
    if launches.pop("k3") != st["n_chunks"] + st["passes"] or any(launches.values()):
        raise AssertionError(f"K3 launches != traversal calls {st['n_chunks'] + st['passes']}")
    return st["n_chunks"] + st["passes"]


def mesh_headline(world, device, directory):
    """The stand-in at 640x360, 64 spp, depth 32 through stages.l14_mesh
    under packet versions 2, 1 and 3, each after a warm-up, with the counts
    set to 0 just before each frame: the version's kernel is launched once
    per traversal call (slabs plus pool passes) and no other, the row
    gathers (K6a, K6b) as often as the frame's attribute blocks and
    environment taps imply (``expected_gathers``), and versions 1 and 3
    give version 2's segments and linear image bit for bit. Returns
    ``{kernel: launches}``, the row gathers' from each frame (equal in
    all three)."""
    import numpy as np
    import torch

    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import row_gather as rg
    from learn_path_tracing_tpu_torch.stages import l14_mesh

    from PIL import Image

    from learn_path_tracing_tpu_torch.io.exr import read_exr

    path = os.path.join(directory, "standin.world.npy")
    world.save(path)
    sizes = {n: Image.open(os.path.join(directory, f"standin_{n}.png")).size
             for n in ("albedo", "roughness", "metallic", "normal")}
    env_hw = read_exr(os.path.join(directory, "standin_env.exr")).shape[:2]
    if (set(sizes.values()) != {(STANDIN_TEX, STANDIN_TEX)}
            or tuple(env_hw) != STANDIN_ENV[::-1]):
        raise AssertionError(f"the stand-in's assets on disk are not full size: "
                             f"{sizes}, EXR {env_hw}")
    out, ref = {}, None
    for v in (2, 1, 3):
        kernel = pt.KERNELS["tri", v]
        t0 = time.time()
        render_hybrid(world.device(device, packet_version=v), l14_camera(MESH_RES).params(device),
                      MESH_RES, spp=MESH_CHUNK, limit=MESH_DEPTH, seed=-1)
        torch.cuda.synchronize()
        _log(f"[mesh headline v{v}] warm-up (spp {MESH_CHUNK}) {time.time() - t0:.2f} s")

        zero_launches()
        with shading_calls() as shading:
            frame, rep = l14_mesh.main([
                "--world", path, "--width", str(MESH_RES[0]), "--height", str(MESH_RES[1]),
                "--spp", str(MESH_SPP), "--limit", str(MESH_DEPTH), "--device", device,
                "--packet-version", str(v),
                "--out", f"outputs/chip_smoke_l14_standin{'' if v == 2 else f'_v{v}'}.png"])
        launches = dict(pt.traverse.launches)
        gathers = dict(rg.gather.launches)
        expected = expected_gathers(world.device(device), shading)
        calls = rep["n_chunks"] + rep["passes"]
        arr = frame.cpu().numpy()
        mean = float(arr.mean())
        _log(f"[mesh headline v{v}] {MESH_RES[0]}x{MESH_RES[1]} spp {MESH_SPP} depth "
             f"{MESH_DEPTH}: {rep['seconds']:.3f} s, {rep['segments']} segments, "
             f"{rep['mrays']:.3f} Mrays/s, primary hit fraction "
             f"{rep['primary_hit_fraction']:.4f}, slabs {rep['n_chunks']} (chunk_spp "
             f"{rep['chunk_spp']}), pool {rep['pool_w']} lanes, cap {rep['cap']}, "
             f"passes_by_width {rep['passes_by_width']}, launches {launches}, row gathers "
             f"{gathers} for {shading['attrs']} attribute blocks and {shading['env']} "
             f"environment taps, frame mean {mean:.5f}, load warnings "
             f"{len(rep['load_warnings'])}, sky-gradient fallback {rep['env_gradient']}")
        if launches.pop(kernel) != calls or any(launches.values()):
            raise AssertionError(f"{kernel} launches != traversal calls {calls}, or "
                                 f"another kernel ran: {pt.traverse.launches}")
        if gathers != expected or not all(gathers.values()):
            raise AssertionError(f"row-gather launches {gathers}, expected {expected}")
        if rep["load_warnings"] or rep["env_gradient"]:
            raise AssertionError(f"the stand-in's textures or EXR fell back: "
                                 f"{rep['load_warnings']}, sky gradient {rep['env_gradient']}")
        if not np.isfinite(arr).all() or not 0.02 < mean < 10.0:
            raise AssertionError(f"mesh headline image is not sane: mean {mean}")
        if ref is None:
            ref = rep
        else:
            same = (rep["segments"] == ref["segments"]
                    and bitwise_equal(rep["linear"], ref["linear"]))
            _log(f"[mesh headline v{v}] segments and linear image bit for bit those of "
                 f"version 2 ({ref['seconds']:.3f} s): {same}")
            if not same:
                raise AssertionError(f"the version-{v} frame differs from version 2's")
        out[kernel] = calls
        for k, n in gathers.items():
            if out.setdefault(k, n) != n:
                raise AssertionError(f"{k} launches differ between versions: {n} vs {out[k]}")
    return out


def viewer_wavefront(world, device):
    """The viewer cell (640x360, 8 spp, depth 10): a ProgressiveRenderer
    frame of the hybrid engine, then one of ``engine='wavefront'`` under
    each packet version (``hit_legacy`` per bounce pass, so K2, K5a or K5b),
    each held to the hybrid frame by ``render_agreement``, with the row
    gathers launched as its shading calls imply."""
    import torch

    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import row_gather as rg
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement
    from learn_path_tracing_tpu_torch.viewer.progressive import ProgressiveRenderer

    def frame(engine, v):
        wd = world.device(device, packet_version=v)
        pr = ProgressiveRenderer(wd, l14_camera(VIEWER_RES), VIEWER_RES,
                                 spp_per_frame=VIEWER_SPP, limit=VIEWER_DEPTH,
                                 camera_model="jitter", engine=engine)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with shading_calls() as shading:
            pr.render(moved=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        img = (pr.acc / pr.spp).reshape(VIEWER_RES[0], VIEWER_RES[1], 3).cpu().numpy()
        gathers = dict(rg.gather.launches)
        if gathers != expected_gathers(wd, shading) or not all(gathers.values()):
            raise AssertionError(f"row-gather launches {gathers} for {shading}")
        return img, pr.last_stats["segments"], seconds, dict(pt.traverse.launches), gathers

    ref = frame("hybrid", 2)
    _log(f"[viewer] hybrid v2 {VIEWER_RES[0]}x{VIEWER_RES[1]} spp {VIEWER_SPP} depth "
         f"{VIEWER_DEPTH}: {ref[2]:.3f} s, {ref[1]} segments, launches {ref[3]}, row "
         f"gathers {ref[4]}")
    for v in (2, 1, 3):
        kernel = pt.KERNELS["tri", v]
        img, segs, seconds, launches, gathers = frame("wavefront", v)
        rep = render_agreement(img, ref[0], segs, ref[1])
        _log(f"[viewer] wavefront v{v}: {seconds:.3f} s, {segs} segments, launches "
             f"{launches}, row gathers {gathers}; against the hybrid frame: {rep}")
        if not rep["ok"] or not launches.pop(kernel) or any(launches.values()):
            raise AssertionError(f"the wavefront frame (v{v}) fails: {rep}, {launches}")


# ------------------------------------------- the row gathers (K6a, K6b) --

# scripts/profile_gather2.py's shapes: 226 blocks of 1,024 indices into the
# Yoimiya frame's triangle-attribute table and its strip-packed material atlas
GATHER_N = 231424
GATHER_TRI = (23425, 32)          # f32, 128-byte rows: K6a
GATHER_ATLAS = (1122305, 256)     # bf16, 512-byte rows (575 MB): K6b
GATHER_ENTRIES = {   # kernels-line name and TPU kernel of each row gather
    "k6a": ("row_gather_narrow", "scripts/profile_gather2.py:64"),
    "k6b": ("row_gather_wide", "scripts/profile_gather2.py:99"),
}


def standin_gather_sets(wd, device):
    """The stand-in world's four gathered tables, each with the indices of
    one shading call of the l14 headline (``{name: (table, idx)}``): the
    first triangle-attribute, material pair-row and environment pair-row
    gathers of a one-slab ``render_hybrid`` (the survivor batch's
    attribute block and phase A's escape tap over the whole slab), and the
    atlas info table with the texture ids of the attribute call's lanes
    (what a multi-texture world gathers; the stand-in's one texture row is
    broadcast instead)."""
    import learn_path_tracing_tpu_torch.io.texture as tx
    import learn_path_tracing_tpu_torch.scene.legacy_world as lw
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid

    first = {}
    real = lw.gather

    def record(tab, idx):
        first.setdefault(tab.data_ptr(), (tab, idx.clone()))
        return real(tab, idx)

    lw.gather = tx.gather = record
    try:
        render_hybrid(wd, l14_camera(MESH_RES).params(device), MESH_RES, spp=MESH_CHUNK,
                      limit=2, seed=0)
    finally:
        lw.gather = tx.gather = real
    sets = {name: first[tab.data_ptr()] for name, tab in (
        ("tri_attr", wd.tri_attr), ("material pairs", wd.atlas.table),
        ("environment pairs", wd.envs.table))}
    tab, idx = sets["tri_attr"]
    sets["info"] = (wd.atlas.info, tab[idx.long(), 24].long())
    return sets


def fill_set(tab, device, seed):
    """Indices into ``tab`` of every kind: in range, wrapping (``[-R, 0)``),
    past either end, and the int32 extremes."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = tab.shape[0]
    idx = torch.randint(-3 * rows, 3 * rows, (4096,), generator=g)
    idx[:4] = torch.tensor([-2**31, 2**31 - 1, -rows - 1, rows])
    return idx.to(device)


def gather_bound(tab, idx) -> dict:
    """``bound()`` of a row gather: each distinct table row that the
    indices name read once, each output row written once, the indices read
    once; no arithmetic."""
    import torch

    rows = tab.shape[0]
    r = torch.where(idx < 0, idx + rows, idx)
    distinct = torch.unique(r[(r >= 0) & (r < rows)]).numel()
    row_bytes = tab.shape[1] * tab.element_size()
    return bound((distinct + idx.numel()) * row_bytes + nbytes(idx), 0)


def check_row_gather(wd, device):
    """K6a and K6b against their plain version on the card, bit for bit
    (bf16 and NaN fill rows compared as bits): at ``profile_gather2.py``'s
    shapes (random and sorted indices), on the stand-in's four tables
    with one headline shading call's indices, and on every table with
    wrapping and out-of-range indices in int32 and int64. Then the kernel,
    ``torch.index_select`` (the library call, in-range sets) and the plain
    version are timed in turns. Returns ``{kernel: kernels-line entry
    (without launches)}`` at the main path's shapes (the stand-in's
    triangle-attribute and material pair-row calls) and ``device_times()``,
    to be called after the timed frames: each kernel's own time on every
    set from the profiler (it sets each entry's ``device_ms``)."""
    import torch

    from learn_path_tracing_tpu_torch.ops import row_gather as rg

    g = torch.Generator(device=device).manual_seed(5)
    tri = torch.randn(GATHER_TRI, generator=g, device=device)
    atlas = torch.randn(GATHER_ATLAS, generator=g, device=device).to(torch.bfloat16)
    idx_tri = torch.randint(GATHER_TRI[0], (GATHER_N,), generator=g, device=device,
                            dtype=torch.int32)
    idx_atl = torch.randint(GATHER_ATLAS[0], (GATHER_N,), generator=g, device=device,
                            dtype=torch.int32)
    sets = {"script tri_attr f32[23425,32]": (tri, idx_tri),
            "script atlas bf16[1122305,256]": (atlas, idx_atl),
            "script atlas, sorted indices": (atlas, torch.sort(idx_atl).values)}
    sets.update({f"stand-in {k}": v for k, v in standin_gather_sets(wd, device).items()})

    def same(tab, idx):
        got, ref = rg.gather(tab, idx), rg.gather_plain(tab, idx)
        torch.cuda.synchronize()
        bits = torch.int16 if tab.dtype == torch.bfloat16 else torch.int32
        return bool(torch.equal(got.view(bits), ref.view(bits)))

    for i, (name, (tab, idx)) in enumerate(list(sets.items())):
        exact = same(tab, idx)
        fills = [same(tab, fill_set(tab, device, i).to(t)) for t in (torch.int32, torch.int64)]
        _log(f"[{rg.kernel_for(tab)}] {name}: {idx.numel()} rows of "
             f"{tab.shape[1] * tab.element_size()} B from {tab.shape[0]} ({tab.dtype}, "
             f"{idx.dtype}), bitwise equal: {exact}; fill set (int32, int64): {fills}")
        if not exact or not all(fills):
            raise AssertionError(f"the row gather differs from its plain version on '{name}'")

    out = {}
    main_sets = {"k6a": "stand-in tri_attr", "k6b": "stand-in material pairs"}
    for name, (tab, idx) in sets.items():
        kernel = rg.kernel_for(tab)
        ms = cuda_ms(lambda: rg.gather(tab, idx))
        lib_ms = cuda_ms(lambda: torch.index_select(tab, 0, idx))
        plain_ms = cuda_ms(lambda: rg.gather_plain(tab, idx))
        b = gather_bound(tab, idx)
        _log(f"[{kernel} time] {name}: kernel {ms:.4f} ms, index_select {lib_ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms (median of 20 each), "
             f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
             f"{idx.numel() / ms / 1e6:.1f} M rows/s")
        if main_sets[kernel] == name:
            label, replaces = GATHER_ENTRIES[kernel]
            out[kernel] = {"name": label, "id": kernel, "route": "cuda",
                           "source": "learn_path_tracing_tpu_torch/csrc/row_gather.cu",
                           "replaces": replaces, "max_abs_err": 0.0, "ms": ms,
                           "plain_ms": plain_ms, **b, "library_ms": lib_ms}

    def device_times():
        for name, (tab, idx) in sets.items():
            kernel = rg.kernel_for(tab)
            dev_ms = kernel_ms(lambda: rg.gather(tab, idx), GATHER_KERNEL_NAMES[kernel])
            b = gather_bound(tab, idx)
            _log(f"[{kernel} device] {name}: {dev_ms:.4f} ms on the device (profiler, median "
                 f"of 20), {b['bound_ms'] / dev_ms:.3f} of the bound")
            if main_sets[kernel] == name:
                out[kernel]["device_ms"] = dev_ms

    return out, device_times


# --------------------------------------------------------- stage l13 --

def l13_assets(directory):
    """The stand-in's texture set and EXR (in ``directory``) under the
    names the l13 scene asks for, ``<directory>/textures/sandyground1_*.png``
    and ``cayley_interior_2k.exr``, as symbolic links."""
    tex = os.path.join(directory, "textures")
    os.makedirs(tex, exist_ok=True)
    links = {f"sandyground1_{n}.png": f"standin_{n}.png"
             for n in ("albedo", "roughness", "metallic", "normal")}
    links["cayley_interior_2k.exr"] = "standin_env.exr"
    for name, target in links.items():
        os.symlink(os.path.join(directory, target), os.path.join(tex, name))


def l13_phase(device, directory):
    """Stage l13 (one textured sphere under the environment, the wavefront
    integrator) on the stand-in's assets: at the viewer cell's shape
    (640x360, 8 spp, depth 10) on the card with the counts set to 0 just
    before, checking that the row gathers ran as its shading calls imply
    and that both assets loaded; then at 64x36 on the card and on the CPU,
    held to ``render_agreement``. Returns the card frame's report."""
    import numpy as np

    from learn_path_tracing_tpu_torch.ops import row_gather as rg
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
    from learn_path_tracing_tpu_torch.stages import l13_texture
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement

    l13_assets(directory)
    common = ["--assets", directory, "--spp", str(VIEWER_SPP), "--limit", str(VIEWER_DEPTH)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # the PBR set and the EXR must load
        zero_launches()
        ss.intersect_spheres_scan.launches = 0
        with shading_calls() as shading:
            _, rep = l13_texture.main(common + [
                "--width", str(VIEWER_RES[0]), "--height", str(VIEWER_RES[1]),
                "--device", device, "--out", "outputs/chip_smoke_l13.png"])
        gathers, scans = dict(rg.gather.launches), ss.intersect_spheres_scan.launches
        small = {dev: l13_texture.main(common + [
            "--width", str(SMALL_RES[0]), "--height", str(SMALL_RES[1]), "--device", dev,
            "--out", f"outputs/chip_smoke_l13_small_{dev}.png"])[1] for dev in (device, "cpu")}
    lin = rep["linear"].cpu().numpy()
    mean = float(lin.mean())
    expected = expected_gathers(rep["world"], shading)
    agree = render_agreement(small[device]["linear"].cpu().numpy(), small["cpu"]["linear"].numpy(),
                             small[device]["segments"], small["cpu"]["segments"])
    _log(f"[l13] {VIEWER_RES[0]}x{VIEWER_RES[1]} spp {VIEWER_SPP} depth {VIEWER_DEPTH}: "
         f"{rep['seconds']:.3f} s, {rep['segments']} segments, {rep['mrays']:.3f} Mrays/s, "
         f"row gathers {gathers} for {shading['attrs']} attribute blocks and "
         f"{shading['env']} environment taps, sphere-scan launches {scans}, image mean "
         f"{mean:.5f}, sky-gradient fallback {rep['env_gradient']}; {SMALL_RES[0]}x"
         f"{SMALL_RES[1]} card vs CPU: segments {small[device]['segments']} vs "
         f"{small['cpu']['segments']}, {agree}")
    if rep["env_gradient"] or gathers != expected or not gathers["k6b"]:
        raise AssertionError(f"l13: sky gradient {rep['env_gradient']}, row gathers "
                             f"{gathers}, expected {expected}")
    if not np.isfinite(lin).all() or not 0.02 < mean < 10.0:
        raise AssertionError(f"l13 image is not sane: mean {mean}")
    if not agree["ok"]:
        raise AssertionError(f"the l13 card render disagrees with the CPU render: {agree}")
    return rep


# ------------------------------ the bench's mesh cell, l11, l12 and l15 --

def bench_standin(world, device, path):
    """The bench's mesh cell on the stand-in's ``.world.npy`` (``path``):
    ``bench_torch.run_cell(scene='yoimiya', world=path)`` at the bench's
    1280x720, 64 spp, depth 32 through the hybrid engine, three frames after
    its spp-1 warm-up, with the counts set to 0 just before: K2 launches
    once per traversal call of every render (slabs plus pool passes) and no
    other traversal kernel runs; K6a and K6b as often as the shading calls
    imply. Prints the row as the CLI does; returns ``{kernel: launches}``."""
    import numpy as np

    import bench_torch
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import row_gather as rg

    zero_launches()
    with shading_calls() as shading:
        row = bench_torch.run_cell(scene="yoimiya", world=path, resolution=RES, spp=SPP,
                                   limit=DEPTH, device=device)
    launches, gathers = dict(pt.traverse.launches), dict(rg.gather.launches)
    print(bench_torch.row_line(row), flush=True)
    expected = expected_gathers(world.device(device), shading)
    mean = float(row["image"].mean())
    _log(f"[bench stand-in] {row['metric']}: frames {row['frames']} s, {row['segments']} "
         f"segments, {row['value']:.3f} Mrays/s, traversal calls {row['calls']} (warm-up, "
         f"frames), launches {launches}, row gathers {gathers} for {shading['attrs']} attribute "
         f"blocks and {shading['env']} environment taps, linear mean {mean:.5f}")
    if row["metric"] != "bvh_mrays_per_sec_chip_standin" or row["engine"] != "hybrid":
        raise AssertionError(f"the stand-in cell ran as {row['metric']}, {row['engine']}")
    if launches.pop("k2") != sum(row["calls"]) or any(launches.values()):
        raise AssertionError(f"K2 launches != traversal calls {row['calls']}, or another "
                             f"kernel ran: {pt.traverse.launches}")
    if gathers != expected or not all(gathers.values()):
        raise AssertionError(f"row-gather launches {gathers}, expected {expected}")
    if not np.isfinite(row["image"].cpu().numpy()).all() or not 0.02 < mean < 10.0:
        raise AssertionError(f"the stand-in cell's image is not sane: mean {mean}")
    return {"k2": sum(row["calls"]), **gathers}


@contextlib.contextmanager
def hit_calls():
    """Counts ``scene.world.hit`` calls (one per wavefront bounce pass of a
    sphere world) while the block runs."""
    import learn_path_tracing_tpu_torch.scene.world as world_mod

    counts = [0]
    real = world_mod.hit

    def counted(*args, **kw):
        counts[0] += 1
        return real(*args, **kw)

    world_mod.hit = counted
    try:
        yield counts
    finally:
        world_mod.hit = real


def stage10_cli(device):
    """``python -m learn_path_tracing_tpu_torch render --stage 10`` in this
    process (``__main__.main``) at 64x36, spp 4, limit 8: the stage entry
    ``stages.common.run_path_traced`` (chunks, accumulation, post-process,
    PNG) on the card, with the counts set to 0 just before: one K1 launch
    per hit call (the report's passes), no K3; then the same command with
    ``--device cpu``, whose linear image and segments the card's must match
    by ``render_agreement``. Returns K1's launches."""
    import numpy as np

    from learn_path_tracing_tpu_torch import __main__ as cli
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
    from learn_path_tracing_tpu_torch.stages import s10_final
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement

    small = ["--width", str(SMALL_RES[0]), "--height", str(SMALL_RES[1]), "--spp",
             str(SMALL_SPP), "--limit", str(SMALL_LIMIT)]
    reps, real = [], s10_final.run_path_traced

    def kept(*args, **kw):          # the stage's report, which the CLI drops
        out = real(*args, **kw)
        reps.append(out[1])
        return out

    s10_final.run_path_traced = kept
    try:
        zero_launches()
        ss.intersect_spheres_scan.launches = 0
        with hit_calls() as calls:
            rc = cli.main(["render", "--stage", "10", *small, "--device", device,
                           "--out", "outputs/chip_smoke_s10.png"])
        k1, k3 = ss.intersect_spheres_scan.launches, pt.traverse.launches["k3"]
        rc_cpu = cli.main(["render", "--stage", "10", *small, "--device", "cpu",
                           "--out", "outputs/chip_smoke_s10_cpu.png"])
    finally:
        s10_final.run_path_traced = real
    (card, cpu) = reps
    agree = render_agreement(card["linear"].cpu().numpy(), cpu["linear"].numpy(),
                             card["segments"], cpu["segments"])
    _log(f"[stage 10 cli] render --stage 10 at {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP} "
         f"limit {SMALL_LIMIT}: exit codes {rc} (card), {rc_cpu} (cpu); {card['segments']} "
         f"segments, passes {card['passes']}, hit calls {calls[0]}, K1 launches {k1}, K3 "
         f"launches {k3}; against the CPU: {agree}")
    if rc or rc_cpu or k1 != calls[0] or k1 != card["passes"] or not k1 or k3:
        raise AssertionError(f"stage 10 through the CLI: exit codes {rc}, {rc_cpu}, K1 "
                             f"launches {k1}, hit calls {calls[0]}, K3 launches {k3}")
    if not agree["ok"] or not np.isfinite(card["linear"].cpu().numpy()).all():
        raise AssertionError(f"stage 10 on the card disagrees with the CPU: {agree}")
    return k1


def l11_twins(device, res=(640, 360)):
    """K1 and K3 held to their plain twins at l11's shapes, on l11's world
    (485 spheres on the r = 10,000 ground): the primary rays of orbit frame 0
    at ``res`` (230,400 at the preset's 640x360; sample 0) and the first bounce pass that follows
    them (the legacy BSDF scattered from the twin's hits, so this set does
    not depend on the kernels under test). K1 (``intersect_spheres_scan``)
    bitwise against ``intersect_spheres_scan_plain`` in ``(t, idx, attr)``;
    ``hit(backend='bvh')`` (K3) bitwise against the hit record of
    ``packet_traverse_plain`` over the same tables."""
    import torch

    from learn_path_tracing_tpu_torch.bsdf.bsdf import SCATTERERS
    from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels, pixel_grid
    from learn_path_tracing_tpu_torch.core import rng
    from learn_path_tracing_tpu_torch.core.pytree import tree_where
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
    from learn_path_tracing_tpu_torch.scene.world import hit, hit_record
    from learn_path_tracing_tpu_torch.stages import l11_bvh

    wd = l11_bvh.legacy_random_scene().device(device, use_bvh=True)
    pix = pixel_grid(res, device)
    rays = generate_rays_for_pixels(l11_bvh.orbit_camera(res, 0).params(device), res, pix, 0, 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    table, attrs = wd.scan_table, wd.scan_attrs
    for name in ("primary", "bounce1"):
        n = rays.count
        ro, rd = rays.ro.contiguous(), rays.rd.contiguous()
        scan = ss.intersect_spheres_scan(ro, rd, table, attrs)
        scan_plain = ss.intersect_spheres_scan_plain(ro, rd, table, attrs)
        walk = hit(wd, rays, backend="bvh")
        t, prim, _ = pt.packet_traverse_plain(
            *wd.bvh, ro, rd, torch.full((n,), float("inf"), device=device),
            torch.ones((n,), dtype=torch.bool, device=device), eps=ss.T_MIN,
            leaf_kind="sphere", stack=wd.bvh_stack)
        prim = torch.clamp_min(prim, 0)
        walk_plain = hit_record(rays, t, prim, attrs[prim.to(torch.int64)])
        torch.cuda.synchronize()
        same = {"k1": all(bitwise_equal(a, b) for a, b in zip(scan, scan_plain)),
                "k3": all(bitwise_equal(getattr(walk, f), getattr(walk_plain, f))
                          for f in ("t", "obj", "hit", "point", "normal"))}
        _log(f"[l11 twins] {name}: {n} rays, K1 slices {ss.team_slices(n, table.shape[0], sms)} "
             f"over {table.shape[0]} padded spheres, hit rate "
             f"{float(torch.isfinite(scan[0]).float().mean()):.4f}; bitwise equal to the "
             f"twin: K1 {same['k1']}, hit(backend='bvh') (K3) {same['k3']}")
        if not all(same.values()):
            raise AssertionError(f"l11 '{name}': a kernel differs from its twin: {same}")
        if name == "primary":       # the first bounce, as trace_sample_pixels makes it
            base = rng.base(rng.stream(0, 0, 0, rng.STREAM_BSDF), pix.to(torch.int64))
            scattered = SCATTERERS["legacy"](rays, walk_plain, base)
            survived = rays.alive & walk_plain.hit
            rays = tree_where(survived, scattered, rays).with_alive(survived)


def l11_phase(device):
    """Stage l11 at its preset (640x360, 128 spp, depth 10, the first orbit
    frame), once under ``--hit-backend auto`` and once under ``bvh``, with
    the counts set to 0 just before each: under 'auto' K1 launches once per
    hit call and K3 not at all, under 'bvh' the reverse; the two frames are
    bit for bit equal. First, K1 and K3 against their twins at the stage's
    shapes (``l11_twins``). Returns ``{kernel: launches}``."""
    import numpy as np

    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
    from learn_path_tracing_tpu_torch.stages import l11_bvh

    l11_twins(device)
    reps, out = {}, {}
    for backend, kernel in (("auto", "k1"), ("bvh", "k3")):
        zero_launches()
        ss.intersect_spheres_scan.launches = 0
        with hit_calls() as calls:
            _, reps[backend] = l11_bvh.main(["--hit-backend", backend, "--device", device,
                                             "--out", f"outputs/chip_smoke_l11_{backend}.png"])
        got = {"k1": ss.intersect_spheres_scan.launches, "k3": pt.traverse.launches["k3"]}
        others = {k: n for k, n in pt.traverse.launches.items() if k != "k3" and n}
        rep = reps[backend]
        mean = float(rep["linear"].mean())
        _log(f"[l11 {backend}] 640x360 spp 128 depth 10: {rep['seconds']:.3f} s, "
             f"{rep['segments']} segments, {rep['mrays']:.3f} Mrays/s, hit calls {calls[0]}, "
             f"launches {got}, linear mean {mean:.5f}")
        if got != {kernel: calls[0], ("k3" if kernel == "k1" else "k1"): 0} or others:
            raise AssertionError(f"l11 {backend}: launches {got} {others}, hit calls {calls[0]}")
        if not np.isfinite(rep["linear"].cpu().numpy()).all() or not 0.02 < mean < 10.0:
            raise AssertionError(f"the l11 frame is not sane: mean {mean}")
        out[kernel] = calls[0]
    same = (reps["auto"]["segments"] == reps["bvh"]["segments"]
            and bitwise_equal(reps["auto"]["linear"], reps["bvh"]["linear"]))
    _log(f"[l11] the 'bvh' frame bit for bit the 'auto' frame: {same}")
    if not same:
        raise AssertionError("l11's 'bvh' frame differs from its 'auto' frame")
    return out


def l12_phase(device):
    """Stage l12 at its preset (640x360, 128 spp a keyframe, depth 10) on
    the script ``w,.,.``, with the counts set to 0 just before: K3 launches
    once per hit call and K1 not at all, the spp resets on the move and
    accumulates on the holds (128, 256, 384), the frame is finite; the
    run's peak device memory above what was allocated before it is logged.
    Returns K3's launches."""
    import torch

    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
    from learn_path_tracing_tpu_torch.stages import l12_free_view

    zero_launches()
    ss.intersect_spheres_scan.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # what earlier phases still hold
    t0 = time.perf_counter()
    with hit_calls() as calls:
        frame, rep = l12_free_view.main(["--script", "w,.,.", "--device", device])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    k1, launches = ss.intersect_spheres_scan.launches, dict(pt.traverse.launches)
    _log(f"[l12] 640x360, 128 spp a keyframe, depth 10, script w,.,.: {seconds:.3f} s, spp "
         f"{rep['spp']}, hit calls {calls[0]}, launches {launches}, K1 launches {k1}, peak "
         f"device memory {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held "
         f"before, frame mean {float(frame.mean()):.5f}")
    if launches.pop("k3") != calls[0] or any(launches.values()) or k1:
        raise AssertionError(f"l12: K3 launches != hit calls {calls[0]}, or another kernel ran")
    if rep["spp"] != [128, 256, 384] or not bool(torch.isfinite(frame).all()):
        raise AssertionError(f"l12: spp {rep['spp']}, or the frame is not finite")
    return calls[0]


def l15_phase(device, directory):
    """Stage l15 at its preset (1500x1000, 32 spp, one pass) on the stand-in
    written as the reference's asset tree (``standin_asset_tree``: OBJ,
    MTL, PBR set, EXR), with the counts set to 0 just before: K2 launches
    once per traversal call, K6a and K6b as the shading calls imply, the
    image finite with a sane mean (``outputs/chip_smoke_l15.png``). Then its
    saved ``.world.npy`` reloads with ``rebuild_bvh=False`` and renders the
    64x36 check cell within ``render_agreement`` of the rebuilt world's.
    Returns ``{kernel: launches}``."""
    import numpy as np

    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import row_gather as rg
    from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu_torch.stages import l15_module
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map
    from learn_path_tracing_tpu_torch.utils.checks import render_agreement

    root = os.path.join(directory, "l15_assets")
    t0 = time.time()
    standin_asset_tree(root)
    _log(f"[l15] stand-in asset tree written in {time.time() - t0:.2f} s")
    zero_launches()
    with warnings.catch_warnings(), shading_calls() as shading:
        warnings.simplefilter("error")             # every asset must load
        frame, rep = l15_module.main(["--assets", root, "--passes", "1", "--device", device,
                                      "--out", "outputs/chip_smoke_l15.png"])
    launches, gathers = dict(pt.traverse.launches), dict(rg.gather.launches)
    path_map = make_asset_path_map(root)
    t0 = time.time()
    own = LegacyWorld().load(rep["world"], path_map=path_map, rebuild_bvh=False, device=device)
    load_s = time.time() - t0
    expected = expected_gathers(own, shading)
    calls = rep["n_chunks"] + rep["passes"]
    mean = float(rep["linear"].mean())
    _log(f"[l15] 1500x1000 spp 32, one pass: {rep['seconds']:.3f} s, {rep['segments']} "
         f"segments, {rep['mrays']:.3f} Mrays/s, slabs {rep['n_chunks']} + pool passes "
         f"{rep['passes']}, launches {launches}, row gathers {gathers} for {shading['attrs']} "
         f"attribute blocks and {shading['env']} environment taps, linear mean {mean:.5f}; "
         f"the saved world reloaded with its own trees in {load_s:.2f} s "
         f"({own.meshes[0].packet[0].shape[0]} wide nodes, stack {own.meshes[0].stack})")
    if launches.pop("k2") != calls or any(launches.values()):
        raise AssertionError(f"l15: K2 launches != traversal calls {calls}: {pt.traverse.launches}")
    if gathers != expected or not all(gathers.values()):
        raise AssertionError(f"l15: row-gather launches {gathers}, expected {expected}")
    if not np.isfinite(rep["linear"].cpu().numpy()).all() or not 0.02 < mean < 10.0:
        raise AssertionError(f"the l15 image is not sane: mean {mean}")

    rebuilt = LegacyWorld().load(rep["world"], path_map=path_map, device=device)
    cam = l14_camera(SMALL_RES).params(device)
    (a, sa), (b, sb) = (render_hybrid(wd, cam, SMALL_RES, spp=SMALL_SPP, limit=SMALL_LIMIT)
                        for wd in (own, rebuilt))
    agree = render_agreement(a.cpu().numpy(), b.cpu().numpy(), sa, sb)
    _log(f"[l15] {SMALL_RES[0]}x{SMALL_RES[1]} spp {SMALL_SPP} limit {SMALL_LIMIT}, the file's "
         f"trees against the rebuilt world: segments {sa} vs {sb}, {agree}")
    if not agree["ok"]:
        raise AssertionError(f"the reloaded l15 world disagrees with the rebuilt one: {agree}")
    return {"k2": calls, **gathers}


def cli_smoke():
    """``python -m learn_path_tracing_tpu_torch smoke`` as a subprocess from
    the checkout's root; it must exit 0."""
    proc = subprocess.run([sys.executable, "-m", "learn_path_tracing_tpu_torch", "smoke"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=120)
    _log(f"[cli smoke] exit code {proc.returncode}: {(proc.stdout + proc.stderr).strip()}")
    if proc.returncode != 0:
        raise AssertionError("python -m learn_path_tracing_tpu_torch smoke failed")


# ------------------------ the native builder, multi-device, the viewer --

MC_PERSISTENT_SPP = 8                  # the sharded cover-scene cell: spp cut from 64
MC_WAVEFRONT_RES, MC_WAVEFRONT_SPP = (320, 180), 4


def native_bvh_phase():
    """``[native bvh]``: the stand-in mesh's BVH (23,424 triangles, the mesh
    build's depth 24 and leaves of 8) once with each builder (the C++
    library was built with the kernels); the arrays must be equal byte for
    byte. Prints both build times; returns them."""
    from learn_path_tracing_tpu_torch.accel.bvh import build_bvh

    mesh = _standin_mesh(5, STANDIN_SEED)
    tri = mesh.positions[mesh.face_p]
    args = (tri.min(axis=1), tri.max(axis=1))
    kw = dict(centroid=tri.mean(axis=1), max_depth=24, max_leaf=8)
    out, trees = {}, {}
    for backend in ("numpy", "native"):
        t0 = time.perf_counter()
        trees[backend] = build_bvh(*args, backend=backend, **kw)
        out[f"{backend}_s"] = time.perf_counter() - t0
    a, b = trees["numpy"], trees["native"]
    same = all(getattr(a, f).dtype == getattr(b, f).dtype
               and getattr(a, f).tobytes() == getattr(b, f).tobytes()
               for f in ("left", "right", "low", "high", "data", "cut", "prim"))
    _log(f"[native bvh] stand-in, {tri.shape[0]} triangles, {a.left.shape[0]} nodes: numpy "
         f"{out['numpy_s']:.3f} s, native {out['native_s']:.4f} s; arrays byte for byte "
         f"equal: {same}")
    if not same or a.max_leaf != b.max_leaf:
        raise AssertionError("the native BVH builder's arrays differ from numpy's")
    return out


def all_launches() -> dict:
    from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
    from learn_path_tracing_tpu_torch.ops import row_gather as rg
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss

    return {"k1": ss.intersect_spheres_scan.launches, **pt.traverse.launches,
            "k4": mk.bounce_pass.launches, **rg.gather.launches}


def counted_frame(fn):
    """``fn()`` with every launch count set to 0 just before; returns
    ``(result, synchronised seconds, launches, hit calls, shading calls)``."""
    import torch

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with hit_calls() as hits, shading_calls() as shading:
        out = fn()
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, all_launches(), hits[0], shading


def only(launches, **want) -> bool:
    """The launches are ``want`` on the named kernels and 0 on every other."""
    return all(n == want.get(k, 0) for k, n in launches.items())


def multichip_cells(device, world_path):
    """The three sharded cells: ``name → (single-device fn, sharded fn, world
    data, camera params, resolution, spp, the bench's scene)``, each built as
    the bench builds its cell (``bench_torch.cell_scene``; the stand-in's
    world loaded from ``world_path``, its textures beside it), as the ranks
    of a multi-card job build them."""
    import bench_torch
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.integrator.wavefront import render
    from learn_path_tracing_tpu_torch.parallel import mesh as pm

    assets = os.path.dirname(os.path.abspath(world_path))
    cells = {"hybrid": (render_hybrid, pm.render_hybrid_multichip, "yoimiya", RES, SPP),
             "persistent": (render_persistent, pm.render_persistent_multichip, "10_final",
                            RES, MC_PERSISTENT_SPP),
             "wavefront": (render, pm.render_multichip, "10_final", MC_WAVEFRONT_RES,
                           MC_WAVEFRONT_SPP)}
    out = {}
    for name, (single, sharded, scene, res, spp) in cells.items():
        wd, cp, *_ = bench_torch.cell_scene(scene, res, device, world_path, assets)
        out[name] = (single, sharded, wd, cp, res, spp, scene)
    return out


def multichip_phase(device, world_path):
    """``[multichip]``: an NCCL group of world size 1 on the card, and over
    its 1x1 mesh the three sharded functions, each after its single-device
    render, with the counts set to 0 just before each: the hybrid on the
    stand-in at the bench's cell (1280x720, 64 spp, depth 32: K2 once per
    traversal call, K6a/K6b as its shading calls imply, nothing else), the
    persistent engine on the cover scene at 1280x720, depth 32, spp 8, and
    the wavefront at 320x180, spp 4 (K1 once per hit call, nothing else).
    Each sharded image must be the single-device one bit for bit, with the
    same segments and launches. Then the int64 accumulator's
    ``all_reduce`` and ``all_gather_into_tensor`` (1280x720x3, 22 MB) are
    timed with CUDA events; with one rank they are a copy on the card, not
    an exchange. With more than one card, one job on every card
    (``parallel.launch`` of ``bench_torch.sharded_cells``) renders the same
    cells over every card as tiles and, with an even count, as (cards / 2)
    tiles x 2 spp, and times the collectives between the cards: rank 0's
    images must be the world-size-1 ones, bit for bit (the wavefront's spp
    split within rtol 1e-5, atol 1e-6), with the same segments. Returns
    ``(paths, refs)``: the sharded runs' launches by path, and each cell's
    single-device result for ``multichip_split``."""
    import torch
    import torch.distributed as dist

    import bench_torch
    from learn_path_tracing_tpu_torch.parallel import launch
    from learn_path_tracing_tpu_torch.parallel import mesh as pm

    cells = multichip_cells(device, world_path)
    paths, refs = {}, {}
    launch.init_group(0, 1, device, port=launch.free_port())
    try:
        m = pm.make_mesh(1, 1)
        # NCCL sets up a group's communicator at its first collective:
        # once here, outside the timed frames
        t0 = time.perf_counter()
        pm.combine(torch.zeros((1, 3), device=device), 0, m)
        _log(f"[multichip] NCCL set-up (the first collectives of the mesh's groups): "
             f"{time.perf_counter() - t0:.3f} s")
        for name, (single, sharded, wd, cp, res, spp, _) in cells.items():
            kw = dict(stats=True) if name == "hybrid" else {}
            (img, segs, *st), t_single, l_single, hits, shading = counted_frame(
                lambda: single(wd, cp, res, spp, limit=DEPTH, **kw))
            (img_m, segs_m), t_sharded, l_sharded, hits_m, shading_m = counted_frame(
                lambda: sharded(wd, cp, res, spp, m, limit=DEPTH))
            if name == "hybrid":
                calls = st[0]["n_chunks"] + st[0]["passes"]
                want = dict(k2=calls, **expected_gathers(wd, shading_m))
                kept = {k: l_sharded[k] for k in ("k2", "k6a", "k6b")}
            else:
                want = dict(k1=hits_m)
                kept = {"k1": l_sharded["k1"]}
            same = bitwise_equal(img_m, img) and segs_m == segs
            _log(f"[multichip] {name} {res[0]}x{res[1]} spp {spp} depth {DEPTH}, NCCL world "
                 f"size 1: sharded {t_sharded:.3f} s against single-device {t_single:.3f} s, "
                 f"{segs_m} segments, launches {kept} (single-device {l_single}); image and "
                 f"segments bit for bit the single-device frame's: {same}")
            if not same:
                raise AssertionError(f"the sharded {name} frame differs from the single-device one")
            if not only(l_sharded, **want) or l_sharded != l_single or not all(want.values()):
                raise AssertionError(f"{name}: launches {l_sharded}, expected {want} "
                                     f"(single-device {l_single})")
            paths[f"multichip {name}"] = kept
            refs[name] = (wd, cp, res, spp, img, segs)

        n = RES[0] * RES[1]
        acc = torch.randint(0, 1 << 40, (n, 3), dtype=torch.int64, device=device)
        out = torch.empty_like(acc)
        times = {"all_reduce": cuda_ms(lambda: dist.all_reduce(acc)),
                 "all_gather_into_tensor": cuda_ms(lambda: dist.all_gather_into_tensor(out, acc)),
                 "copy_": cuda_ms(lambda: out.copy_(acc))}
        _log(f"[multichip] collectives on the {acc.numel() * 8 / 1e6:.1f} MB int64 "
             f"accumulator, NCCL world size 1 (a single-rank copy on the card, no exchange), "
             f"CUDA events: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    finally:
        dist.destroy_process_group()

    cards = torch.cuda.device_count()
    if cards > 1:
        multichip_cards(cells, refs, world_path, device, cards)
    return paths, refs


def multichip_cards(cells, refs, world_path, device, cards):
    """The multi-card part of ``[multichip]``: one job of ``cards`` ranks
    (``bench_torch.sharded_cells``) renders each cell of ``cells`` as
    ``cards`` tiles and, with an even count, as (cards / 2) tiles x 2 spp;
    rank 0's images must be ``refs``' bit for bit (the wavefront's spp
    split within rtol 1e-5, atol 1e-6), with the same segments. Prints the
    frames' seconds and the collectives' times between the cards."""
    import torch

    import bench_torch
    from learn_path_tracing_tpu_torch.parallel import launch

    runs = [(name, n_spp) for n_spp in ((1, 2) if cards % 2 == 0 else (1,))
            for name in cells]
    job = [(cells[name][6], name, cells[name][4], cells[name][5], n_spp)
           for name, n_spp in runs]
    t0 = time.perf_counter()
    frames, collectives = launch.launch(
        cards, bench_torch.sharded_cells, job, DEPTH, device, world_path,
        os.path.dirname(os.path.abspath(world_path)), device=device)
    _log(f"[multichip] the {cards}-card job ({len(job)} frames, their warm-ups and the "
         f"collectives): {time.perf_counter() - t0:.1f} s")
    for (name, n_spp), r in zip(runs, frames):
        img, segs = refs[name][4:]
        img = img.cpu()
        shape = f"{cards // n_spp} tiles x {n_spp} spp"
        if name == "wavefront" and n_spp > 1:
            diff = float((r["image"] - img).abs().max())
            ok = bool(torch.allclose(r["image"], img, rtol=1e-5, atol=1e-6))
            detail = f"within rtol 1e-5, atol 1e-6 (max |diff| {diff:.3g})"
        else:
            ok = bitwise_equal(r["image"], img)
            detail = "bit for bit"
        ok = ok and r["segments"] == segs
        _log(f"[multichip] {name} over {cards} cards ({shape}, NCCL): rank 0's frame "
             f"{r['seconds']:.3f} s, {r['segments']} segments; the world-size-1 frame "
             f"{detail}: {ok}")
        if not ok:
            raise AssertionError(f"the {cards}-card {name} frame ({shape}) differs")
    w, h = job[0][2]
    for shape, times in collectives.items():
        _log(f"[multichip] collectives between {cards} cards, mesh {shape} (tiles x spp), "
             f"int64 accumulator of {w}x{h}x3, rank 0, CUDA events: "
             + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))


def multichip_split(refs):
    """``[multichip split]``: the 2 tile x 2 spp split on one card. The
    range-local integrators run each of the four (pixel range, sample
    range) coordinates of each cell, and the four results are combined as
    the collectives combine them (summed over spp, the tiles in order):
    persistent and hybrid bit for bit the single-device frames of
    ``multichip_phase``, the wavefront (its spp halves summed in another
    f32 order) within rtol 1e-5, atol 1e-6; the segments equal."""
    import torch

    from learn_path_tracing_tpu_torch.integrator.hybrid import _hybrid_core
    from learn_path_tracing_tpu_torch.integrator.persistent import _persistent_core, radiance
    from learn_path_tracing_tpu_torch.integrator.wavefront import trace_sample_pixels

    for name, (wd, cp, res, spp, ref, ref_segs) in refs.items():
        n = res[0] * res[1]
        nl, sl = n // 2, spp // 2

        def core(p0, s0):
            if name == "hybrid":
                return _hybrid_core(wd, cp, res, nl, p0, s0, sl, DEPTH, 0, "legacy", "jitter",
                                    0, 0, 0, 2)[:2]
            if name == "persistent":
                return _persistent_core(wd, cp, res, nl, p0, s0, sl, DEPTH, 0, "modern",
                                        "thinlens", "spheres", "auto")[:2]
            pix = torch.arange(p0, p0 + nl, device=cp.device)
            acc, segs = torch.zeros((nl, 3), device=cp.device), 0
            for k in range(sl):
                rad, sg = trace_sample_pixels(wd, cp, res, pix, 0, s0 + k, DEPTH)
                acc, segs = acc + rad, segs + sg
            return acc, segs

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiles, segments = [], 0
        for t in range(2):
            (a, sa), (b, sb) = core(t * nl, 0), core(t * nl, sl)
            tiles.append(a + b)
            segments += sa + sb
        acc = torch.cat(tiles)
        img = (acc / spp if name == "wavefront" else radiance(acc) / spp).reshape(*res, 3)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if name == "wavefront":
            diff = float((img - ref).abs().max())
            ok = bool(torch.allclose(img, ref, rtol=1e-5, atol=1e-6))
            detail = f"within rtol 1e-5, atol 1e-6 (max |diff| {diff:.3g}): {ok}"
        else:
            ok = bitwise_equal(img, ref)
            detail = f"bit for bit: {ok}"
        ok = ok and segments == ref_segs
        _log(f"[multichip split] {name} {res[0]}x{res[1]} spp {spp}, 2 tiles x 2 spp ranges "
             f"on one card: {seconds:.3f} s, {segments} segments (single-device {ref_segs}); "
             f"the single-device frame {detail}")
        if not ok:
            raise AssertionError(f"the 2x2 split of {name} differs from the single-device frame")


def serve_phase(device, world_path):
    """``[serve]``: the viewer's loop (``viewer.serve.serve``) in this
    process on an ephemeral port, first on ``--scene spheres`` at its
    defaults (640x360, spp 16, limit 10), then on the stand-in's
    ``.world.npy`` with motion preview on (4 spp, limit 2). After each
    frame: ``GET /frame.png`` (``X-Gen`` counts the frames), after the first
    ``GET /`` too, and after frame 2 (spheres) or 3 (the stand-in) ``POST
    /input {"move": "w"}``, after which ``X-Spp`` restarts at the full spp
    (spheres) or the preview's. With the counts set to 0 just before each
    loop: spheres launch K1 once per hit call and nothing else; the
    stand-in K2 and K6a/K6b as its shading calls imply, and nothing else.
    Prints each frame's ``X-Pass-Ms``. Returns the launches by path."""
    import urllib.request
    from http.server import ThreadingHTTPServer

    from learn_path_tracing_tpu_torch.viewer import serve

    def loop(argv, frames, move_after):
        pr, cam, warns = serve.setup(serve.parse_args(argv + ["--device", device]))
        if warns:
            raise AssertionError(f"the viewer's world fell back: {warns}")
        state = serve.ViewerState()
        srv = ThreadingHTTPServer(("127.0.0.1", 0), serve._make_handler(state))
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        seen = []

        def on_frame(k):
            r = urllib.request.urlopen(base + "/frame.png", timeout=30)
            body = r.read()
            if r.status != 200 or body[:4] != b"\x89PNG":
                raise AssertionError(f"/frame.png: {r.status}, {body[:4]}")
            seen.append((int(r.headers["X-Gen"]), int(r.headers["X-Spp"]),
                         int(r.headers["X-Pass-Ms"])))
            if k == 1 and urllib.request.urlopen(base + "/", timeout=30).status != 200:
                raise AssertionError("GET / failed")
            if k == move_after:
                req = urllib.request.Request(base + "/input", data=b'{"move": "w"}',
                                             method="POST")
                if urllib.request.urlopen(req, timeout=30).status != 204:
                    raise AssertionError("POST /input failed")

        done, seconds, launches, hits, shading = counted_frame(
            lambda: serve.serve(pr, cam, srv, state, max_frames=frames, on_frame=on_frame))
        if done != frames or len(seen) != frames:
            raise AssertionError(f"the viewer published {done} frames, served {len(seen)}")
        return pr, seen, seconds, launches, hits, shading

    out = {}
    pr, seen, seconds, launches, hits, _ = loop(["--scene", "spheres", "--port", "0"], 4, 2)
    want = [(1, 16), (2, 32), (3, 16), (4, 32)]
    _log(f"[serve] spheres 640x360 spp 16 limit 10: frames (X-Gen, X-Spp, X-Pass-Ms) {seen}, "
         f"loop {seconds:.3f} s, launches {launches} for {hits} hit calls")
    if [s[:2] for s in seen] != want or not only(launches, k1=hits) or not hits:
        raise AssertionError(f"serve spheres: frames {seen} (want {want}), {launches}")
    out["serve spheres"] = {"k1": launches["k1"]}

    pr, seen, seconds, launches, hits, shading = loop(["--scene", world_path, "--port", "0"],
                                                      5, 3)
    want = [(1, 4), (2, 16), (3, 32), (4, 4), (5, 16)]
    gathers = expected_gathers(pr.world_data, shading)
    _log(f"[serve] stand-in 640x360 spp 16 limit 10, preview 4 spp limit 2: frames (X-Gen, "
         f"X-Spp, X-Pass-Ms) {seen}, loop {seconds:.3f} s, launches {launches}, row gathers "
         f"expected {gathers}")
    if ([s[:2] for s in seen] != want or not launches["k2"]
            or not only(launches, k2=launches["k2"], **gathers) or not all(gathers.values())):
        raise AssertionError(f"serve mesh: frames {seen} (want {want}), {launches}")
    out["serve mesh"] = {k: launches[k] for k in ("k2", "k6a", "k6b")}
    return out


def multichip_only(device, directory):
    """``--multichip``: the stand-in world built and saved, ``[multichip]``
    (its world-size-1 cells, then, with more than one card, each cell on
    every card against them), and ``python -m learn_path_tracing_tpu_torch
    multichip --nproc <cards> --device cuda`` as a subprocess (must exit
    0)."""
    world = standin_world(directory)
    _build_quiet(world, device=device)
    path = os.path.join(directory, "standin.world.npy")
    world.save(path)
    multichip_phase(device, path)
    multichip_cli()


def multichip_cli():
    """``python -m learn_path_tracing_tpu_torch multichip --nproc <cards>``
    as a subprocess from the checkout's root (the dry run, one NCCL rank a
    card, started by ``parallel.launch``); it must exit 0."""
    import torch

    cards = torch.cuda.device_count()
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "learn_path_tracing_tpu_torch", "multichip",
                           "--nproc", str(cards), "--device", "cuda"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    _log(f"[multichip cli] --nproc {cards}: exit code {proc.returncode} in "
         f"{time.time() - t0:.2f} s: {(proc.stdout + proc.stderr).strip()[-2000:]}")
    if proc.returncode != 0:
        raise AssertionError("python -m learn_path_tracing_tpu_torch multichip failed")


def _timed(table, name, fn):
    """``fn`` wrapped to add its synchronised wall ms and one call to
    ``table[name]``."""
    import torch

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        row = table.setdefault(name, [0.0, 0])
        row[0] += (time.perf_counter() - t0) * 1e3
        row[1] += 1
        return out
    return wrapper


# device kernel of each packet version and of each row gather, as the
# profiler names them
TRAVERSAL_KERNEL_NAMES = {2: "packet_traverse_kernel", 1: "packet_walk_v1_kernel",
                          3: "packet_walk_v3_kernel"}
GATHER_KERNEL_NAMES = {"k6a": "row_gather_narrow_kernel", "k6b": "row_gather_wide_kernel"}


@contextlib.contextmanager
def traversal_widths():
    """Lists the ray count of every ``ops.packet_traverse.traverse`` call
    made on the mesh path while the block runs, in order."""
    from learn_path_tracing_tpu_torch.ops import packet_traverse as pt

    widths, real = [], pt.traverse

    def counted(nodes, entries, runs, ro, *args, **kw):
        widths.append(ro.shape[0])
        return real(nodes, entries, runs, ro, *args, **kw)

    counted.launches = real.launches
    pt.traverse = counted
    try:
        yield widths
    finally:
        pt.traverse = real


def mesh_profile(device, directory, frames=3, packet_version=2):
    """Where the stand-in frame's time goes (``--profile-mesh``): ``frames``
    unprofiled frames of the l14 headline's renderer on the reloaded world
    under ``packet_version``, one under ``torch.profiler`` (device busy
    time, device events, the traversal kernel's and the row gathers'
    launches and shares, peak memory; ``traversal_by_width``: the traversal
    kernel's ``[lanes listed, launches, device ms]``, the slabs first, then
    each pool width), and one with each layer wrapped in
    synchronised timers (inclusive host ms; the synchronisation inflates
    that frame). Returns the summary dict."""
    import torch

    import learn_path_tracing_tpu_torch.integrator.hybrid as hybrid
    import learn_path_tracing_tpu_torch.scene.legacy_world as lw
    from learn_path_tracing_tpu_torch.bsdf.bsdf import SCATTERERS
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map
    from learn_path_tracing_tpu_torch.viewer.progressive import ProgressiveRenderer

    world = standin_world(directory)
    world.build()
    path = os.path.join(directory, "standin.world.npy")
    world.save(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        wd = lw.LegacyWorld().load(path, path_map=make_asset_path_map(directory),
                                   device=device, packet_version=packet_version)
    pr = ProgressiveRenderer(wd, l14_camera(MESH_RES), MESH_RES, spp_per_frame=MESH_SPP,
                             limit=MESH_DEPTH, seed=0, bsdf="legacy", scene="legacy",
                             camera_model="jitter")

    def frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pr.render(moved=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    frame()                                            # warm-up
    walls = [frame() for _ in range(frames)]
    segs = pr.last_stats["segments"]
    torch.cuda.reset_peak_memory_stats()
    with traversal_widths() as widths, \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                               torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall = frame()
    peak = torch.cuda.max_memory_allocated()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    trav = sorted((e for e in dev_events if TRAVERSAL_KERNEL_NAMES[packet_version] in e.name),
                  key=lambda e: e.time_range.start)
    trav_ms = sum(e.time_range.elapsed_us() for e in trav) / 1e3
    # the kernel's device ms by the lanes its launches listed: the slabs
    # first, then the pool passes at each pool width
    st = pr.last_stats
    expected = {}
    for w, count in ((MESH_RES[0] * MESH_RES[1] * st["chunk_spp"], st["n_chunks"]),
                     *st["passes_by_width"]):
        expected[w] = expected.get(w, 0) + count
    by_width = {}
    if len(trav) == len(widths):       # else the profiler dropped events
        for w, e in zip(widths, trav):
            row = by_width.setdefault(w, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
        if {w: c for w, (c, _) in by_width.items()} != {w: c for w, c in expected.items() if c}:
            raise AssertionError(f"traversal launches by width {by_width}, the integrator "
                                 f"counted {expected}")
    gathers = {k: [e for e in dev_events if name in e.name]
               for k, name in GATHER_KERNEL_NAMES.items()}
    gather_ms = {k: sum(e.time_range.elapsed_us() for e in ev) / 1e3 for k, ev in gathers.items()}

    layers = {}
    patches = [(lw, "trace_shade_compact"), (lw, "trace_legacy"), (lw, "packet_traverse"),
               (lw, "packet_traverse_sorted"), (lw, "shade_from_trace"), (lw, "_attrs_rows"), (lw, "environment_color"),
               (hybrid, "generate_rays_for_pixels")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patches]
    saved_scatter = SCATTERERS["legacy"]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, _timed(layers, name, fn))
        SCATTERERS["legacy"] = _timed(layers, "scatter_legacy", saved_scatter)
        sync_wall = frame()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        SCATTERERS["legacy"] = saved_scatter

    med = statistics.median(walls)
    out = {"packet_version": packet_version, "frames_s": walls, "segments": segs,
           "mrays_median": segs / med / 1e6,
           "profiled_frame_s": prof_wall, "device_busy_ms": busy_ms,
           "device_events": len(dev_events), "idle_share_vs_median_frame":
           1.0 - busy_ms / (med * 1e3) if dev_events else None,
           "traversal_launches": len(trav), "traversal_device_ms": trav_ms,
           "traversal_by_width": [[w, c, ms] for w, (c, ms) in
                                  sorted(by_width.items(), reverse=True)],
           "traversal_share_of_busy": trav_ms / busy_ms if busy_ms else None,
           **{f"{k}_launches": len(ev) for k, ev in gathers.items()},
           **{f"{k}_device_ms": v for k, v in gather_ms.items()},
           **{f"{k}_share_of_busy": v / busy_ms if busy_ms else None
              for k, v in gather_ms.items()},
           "peak_mem_gib": peak / 2**30, "synchronised_frame_s": sync_wall,
           "layers_ms_calls": {k: [round(v[0], 3), v[1]] for k, v in
                               sorted(layers.items(), key=lambda kv: -kv[1][0])},
           "passes": pr.last_stats["passes"], "n_chunks": pr.last_stats["n_chunks"]}
    _log(f"[mesh profile] {json.dumps(out)}")
    if not dev_events:
        raise AssertionError("torch.profiler recorded no device events")
    return out


def packet_times(device, directory):
    """``--packet-times``: the packet kernels alone. K2, K5a and K5b on the
    stand-in mesh's five ray sets and K3 on the sphere world's four, each
    against the twin (``check_packet``), then ``hit(backend='bvh')`` against
    the scan on the cover scene (``bvh_phase``), then every kernel's device
    time on every set and order and K3's beside K1's at the modular frame's
    pass widths. It uses only what every tree of the port since the sphere
    BVH has, so one copy of this script can time two trees in one call."""
    world = standin_world(directory)
    mesh_wd = world.build(device=device)
    tri = mesh_wd.meshes[0]
    _, tri_device_times = check_packet(mesh_wd, tri.packet, tri.stack, "tri", device, seed=7)
    sph_wd = _build_quiet(sphere_world(), device=device)
    sph = sph_wd.spheres
    _, sph_device_times = check_packet(sph_wd, sph.packet, sph.stack, "sphere", device, seed=8)
    bvh_device_times = bvh_phase(device)
    tri_device_times()
    sph_device_times()
    bvh_device_times()


def build_kernels():
    """Build every kernel at once (one nvcc per source, in parallel, and the
    native BVH builder's g++ beside them) and print ptxas's register,
    memory and spill lines."""
    from concurrent.futures import ThreadPoolExecutor

    from learn_path_tracing_tpu_torch.accel import native
    from learn_path_tracing_tpu_torch.ops import (bounce_megakernel, build, packet_traverse,
                                                  row_gather, sphere_scan)

    loaders = {"sphere_scan": sphere_scan.load_kernel,
               "packet_traverse": packet_traverse.load_kernel,
               "bounce_megakernel": bounce_megakernel.load_kernel,
               "row_gather": row_gather.load_kernel,
               "bvh_builder (g++)": native.load}
    t0 = time.time()
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()
    _log(f"[build] {', '.join(loaders)} built and loaded in {time.time() - t0:.2f} s")
    for name in loaders:
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            _log(f"[build] {name}: {line}")


def main(argv=None) -> int:
    import argparse
    import tempfile

    import torch

    from learn_path_tracing_tpu_torch.accel import native

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--profile-mesh", action="store_true",
                    help="only profile the stand-in mesh frame (see mesh_profile)")
    ap.add_argument("--packet-times", action="store_true",
                    help="only check and time the packet kernels (see packet_times)")
    ap.add_argument("--packet-version", type=int, choices=(1, 2, 3), default=2,
                    help="the mesh traversal kernel of --profile-mesh (2: K2, 1: K5a, 3: K5b)")
    ap.add_argument("--multichip", action="store_true",
                    help="only the sharded cells on every card and the CLI's multichip dry "
                         "run (see multichip_only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = card_line()
    _log(f"[info] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    device = "cuda"
    build_kernels()
    if args.multichip:
        with tempfile.TemporaryDirectory() as directory:
            multichip_only(device, directory)
        print(card)
        return 0
    if args.profile_mesh or args.packet_times:
        with tempfile.TemporaryDirectory() as directory:
            if args.profile_mesh:
                mesh_profile(device, directory, packet_version=args.packet_version)
            else:
                packet_times(device, directory)
        print(card)
        return 0

    # the profiler's device times come last (see kernel_ms)
    k1, k1_device_times = check_sphere_scan(device)
    bvh_device_times = bvh_phase(device)
    k4, k4_device_times = check_bounce_megakernel(device)
    check_gpu_vs_cpu(device)
    check_mega_gpu_vs_cpu(device)
    s10_k1 = stage10_cli(device)
    native_bvh_phase()
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.time()
        mesh_world = standin_world(directory)
        native.builds = 0
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # its PBR set and EXR must load
            mesh_wd = mesh_world.build(device=device)
        if mesh_wd.env_gradient_h is not None:
            raise AssertionError("the stand-in's EXR environment did not load")
        if not native.builds:
            raise AssertionError("the stand-in's BVH was not built by the native builder")
        tri = mesh_wd.meshes[0]
        _log(f"[stand-in] {tri.tex.shape[0]} triangles, {tri.packet[0].shape[0]} wide nodes, "
             f"{tri.packet[2].shape[0]} run rows, stack {tri.stack}; built in "
             f"{time.time() - t0:.2f} s ({native.builds} native BVH build)")
        tri_kernels, tri_device_times = check_packet(mesh_wd, tri.packet, tri.stack, "tri",
                                                     device, seed=7)
        gather_kernels, gather_device_times = check_row_gather(mesh_wd, device)
        mesh_kernels = {**tri_kernels, **gather_kernels}

        t0 = time.time()
        sph_wd = _build_quiet(sphere_world(), device=device)
        sph = sph_wd.spheres
        _log(f"[sphere world] {N_SPHERES} spheres, {sph.packet[0].shape[0]} wide nodes, "
             f"stack {sph.stack}; built in {time.time() - t0:.2f} s")
        sph_kernels, sph_device_times = check_packet(sph_wd, sph.packet, sph.stack, "sphere",
                                                     device, seed=8)
        k3 = sph_kernels["k3"]
        k3["launches"] = sphere_path(sph_wd, device)

        check_mesh_gpu_vs_cpu(device, directory)
        for kernel, launches in mesh_headline(mesh_world, device, directory).items():
            mesh_kernels[kernel]["launches"] = launches
        viewer_wavefront(mesh_world, device)
        l13_phase(device, directory)
        # the kernels of each further path, as that path's run counted them
        world_path = os.path.join(directory, "standin.world.npy")
        paths = {"bench stand-in": bench_standin(mesh_world, device, world_path),
                 "l15": l15_phase(device, directory)}
        mc_paths, refs = multichip_phase(device, world_path)
        paths.update(mc_paths)
        multichip_split(refs)
        del refs
        paths.update(serve_phase(device, world_path))
    paths["stage 10 cli"] = {"k1": s10_k1}
    paths["l11"] = l11_phase(device)
    paths["l12"] = {"k3": l12_phase(device)}
    k1["launches"], modular = bench_modular(device)
    k4["launches"] = mega_headline(device, modular)
    paths["bench modular"] = {"k1": k1["launches"]}
    paths["bench mega"] = {"k4": k4["launches"]}
    for entry in (k1, k3, k4, *mesh_kernels.values()):
        entry["paths"] = {p: n[entry["id"]] for p, n in paths.items() if entry["id"] in n}
    k1_widths = k1_device_times()
    _log(f"[k1 frame] K1 device ms in the modular 10_final frame (passes x kernel ms at "
         f"each width, {dict((w, round(ms, 4)) for w, ms in k1_widths.items())}): "
         f"{k1_frame_ms(k1_widths, modular['stats']):.3f} ms")
    bvh_device_times()
    k4_device_times()
    tri_device_times()
    sph_device_times()
    gather_device_times()
    cli_smoke()
    multichip_cli()

    print(card)
    print(json.dumps({"kernels": [k1, mesh_kernels["k2"], k3, k4, mesh_kernels["k5a"],
                                  mesh_kernels["k5b"], mesh_kernels["k6a"],
                                  mesh_kernels["k6b"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
