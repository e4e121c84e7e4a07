#!/usr/bin/env python3
"""Each hand-written kernel of the port against its plain twin on one GPU.

    python3 chip_smoke.py [--packet-times | --k2-modes | --multichip]

The twelve kernels of the kernel table in ``PERF.md`` (K1, K2, K2r, K2h,
K2rh, K3, K4, K5a, K5b, K6a, K6b, K7): each held bit for bit to its plain
PyTorch twin at the main path's shapes, timed by CUDA events beside the
twin (median of 20) with the bound of its work, then timed on the device by
``torch.profiler``. Frames are the benchmark's (``benchmark/run.py``);
whole paths are the card tests' (``tests/test_torch_gpu.py -m gpu``).

1. prints the card, its power limit, and the torch and CUDA versions;
2. builds every kernel (one ``nvcc`` per source, all started together, and
   the native BVH builder's ``g++``) and prints ``ptxas``'s lines;
3. the checks: K1 on the cover scene's rays and at every pass width of the
   modular frame (``check_sphere_scan``); K3 under ``hit(backend='bvh')``
   against K1 (``bvh_phase``); K4 from three states of the 1280x720, 64 spp
   frame (``check_bounce_megakernel``); K7 on l11's lanes and on random
   lanes of every branch (``check_legacy_scatter``); on the stand-in mesh
   (``models.standin``) K2, K5a and K5b on five ray sets in lane and in
   coherence-sorted order (``check_packet``), K2r, K2h and K2rh
   (``check_k2_modes``), and K6a and K6b beside ``torch.index_select``
   (``check_row_gather``); K3 on 8,192 spheres (``check_packet``); K2 and
   K3 against the plain lockstep walks (``lockstep_phase``);
4. the kernels' device times, last, because a profiler session can slow
   the process's later launches, which a CUDA-event time would show;
5. prints the ``nvidia-smi`` name and power limit, the kernels line and
   ``{"ok": true, "device": {...}}``.

A kernels-line entry has ``ms`` (CUDA events around one wrapper call: the
host's issue time, and for the packet kernels the read-back of their error
word, included), ``plain_ms`` (the twin), ``library_ms``, ``bound_ms``,
``bound_by`` and ``device_ms``. A path's launches of each kernel are in
its stats (``kernels``), which the benchmark's cells report.

``--packet-times`` runs only the build and ``packet_times``,
``--k2-modes`` only the build and ``k2_mode_times``, and ``--multichip``
only the build and ``multichip_only``: the sharded functions against their
single-device frames over one card and over every card, the 2 tile x 2 spp
split on one card, and the CLI's ``multichip`` dry run.

Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits 1 and prints no result.
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

import torch

from learn_path_tracing_tpu_torch.models.standin import (N_SPHERES, build_quiet, icosphere,
                                                          sphere_world, standin_camera,
                                                          standin_mesh, standin_world)
from learn_path_tracing_tpu_torch.ops import bounce_megakernel as mk
from learn_path_tracing_tpu_torch.ops import kernel_counters
from learn_path_tracing_tpu_torch.ops import legacy_scatter as ls
from learn_path_tracing_tpu_torch.ops import packet_traverse as pt
from learn_path_tracing_tpu_torch.ops import row_gather as rg
from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
from learn_path_tracing_tpu_torch.utils.profiling import recording

RES = (1280, 720)
SPP = 64
DEPTH = 32
SCENE_SEED = 20230328
# the l14 primary slab: the first chunk of render_hybrid at bench.py --scene
# yoimiya's shape
MESH_RES, MESH_CHUNK = (640, 360), 8
TWIN_RAYS = 65536         # rays of the random, on-surface and axis twin sets

# the names benchmark/tests/test_bench_scenes.py holds its stand-in copy to
_icosphere, _standin_mesh = icosphere, standin_mesh


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
    device events, without the host's issue time (``setup()`` runs before
    each call). A session that lost more than half the events is run
    again, up to five sessions, after which the time is NaN, "not
    measured". A session can slow the process's later launches, so
    ``main`` takes every CUDA-event time before the first one."""
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(5):      # the profiler can drop some of a session's events
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
    _log(f"[profiler] saw {len(times)} of {iters} launches of {name} in each of 5 sessions: "
         f"its device time is not measured")
    return float("nan")


def bitwise_equal(x, y) -> bool:
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
# BF16 outside the tensor cores: packed bf16x2, two operations an FP32
# instruction slot (the H100 white paper's non-tensor BF16 rate, 133.8)
BF16X2_FLOP_PER_S = 2 * FP32_FLOP_PER_S
SCAN_FLOP_PER_PAIR = 20       # K1/K4: oc, half_b, c0, disc, sqrt, roots
SLAB_FLOP_PER_CHILD = 24      # K2/K3/K5: 6 mul, 6 sub, 6 min/max, 6 compares


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, flop_per_s=FP32_FLOP_PER_S) -> dict:
    """``bound_ms`` and ``bound_by`` of moving ``n_bytes`` (each input read
    once, each output written once) and doing ``flops`` operations at
    ``flop_per_s`` (FP32 unless said)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_inputs(device):
    """Ray sets for the sphere-scan check: the primary rays of the first
    57,344 lanes of the 10_final frame (the JAX rule's pool, lane ``i``
    pixel ``i // SPP``), their first bounce, random rays and rays inside
    glass. ``check_sphere_scan`` repeats them to the frame's pass widths."""
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


def frame_widths(device) -> tuple:
    """The modular 10_final frame's pass widths on ``device``: the pool of
    the rule that ``pool_rule`` picks there (the card's rule on a CUDA
    device), then the drain levels."""
    from learn_path_tracing_tpu_torch.integrator.persistent import rule_schedule

    _, sched = rule_schedule(device, RES[0] * RES[1], SPP)
    return (sched.pool, *sched.drain_widths)


def to_width(x, w):
    """The rows of ``x`` repeated (or cut) to ``w`` rows, contiguous."""
    return x.repeat(-(-w // x.shape[0]), 1)[:w].contiguous()


# rays a call of K1's plain twin takes at most (the twin is per ray, so the
# frame's widest passes are compared in parts, which bounds its temporaries)
PLAIN_RAYS = 1 << 20


def check_sphere_scan(device):
    """K1 against its plain twin on the card, on the four ray sets and on
    the primary and bounce sets repeated (or cut) to each pass width of the
    frame (``frame_widths``: the card rule's pool, then the drains); then
    the call timed by CUDA events at each width on the primary set. Returns
    the kernels-line entry (at the pool) and ``device_times()``: the
    kernel's device time at each width under every slice count (it sets
    the entry's ``device_ms``)."""
    wd, sets = scan_inputs(device)
    table, attrs = wd.scan_table, wd.scan_attrs
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def plain(ro, rd):
        parts = [ss.intersect_spheres_scan_plain(ro[i:i + PLAIN_RAYS], rd[i:i + PLAIN_RAYS],
                                                 table, attrs)
                 for i in range(0, ro.shape[0], PLAIN_RAYS)]
        return tuple(torch.cat(p) for p in zip(*parts))

    pass_widths = frame_widths(device)
    cases = dict(sets)
    for w in pass_widths:
        for name in ("primary", "bounce1"):
            cases[f"{name}@{w}"] = tuple(to_width(x, w) for x in sets[name])
    max_err = 0.0
    for name, (ro, rd) in cases.items():
        t, idx, attr = ss.intersect_spheres_scan(ro, rd, table, attrs)
        t2, idx2, attr2 = plain(ro, rd)
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

    widths = {w: cases[f"primary@{w}"] for w in pass_widths}
    del cases
    bounds, entry = {}, None
    for w, (ro, rd) in widths.items():
        call_ms = cuda_ms(lambda: ss.intersect_spheres_scan(ro, rd, table, attrs))
        b = bounds[w] = bound(
            nbytes(ro, rd, table, attrs, *ss.intersect_spheres_scan(ro, rd, table, attrs)),
            w * table.shape[0] * SCAN_FLOP_PER_PAIR)
        _log(f"[k1] time at {w} rays x {table.shape[0]} spheres: the call {call_ms:.4f} ms "
             f"by CUDA events (median of 20); bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        if w == pass_widths[0]:
            plain_ms = cuda_ms(lambda: plain(ro, rd))
            _log(f"[k1] plain twin at {w} rays, {PLAIN_RAYS} a call: {plain_ms:.4f} ms "
                 f"(median of 20)")
            entry = {"name": "sphere_scan", "id": "k1", "route": "cuda",
                     "source": "learn_path_tracing_tpu_torch/csrc/sphere_scan.cu",
                     "replaces": "learn_path_tracing_tpu/ops/sphere_scan.py:49",
                     "max_abs_err": max_err, "ms": call_ms, "plain_ms": plain_ms, **b,
                     "library_ms": None}

    def device_times():
        for w, (ro, rd) in widths.items():
            by_slices = {p: kernel_ms(lambda p=p: ss._launch(ro, rd, table, attrs, ss.T_MIN, p),
                                      "sphere_scan_kernel")
                         for p in ss.SLICE_CHOICES}
            ms = kernel_ms(lambda: ss.intersect_spheres_scan(ro, rd, table, attrs),
                           "sphere_scan_kernel")
            entry.setdefault("device_ms", ms)
            _log(f"[k1 device] {w} rays x {table.shape[0]} spheres: kernel {ms:.4f} ms on the "
                 f"device with {ss.team_slices(w, table.shape[0], sms)} slices (profiler, median "
                 f"of 20), by slice count "
                 f"{', '.join(f'{p}: {t:.4f}' for p, t in by_slices.items())} ms; "
                 f"{bounds[w]['bound_ms'] / ms:.3f} of the bound")

    return entry, device_times


def bvh_phase(device):
    """``hit(backend='bvh')`` on the card (the sphere BVH through K3) over
    the cover scene's four K1 ray sets, held to ``hit(backend='auto')`` (K1):
    no ray's ``t``, sphere or hit flag may differ. Then both calls are timed
    on the primary set by CUDA events. Returns ``device_times()``: both
    kernels' device times at each pass width of the modular frame."""
    from learn_path_tracing_tpu_torch.core.types import Rays
    from learn_path_tracing_tpu_torch.models import random_scene
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
        for w in frame_widths(device):
            part = Rays(ro=to_width(ro, w), rd=to_width(rd, w),
                        throughput=torch.ones((w, 3), dtype=torch.float32, device=device),
                        alive=torch.ones((w,), dtype=torch.bool, device=device))
            dev_ms = {backend: kernel_ms(lambda backend=backend: hit(wd, part, backend=backend),
                                         name)
                      for backend, name in (("bvh", "packet_traverse_kernel"),
                                            ("auto", "sphere_scan_kernel"))}
            _log(f"[bvh device] the kernels of hit() on {w} primary rays: K3 "
                 f"{dev_ms['bvh']:.4f} ms, K1 {dev_ms['auto']:.4f} ms (profiler, median of 20)")

    return device_times


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
    ``mega_states``: the kernel over the state's lane list, in place on a
    copy, the twin over every lane. The integer rows, the alive row, the
    live count, the fixed-point deposits and the float rows must be equal
    bit for bit (a float row that differs is named with its lanes and max
    |diff|), and the next list must hold the lanes alive after the pass,
    then those that died in it. Then each state's pass is timed by CUDA
    events (the state restored outside the timing) beside the twin's, with
    its bound: its live lanes' pair tests and its listed lanes' bytes.
    Returns the kernels-line entry (the primary state's pass) and
    ``device_times()`` (which sets its ``device_ms``)."""
    from learn_path_tracing_tpu_torch.integrator.persistent import bounce_pass_plain, mega_pass
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera

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
    acc = torch.zeros((stf.shape[1], 3), dtype=torch.int64, device=stf.device)
    work_stf, work_sti = stf.clone(), sti.clone()

    def restore():
        work_stf.copy_(stf)
        work_sti.copy_(sti)

    def run():
        mk.bounce_pass(work_stf, work_sti, wd, scalf, 0, RES, SPP, lanes, limit=DEPTH, acc=acc)

    return restore, run


# ------------------------------------------------------- the mesh path --

def primary_slab(device, stride=1):
    """The primary slab of render_hybrid's first chunk on the l14 camera
    (pixel-major), every ``stride``-th ray: ``(rays, pixel, sample)``."""
    from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels

    n = MESH_RES[0] * MESH_RES[1]
    lanes = torch.arange(0, n * MESH_CHUNK, stride, dtype=torch.int64, device=device)
    pixel, sample = lanes // MESH_CHUNK, lanes % MESH_CHUNK
    cam = standin_camera(MESH_RES).params(device)
    return (generate_rays_for_pixels(cam, MESH_RES, pixel, 0, sample, model="jitter"),
            pixel, sample)


def traversal_sets(wd, tables, stack, leaf_kind, device, seed):
    """Ray sets for a packet-kernel check, at the mesh path's shapes:
    ``{name: (ro, rd, t_init, active)}``. The bounce set is traced with
    the plain twin, so it does not depend on the kernel under test. For
    triangle tables a fifth set, ``axis``, shoots exactly axis-parallel
    rays from outside the figure at surface points: v1's slab form hits
    them, the hoisted form of K2/K5b gives ``inf - inf`` and misses."""
    from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_legacy
    from learn_path_tracing_tpu_torch.core import rng
    from learn_path_tracing_tpu_torch.scene.legacy_world import shade_from_trace

    prim, pixel, sample = primary_slab(device)
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
    root = tables[0][0].cpu()
    lo = torch.stack([root[d * 8:(d + 1) * 8].min() for d in range(3)])
    hi = torch.stack([root[(3 + d) * 8:(4 + d) * 8].max() for d in range(3)])
    return lo, hi


# device kernel of each packet version and of each row gather, as the
# profiler names them
TRAVERSAL_KERNEL_NAMES = {2: "packet_traverse_kernel", 1: "packet_walk_v1_kernel",
                          3: "packet_walk_v3_kernel"}
GATHER_KERNEL_NAMES = {"k6a": "row_gather_narrow_kernel", "k6b": "row_gather_wide_kernel"}
PACKET_ENTRIES = {   # kernels-line name and TPU kernel of each packet kernel
    "k2": ("packet_traverse_tri", "learn_path_tracing_tpu/ops/packet_traverse.py:390"),
    "k3": ("packet_traverse_sphere", "learn_path_tracing_tpu/ops/packet_traverse.py:390"),
    "k5a": ("packet_walk_v1", "learn_path_tracing_tpu/ops/packet_traverse.py:239"),
    "k5b": ("packet_walk_v3", "learn_path_tracing_tpu/ops/packet_traverse.py:733"),
}


@contextlib.contextmanager
def shading_calls():
    """Counts the shading calls that launch kernels while the block runs:
    attribute blocks (``_attrs_block``) and environment taps
    (``environment_color``, off the sky-gradient closed form), which launch
    the row gathers on the mesh path, and the legacy BSDF's calls
    (``SCATTERERS['legacy']``), each one launch of K7 on the card; each on
    at least one lane."""
    import learn_path_tracing_tpu_torch.scene.legacy_world as lw
    from learn_path_tracing_tpu_torch.bsdf.bsdf import SCATTERERS

    counts = {"attrs": 0, "env": 0, "scatter": 0}
    attrs, env, scatter = lw._attrs_block, lw.environment_color, SCATTERERS["legacy"]

    def attrs_counted(world, point, *args):
        counts["attrs"] += point.shape[0] > 0
        return attrs(world, point, *args)

    def env_counted(envs, env_id, rd, mask=None, gradient_h=None):
        counts["env"] += gradient_h is None and rd.shape[0] > 0
        return env(envs, env_id, rd, mask=mask, gradient_h=gradient_h)

    def scatter_counted(rays, hits, base):
        counts["scatter"] += rays.rd.shape[0] > 0
        return scatter(rays, hits, base)

    lw._attrs_block, lw.environment_color = attrs_counted, env_counted
    SCATTERERS["legacy"] = scatter_counted
    try:
        yield counts
    finally:
        lw._attrs_block, lw.environment_color = attrs, env
        SCATTERERS["legacy"] = scatter


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
    form), K3 for spheres, bit for bit in ``(t, prim)`` on every set (and in
    the pops for K2/K3, whose pops are per ray like the twin's). Then each
    kernel is timed by CUDA events in turns, in lane and in coherence-sorted
    order, on every set. Returns ``{kernel: kernels-line entry}`` and
    ``device_times()``: every kernel's device time on every set and order
    beside its pops per ray (the primary slab in lane order sets
    ``device_ms``)."""
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


# K2's modes (version 2, triangle leaves): kernels-line name, and the flags
# (seeded, bf16) that pick each
K2_MODES = {"k2r": ("packet_traverse_tri_restart", True, False),
            "k2h": ("packet_traverse_tri_bf16", False, True),
            "k2rh": ("packet_traverse_tri_restart_bf16", True, True)}
# the TPU kernel's modes: _kernel_v2's seed_init (:428-440, :456-472) and
# bf16 slabs (:445, :486-490, :563-583)
K2_MODE_REPLACES = "learn_path_tracing_tpu/ops/packet_traverse.py:390"
BF16_BOX_BYTES = 96     # a node's 48 bf16 box values, what K2h reads of a row


def block_rows(tables, treelets, ro, rd, order, active_s):
    """The JAX package's seed rows of the sorted rays (``seed_rows``): what
    its 1024-ray packets would be seeded with."""
    _, w0, w1 = pt._treelet_entry_key(ro, rd, treelets, eps=1e-4, want_mask=True)
    w0_s, w1_s = (torch.where(active_s, w[order], 0) for w in (w0, w1))
    return pt.seed_rows(w0_s, w1_s, pt.treelet_seed_codes(tables[0], tables[1]))


def check_k2_modes(wd, tables, stack, device, seed):
    """K2's modes on the stand-in mesh against the plain twin on the card,
    on the l14 primary slab and its first-bounce survivors: K2r on the rays
    in ``packet_traverse_sorted(restart=True)``'s order with each ray's own
    seeds (``sorted_rays``; beside them, how many the JAX package's
    1024-ray block rows would seed), K2h in lane order on the bf16 table,
    K2rh sorted and seeded on the bf16 table; bit for bit in ``(t, prim,
    pops)``, and K2r bit for bit K2 on the same sorted rays in ``(t,
    prim)``. Then each is timed on the primary slab by CUDA events beside K2
    in the same order, with its twin's time and its bound (K2h's bytes count
    96-byte node boxes, its slab operations bf16 at the packed rate).
    Returns ``{kernel: kernels-line entry}`` and ``device_times()``."""
    sets = traversal_sets(wd, tables, stack, "tri", device, seed)
    nodes16 = pt.nodes_to_bf16(tables[0]).to(device)
    treelets = tuple(torch.as_tensor(x, device=device) for x in
                     pt.treelet_boxes(tables[0].cpu().numpy(), tables[1].cpu().numpy()))
    max_err = dict.fromkeys(K2_MODES, 0.0)
    calls = {}
    for name in ("primary", "bounce1"):
        ro, rd, t_init, active = sets[name]
        order, active_s, _, seeds = pt.sorted_rays(tables[0], tables[1], ro, rd, active,
                                                   treelets=treelets, restart=True)
        inf = torch.full_like(t_init, float("inf"))
        lane = (ro, rd, t_init, active)
        srt = (ro[order].contiguous(), rd[order].contiguous(), inf, active_s)
        count = seeds.counts()
        seeded = int(((count <= 8) & active_s).sum())
        rows = block_rows(tables, treelets, ro, rd, order, active_s)[:, 8]
        calls[name] = {"k2 sorted": (tables, srt, None), "k2r": (tables, srt, seeds),
                       "k2 lane": (tables, lane, None),
                       "k2h": ((nodes16, *tables[1:]), lane, None),
                       "k2rh": ((nodes16, *tables[1:]), srt, seeds)}
        got = {}
        for k, (tab, rays, sd) in calls[name].items():
            got[k] = pt.traverse(*tab, *rays, stack=stack, seeds=sd)
            if k not in K2_MODES:
                continue
            t, p, it = got[k]
            t2, p2, it2 = pt.packet_traverse_plain(*tab, *rays, stack=stack, seeds=sd)
            torch.cuda.synchronize()
            both = (p >= 0) & (p2 >= 0)
            err = float(torch.max(torch.abs(t[both] - t2[both]))) if bool(both.any()) else 0.0
            max_err[k] = max(max_err[k], err)
            same = bitwise_equal(t, t2) and bitwise_equal(p, p2) and bitwise_equal(it, it2)
            _log(f"[k2 modes] {k} on {name}: {ro.shape[0]} rays ({int(active.sum())} active), "
                 f"hit rate {float((p >= 0).float().mean()):.4f}, pops per ray mean "
                 f"{float(it.float().mean()):.4f}, bitwise equal to its twin (t, prim, pops): "
                 f"{same}, max |dt| {err:.3g}")
            if not same:
                raise AssertionError(f"{k} differs from its twin on '{name}'")
        (t, p, it), (t0, p0, it0) = got["k2r"], got["k2 sorted"]
        hits16, hits32 = got["k2h"][1] >= 0, got["k2 lane"][1] >= 0
        hist = torch.bincount(torch.clamp(count[active_s], max=9), minlength=10).tolist()
        _log(f"[k2 modes] {name}: {seeded} of {int(active_s.sum())} active rays seeded from "
             f"their own treelets (slots a ray: 0..8, >8: {hist}); the JAX package's "
             f"{rows.numel()} blocks of 1024 sorted rays would seed "
             f"{int(((rows >= 1) & (rows <= 8)).sum())}; K2r against K2 sorted: (t, prim) "
             f"bitwise {bitwise_equal(t, t0) and bitwise_equal(p, p0)}, pops per ray "
             f"{float(it.float().mean()):.4f} against {float(it0.float().mean()):.4f}; K2h hits "
             f"{int(hits16.sum())} against K2's {int(hits32.sum())} ({int((hits16 != hits32).sum())} "
             f"rays differ in hit/miss, {int((got['k2h'][1] != got['k2 lane'][1]).sum())} in prim)")
        if not (bitwise_equal(t, t0) and bitwise_equal(p, p0)):
            raise AssertionError(f"K2r differs from K2 on '{name}'")

    out, ms = {}, {}
    n = sets["primary"][0].shape[0]
    for k, (tab, rays, sd) in calls["primary"].items():
        ms[k] = cuda_ms(lambda tab=tab, rays=rays, sd=sd: pt.traverse(
            *tab, *rays, stack=stack, seeds=sd))
    _log(f"[k2 modes] time at {n} primary rays: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()) + " (CUDA events, median of 20)")
    for k, (name, seeded, bf16) in K2_MODES.items():
        tab, rays, sd = calls["primary"][k]
        plain_ms = cuda_ms(lambda: pt.packet_traverse_plain(*tab, *rays, stack=stack, seeds=sd),
                           iters=5, warmup=1)
        pops = int(pt.packet_traverse_plain(*tab, *rays, stack=stack, seeds=sd)[2].sum())
        node_bytes = (tab[0].shape[0] * BF16_BOX_BYTES if bf16 else nbytes(tab[0]))
        # the slab test's 24 operations a child, in bf16 at the packed rate
        # for K2h and K2rh (the widening and the f32 keys are not work)
        b = bound(node_bytes + nbytes(*tab[1:], *rays) + (nbytes(*sd) if seeded else 0)
                  + 12 * n, pops * 8 * SLAB_FLOP_PER_CHILD,
                  BF16X2_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
        _log(f"[{k}] time at {n} primary rays ({'sorted' if seeded else 'lane'} order): kernel "
             f"{ms[k]:.4f} ms, plain twin {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
             f"({b['bound_by']}), {pops / n:.4f} pops per ray")
        out[k] = {"name": name, "id": k, "route": "cuda",
                  "source": "learn_path_tracing_tpu_torch/csrc/packet_traverse.cu",
                  "replaces": K2_MODE_REPLACES, "max_abs_err": max_err[k], "ms": ms[k],
                  "plain_ms": plain_ms, **b, "library_ms": None}

    def device_times():
        cells = []
        for k, (tab, rays, sd) in calls["primary"].items():
            dev_ms = kernel_ms(lambda tab=tab, rays=rays, sd=sd: pt.traverse(
                *tab, *rays, stack=stack, seeds=sd), TRAVERSAL_KERNEL_NAMES[2])
            cells.append(f"{k} {dev_ms:.4f} ms")
            if k in out:
                out[k]["device_ms"] = dev_ms
        _log(f"[k2 modes device] {n} primary rays: {', '.join(cells)} (profiler, median of 20)")

    return out, device_times


LOCKSTEP_STRIDE = 32   # the walks' rays: every 32nd of the primary slab, 57,600


def lockstep_phase(mesh_wd, sph_wd, device):
    """``[lockstep walks]``: the port's plain lockstep walks
    (``accel.traverse.traverse``, ``accel.wide.traverse_wide``) over the
    trees the stand-in mesh's and the sphere world's tables were packed
    from, with the geometry leaf tests, on every ``LOCKSTEP_STRIDE``-th ray
    of the primary slab: they share no table or arithmetic with K2/K3.

    - K2 against each walk: hit masks equal, ``t`` within rtol 1e-4 / atol
      1e-5, ``prim`` equal on at least 95 % of hits
      (``tests/test_packet_traverse.py:62-65``); rays with a zero direction
      component left out (K2's hoisted slab form misses them on purpose);
    - K3 against each walk: hit masks equal, ``t`` within rtol 1e-5 / atol
      1e-6, ``prim`` equal except on ties within that bound;
    - the binary walk against the wide one: ``tests/test_wide_bvh.py:58-61``'s
      bounds (rtol 1e-6 / atol 1e-7, ``prim`` equal) except on exact ties.

    Prints each walk's CUDA-event time and step count; raises on a bound."""
    from learn_path_tracing_tpu_torch.accel.traverse import (make_sphere_leaf_test,
                                                             make_triangle_leaf_test, traverse)
    from learn_path_tracing_tpu_torch.accel.wide import collapse, traverse_wide
    from learn_path_tracing_tpu_torch.geometry.sphere import sphere_t
    from learn_path_tracing_tpu_torch.geometry.triangle import triangle_t

    prim, _, _ = primary_slab(device, LOCKSTEP_STRIDE)
    mesh, sph = mesh_wd.meshes[0], sph_wd.spheres
    cases = (
        ("k2", "tri", mesh, mesh.wide, make_triangle_leaf_test(mesh.v0, mesh.v1, mesh.v2),
         lambda i, o, d: triangle_t(mesh.v0[i], mesh.v1[i], mesh.v2[i], o, d),
         (1e-4, 1e-5)),
        ("k3", "sphere", sph, collapse(sph.bvh),
         make_sphere_leaf_test(sph.center, sph.radius, sph.transparency),
         lambda i, o, d: sphere_t(sph.center[i], sph.radius[i], sph.transparency[i], o, d),
         (1e-5, 1e-6)))
    for kernel, kind, data, wide, leaf_test, pair_t, (rtol, atol) in cases:
        ro, rd = prim.ro, prim.rd
        if kind == "tri":
            keep = (rd != 0).all(dim=1)
            ro, rd = ro[keep].contiguous(), rd[keep].contiguous()
        n = ro.shape[0]
        inf = torch.full((n,), float("inf"), device=device)
        t_k, p_k, _ = pt.traverse(*data.packet, ro, rd, inf, torch.ones_like(inf, dtype=bool),
                                  leaf_kind=kind, stack=data.stack)
        hit = p_k >= 0

        def tied(p_a, p_b, rtol=rtol, atol=atol):
            """Rays whose two primitives' ``t`` agree within the bounds."""
            a, b = (pair_t(torch.clamp_min(p, 0).long(), ro, rd) for p in (p_a, p_b))
            return torch.isclose(a, b, rtol=rtol, atol=atol)

        walks = {}
        for name, fn, tree in (("traverse", traverse, data.bvh),
                               ("traverse_wide", traverse_wide, wide)):
            t_w, p_w, steps = fn(tree, ro, rd, leaf_test, stats=True)
            ms = cuda_ms(lambda fn=fn, tree=tree: fn(tree, ro, rd, leaf_test), iters=3,
                         warmup=1)
            walks[name] = (t_w, p_w)
            both = hit & torch.isfinite(t_w)
            masks = int((hit != torch.isfinite(t_w)).sum())
            t_ok = bool(torch.allclose(t_w[both], t_k[both], rtol=rtol, atol=atol))
            err = float((t_w[both] - t_k[both]).abs().max()) if bool(both.any()) else 0.0
            differ = both & (p_w != p_k)
            untied = int((differ & ~tied(p_w, p_k)).sum())
            agree = 1.0 - int(differ.sum()) / max(int(both.sum()), 1)
            _log(f"[lockstep walks] {kind}: {name} over {tree.prim.shape[0]} primitives, "
                 f"{n} primary rays: {ms:.3f} ms (CUDA events, median of 3), {steps} "
                 f"lockstep steps; against {kernel}: hit rate {float(hit.float().mean()):.4f}, "
                 f"hit/miss mismatches {masks}, max |dt| {err:.3g} (within rtol {rtol:g} / "
                 f"atol {atol:g}: {t_ok}), prim agreement {agree:.6f} ({untied} off ties)")
            prim_ok = agree >= 0.95 if kind == "tri" else untied == 0
            if masks or not t_ok or not prim_ok:
                raise AssertionError(f"{kernel} and the {name} walk disagree ({kind})")
        (t_b, p_b), (t_w, p_w) = walks["traverse"], walks["traverse_wide"]
        both = torch.isfinite(t_b)
        masks = int((both != torch.isfinite(t_w)).sum())
        t_ok = bool(torch.allclose(t_b[both], t_w[both], rtol=1e-6, atol=1e-7))
        untied = int((both & (p_b != p_w) & ~tied(p_b, p_w, 0.0, 0.0)).sum())
        _log(f"[lockstep walks] {kind}: traverse against traverse_wide: hit/miss mismatches "
             f"{masks}, t within rtol 1e-6 / atol 1e-7: {t_ok}, prim mismatches "
             f"{int((both & (p_b != p_w)).sum())} ({untied} off ties)")
        if masks or not t_ok or untied:
            raise AssertionError(f"the binary and wide walks disagree ({kind})")


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
    one shading call of the l14 frame (``{name: (table, idx)}``): the first
    triangle-attribute, material pair-row and environment pair-row gathers
    of a one-slab ``render_hybrid``, and the atlas info table with the
    texture ids of the attribute call's lanes (what a multi-texture world
    gathers)."""
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
        render_hybrid(wd, standin_camera(MESH_RES).params(device), MESH_RES, spp=MESH_CHUNK,
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
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = tab.shape[0]
    idx = torch.randint(-3 * rows, 3 * rows, (4096,), generator=g)
    idx[:4] = torch.tensor([-2**31, 2**31 - 1, -rows - 1, rows])
    return idx.to(device)


def gather_bound(tab, idx) -> dict:
    """``bound()`` of a row gather: each distinct table row that the
    indices name read once, each output row written once, the indices read
    once; no arithmetic."""
    rows = tab.shape[0]
    r = torch.where(idx < 0, idx + rows, idx)
    distinct = torch.unique(r[(r >= 0) & (r < rows)]).numel()
    row_bytes = tab.shape[1] * tab.element_size()
    return bound((distinct + idx.numel()) * row_bytes + nbytes(idx), 0)


def check_row_gather(wd, device):
    """K6a and K6b against their plain version on the card, bit for bit
    (bf16 and NaN fill rows as bits): at ``profile_gather2.py``'s shapes
    (random and sorted indices), on the stand-in's four tables with one
    l14 shading call's indices, and on every table with wrapping and
    out-of-range indices in int32 and int64. Then the kernel,
    ``torch.index_select`` (the library call) and the plain version are
    timed in turns. Returns ``{kernel: kernels-line entry}`` at the main
    path's shapes (the stand-in's triangle-attribute and material pair-row
    calls) and ``device_times()``."""
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


# ------------------------------------------------- the legacy BSDF (K7) --

def legacy_lanes(n, seed, device, strided=False):
    """``(rays, hits, base)`` of ``n`` random lanes for the legacy BSDF from
    ``seed``, over its branches: ``metallic`` 0, 1 and fractional;
    transparent and opaque; ``roughness`` 0 and not; ``ior`` 1.5, 1 / 1.5,
    0 (l11's metal), 1e9 and random; ``absorptivity`` 0 and 0.5; a lane in
    11 at exactly grazing incidence and one in 13 on the normal's side.
    ``strided=True`` gives the material as column views of one ``[n, 8]``
    table, as a row gather leaves them."""
    import numpy as np

    from learn_path_tracing_tpu_torch.core.types import Hits, Materials, Rays

    r = np.random.default_rng(seed)
    lane = np.arange(n)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    nrm = unit(r.normal(size=(n, 3)))
    d = unit(r.normal(size=(n, 3)))
    facing = ((d * nrm).sum(-1) > 0) & (lane % 13 != 5)
    d[facing] = -d[facing]
    graze = lane % 11 == 3
    a = r.uniform(0, 2 * np.pi, size=int(graze.sum()))
    nrm[graze] = (0.0, 0.0, 1.0)
    d[graze] = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], axis=-1)
    ior = np.choose(lane % 5, [np.full(n, 1.5), np.full(n, 1 / 1.5), np.zeros(n),
                               np.full(n, 1e9), r.uniform(1.0, 2.4, n)])
    table = np.stack([*r.uniform(0, 1, (3, n)),                              # albedo
                      np.where(lane % 3 == 0, 0.0, r.uniform(0, 0.6, n)),    # roughness
                      np.choose(lane % 4, [np.zeros(n), np.ones(n), r.uniform(0, 1, n),
                                           np.zeros(n)]),                     # metallic
                      ior, (r.uniform(size=n) < 0.4).astype(np.float64),     # transparency
                      np.where(lane % 2 == 0, 0.5, 0.0)], axis=-1)           # absorptivity

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)

    tab = t(table)
    cols = {"albedo": tab[:, 0:3], **{k: tab[:, 3 + i] for i, k in enumerate(
        ("roughness", "metallic", "ior", "transparency", "absorptivity"))}}
    if not strided:
        cols = {k: v.contiguous() for k, v in cols.items()}
    point = t(r.normal(size=(n, 3)) * 5)
    rays = Rays(ro=point - t(d), rd=t(d), throughput=t(r.uniform(0.05, 1.0, (n, 3))),
                alive=torch.as_tensor(r.uniform(size=n) < 0.8, device=device))
    hits = Hits(t=torch.ones(n, device=device), point=point, normal=t(nrm),
                uv=torch.zeros((n, 2), device=device),
                obj=torch.zeros(n, dtype=torch.int32, device=device),
                hit=torch.ones(n, dtype=torch.bool, device=device), material=Materials(**cols))
    base = torch.as_tensor(r.integers(0, 2**32, n, dtype=np.int64), device=device)
    return rays, hits, base


def scatter_lanes_differ(got, want) -> dict:
    """``{field: (lanes that differ in bits, max |diff|)}`` of two
    ``Rays``' ``ro``, ``rd`` and ``throughput``, for the fields that
    differ."""
    out = {}
    for f in ("ro", "rd", "throughput"):
        x, y = getattr(got, f), getattr(want, f)
        lanes = int((x.view(torch.int32) != y.view(torch.int32)).any(-1).sum())
        if lanes:
            out[f] = (lanes, float((x - y).abs().max()))
    return out


def l11_lane_sets(device, res=(640, 360)):
    """l11's world (485 spheres, with its sphere BVH) and two lane sets on
    it at ``res``: the primary rays of orbit frame 0 and the first bounce
    pass after them. Returns ``(wd, {"primary" | "bounce1": (rays, hits,
    base)})``: ``hits`` from the plain twin (``packet_traverse_plain``),
    ``base`` the lanes' BSDF hash; the bounce is scattered by the legacy
    BSDF's plain body, so no set depends on a kernel under test."""
    from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_legacy_plain
    from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels, pixel_grid
    from learn_path_tracing_tpu_torch.core import rng
    from learn_path_tracing_tpu_torch.core.pytree import tree_where
    from learn_path_tracing_tpu_torch.scene.world import hit_record
    from learn_path_tracing_tpu_torch.stages import l11_bvh

    wd = l11_bvh.legacy_random_scene().device(device, use_bvh=True)
    pix = pixel_grid(res, device)
    rays = generate_rays_for_pixels(l11_bvh.orbit_camera(res, 0).params(device), res, pix, 0, 0)
    sets = {}
    for b, name in enumerate(("primary", "bounce1")):
        if b:
            rays_prev, hits_prev, base_prev = sets["primary"]
            scattered = scatter_legacy_plain(rays_prev, hits_prev, base_prev)
            survived = rays_prev.alive & hits_prev.hit
            rays = tree_where(survived, scattered, rays_prev).with_alive(survived)
        n = rays.count
        t, prim, _ = pt.packet_traverse_plain(
            *wd.bvh, rays.ro.contiguous(), rays.rd.contiguous(),
            torch.full((n,), float("inf"), device=device),
            torch.ones((n,), dtype=torch.bool, device=device), eps=ss.T_MIN,
            leaf_kind="sphere", stack=wd.bvh_stack)
        prim = torch.clamp_min(prim, 0)
        hits = hit_record(rays, t, prim, wd.scan_attrs[prim.to(torch.int64)])
        base = rng.base(rng.stream(0, 0, b, rng.STREAM_BSDF), pix.to(torch.int64))
        sets[name] = (rays, hits, base)
    return wd, sets


def check_legacy_scatter(device, l11):
    """K7 (``scatter_legacy`` on the card) against its plain twin
    ``scatter_legacy_plain`` on l11's lanes (``l11``, as ``l11_lane_sets``
    returns them), then on ``legacy_lanes`` at the same width, with the
    material contiguous and as strided views: ``ro``, ``rd`` and
    ``throughput`` bit for bit (a field that differs is named with its
    lanes and max |diff|), one launch over every lane a call. Then K7's call
    on the bounce lanes is timed by CUDA events beside the twin, with its
    bound (124 bytes a lane). Returns the kernels-line entry and
    ``device_times()``."""
    from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_legacy, scatter_legacy_plain

    sets = {f"l11 {name}": lanes for name, lanes in l11[1].items()}
    n = sets["l11 primary"][0].count
    sets["random"] = legacy_lanes(n, 22, device)
    sets["random, strided material"] = legacy_lanes(n, 23, device, strided=True)
    for name, (r, h, base) in sets.items():
        before = (ls.scatter.launches, ls.scatter.lanes)
        got = scatter_legacy(r, h, base)
        launched = (ls.scatter.launches - before[0], ls.scatter.lanes - before[1])
        want = scatter_legacy_plain(r, h, base)
        torch.cuda.synchronize()
        differ = scatter_lanes_differ(got, want)
        _log(f"[k7] {name}: {n} lanes ({int(h.hit.sum())} hit, {int(r.alive.sum())} alive), "
             f"launches and lanes {launched}; bitwise equal to the twin: "
             f"{'yes' if not differ else f'no, {differ}'}")
        if differ or launched != (1, n) or got.alive is not r.alive:
            raise AssertionError(f"K7 differs from its twin on '{name}': {differ}, {launched}")

    r, h, base = sets["l11 bounce1"]

    def run():
        ls.scatter(r, h, base)

    call_ms = cuda_ms(run)
    plain_ms = cuda_ms(lambda: scatter_legacy_plain(r, h, base))
    b = bound(n * ls.LANE_BYTES, 0)
    _log(f"[k7] time of the l11 bounce-1 call, {n} lanes: the call {call_ms:.4f} ms by CUDA "
         f"events, plain twin {plain_ms:.4f} ms (median of 20 each), bound "
         f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {ls.LANE_BYTES} B a lane)")
    entry = {"name": "legacy_scatter", "id": "k7", "route": "cuda",
             "source": "learn_path_tracing_tpu_torch/csrc/legacy_scatter.cu",
             "replaces": "none: XLA's fusion of learn_path_tracing_tpu/bsdf/bsdf.py:"
                         "scatter_legacy", "ms": call_ms, "plain_ms": plain_ms, **b,
             "library_ms": None, "max_abs_err": 0.0}

    def device_times():
        ms = kernel_ms(run, "legacy_scatter_kernel")
        entry["device_ms"] = ms
        _log(f"[k7 device] the l11 bounce-1 call, {n} lanes: kernel {ms:.4f} ms on the device "
             f"(profiler, median of 20), {b['bound_ms'] / ms:.3f} of the bound")

    return entry, device_times


# ------------------------------------------- multi-device (--multichip) --

MC_PERSISTENT_SPP = 8                  # the sharded cover-scene cell: spp cut from 64
MC_WAVEFRONT_RES, MC_WAVEFRONT_SPP = (320, 180), 4


def all_launches() -> dict:
    """Every kernel's launches so far, a CUDA graph's replays included
    (``ops.kernel_counters``)."""
    return {k: c["launches"] for k, c in kernel_counters().items()}


def counted_frame(fn):
    """``fn()``, synchronised; returns ``(result, seconds, launches during
    it, sphere hit queries, shading calls)``. The hit queries are the
    passes: the persistent engine's ``lpt.persistent.pass`` spans and the
    wavefront's ``lpt.wavefront.pass`` spans (one query a pass, eager or
    replayed from a CUDA graph, whose inner spans, the hit query's among
    them, open only at its capture). The launches are ``kernel_counters``',
    which count a replay's."""
    torch.cuda.synchronize()
    before = all_launches()
    t0 = time.perf_counter()
    with (recording(True, "chip_smoke.frame", kernel_counters) as table,
          shading_calls() as shading):
        out = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in all_launches().items()}
    hits = sum(table.spans.get(name, [0])[0]
               for name in ("lpt.persistent.pass", "lpt.wavefront.pass"))
    return out, seconds, launches, hits, shading


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
    """``[multichip]``: an NCCL group of world size 1 on the card and, over
    its 1x1 mesh, the three sharded functions, each after its single-device
    render, with the counts set to 0 before each: the hybrid on the
    stand-in at 1280x720, 64 spp (K2 once per traversal call, K6a/K6b as
    its shading calls imply, K7 once per legacy BSDF call), the persistent
    engine on the cover scene at 1280x720, 8 spp, and the wavefront at
    320x180, 4 spp (K1 once per hit query), depth 32, nothing else: each
    sharded frame the single-device one bit for bit, with its segments and
    launches. Then the int64 accumulator's collectives are timed (at world
    size 1 a copy on the card). With more than one card,
    ``multichip_cards``. Returns each cell's single-device result."""
    import torch.distributed as dist

    from learn_path_tracing_tpu_torch.parallel import launch
    from learn_path_tracing_tpu_torch.parallel import mesh as pm

    cells = multichip_cells(device, world_path)
    refs = {}
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
            (img, segs, *st), t_single, l_single, _, shading = counted_frame(
                lambda: single(wd, cp, res, spp, limit=DEPTH, **kw))
            (img_m, segs_m), t_sharded, l_sharded, hits_m, shading_m = counted_frame(
                lambda: sharded(wd, cp, res, spp, m, limit=DEPTH))
            if name == "hybrid":
                calls = st[0]["n_chunks"] + st[0]["passes"]
                want = dict(k2=calls, k7=shading_m["scatter"], **expected_gathers(wd, shading_m))
                kept = {k: l_sharded[k] for k in ("k2", "k6a", "k6b", "k7")}
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
    return refs


def multichip_cards(cells, refs, world_path, device, cards):
    """The multi-card part of ``[multichip]``: one job of ``cards`` ranks
    (``bench_torch.sharded_cells``) renders each cell of ``cells`` as
    ``cards`` tiles and, with an even count, as (cards / 2) tiles x 2 spp;
    rank 0's images must be ``refs``' bit for bit (the wavefront's spp
    split within rtol 1e-5, atol 1e-6), with the same segments. Prints the
    frames' seconds and the collectives' times between the cards."""
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
    range-local integrators run each (pixel range, sample range) of each
    cell and the results are combined as the collectives combine them:
    persistent and hybrid bit for bit the single-device frames, the
    wavefront within rtol 1e-5, atol 1e-6; the segments equal."""
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


def multichip_only(device, directory):
    """``--multichip``: the stand-in world built and saved, ``[multichip]``
    (its world-size-1 cells, then, with more than one card, each cell on
    every card against them), ``[multichip split]`` on the world-size-1
    frames, and ``python -m learn_path_tracing_tpu_torch multichip --nproc
    <cards> --device cuda`` as a subprocess (must exit 0)."""
    world = standin_world(directory)
    build_quiet(world, device=device)
    path = os.path.join(directory, "standin.world.npy")
    world.save(path)
    multichip_split(multichip_phase(device, path))
    multichip_cli()


def multichip_cli():
    """``python -m learn_path_tracing_tpu_torch multichip --nproc <cards>``
    as a subprocess from the checkout's root (the dry run, one NCCL rank a
    card, started by ``parallel.launch``); it must exit 0."""
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


def packet_times(device, directory):
    """``--packet-times``: K2, K5a and K5b on the stand-in mesh's five ray
    sets and K3 on the sphere world's four, each against the twin
    (``check_packet``), ``bvh_phase``, then every device time."""
    world = standin_world(directory)
    mesh_wd = world.build(device=device)
    tri = mesh_wd.meshes[0]
    _, tri_device_times = check_packet(mesh_wd, tri.packet, tri.stack, "tri", device, seed=7)
    sph_wd = build_quiet(sphere_world(), device=device)
    sph = sph_wd.spheres
    _, sph_device_times = check_packet(sph_wd, sph.packet, sph.stack, "sphere", device, seed=8)
    bvh_device_times = bvh_phase(device)
    tri_device_times()
    sph_device_times()
    bvh_device_times()


def k2_mode_times(device, directory):
    """``--k2-modes``: K2's modes alone on the stand-in mesh
    (``check_k2_modes``: each against its twin, K2r against K2, the seeds,
    the CUDA-event times, then the device times), with K2 on the primary
    slab in lane and sorted order beside them."""
    world = standin_world(directory)
    mesh_wd = world.build(device=device)
    tri = mesh_wd.meshes[0]
    _, mode_device_times = check_k2_modes(mesh_wd, tri.packet, tri.stack, device, seed=9)
    mode_device_times()


def build_kernels():
    """Build every kernel at once (one nvcc per source, in parallel, and the
    native BVH builder's g++ beside them) and print ptxas's register,
    memory and spill lines."""
    from concurrent.futures import ThreadPoolExecutor

    from learn_path_tracing_tpu_torch.accel import native
    from learn_path_tracing_tpu_torch.ops import (bounce_megakernel, build, legacy_scatter,
                                                  packet_traverse, row_gather, sphere_scan)

    loaders = {"sphere_scan": sphere_scan.load_kernel,
               "packet_traverse": packet_traverse.load_kernel,
               "bounce_megakernel": bounce_megakernel.load_kernel,
               "row_gather": row_gather.load_kernel,
               "legacy_scatter": legacy_scatter.load_kernel,
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

    ap = argparse.ArgumentParser(description="Each kernel of the port against its twin on a GPU.")
    ap.add_argument("--packet-times", action="store_true",
                    help="only check and time the packet kernels (see packet_times)")
    ap.add_argument("--k2-modes", action="store_true",
                    help="only check and time K2's modes (see k2_mode_times)")
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
    if args.multichip or args.packet_times or args.k2_modes:
        with tempfile.TemporaryDirectory() as directory:
            if args.multichip:
                multichip_only(device, directory)
            elif args.packet_times:
                packet_times(device, directory)
            else:
                k2_mode_times(device, directory)
        print(card)
        return 0

    # the profiler's device times come last (see kernel_ms)
    k1, k1_device_times = check_sphere_scan(device)
    bvh_device_times = bvh_phase(device)
    k4, k4_device_times = check_bounce_megakernel(device)
    k7, k7_device_times = check_legacy_scatter(device, l11_lane_sets(device))
    with tempfile.TemporaryDirectory() as directory:
        t0 = time.time()
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # its PBR set and EXR must load
            mesh_wd = standin_world(directory).build(device=device)
        if mesh_wd.env_gradient_h is not None:
            raise AssertionError("the stand-in's EXR environment did not load")
        tri = mesh_wd.meshes[0]
        _log(f"[stand-in] {tri.tex.shape[0]} triangles, {tri.packet[0].shape[0]} wide nodes, "
             f"{tri.packet[2].shape[0]} run rows, stack {tri.stack}; built in "
             f"{time.time() - t0:.2f} s")
        tri_kernels, tri_device_times = check_packet(mesh_wd, tri.packet, tri.stack, "tri",
                                                     device, seed=7)
        mode_kernels, mode_device_times = check_k2_modes(mesh_wd, tri.packet, tri.stack,
                                                         device, seed=9)
        gather_kernels, gather_device_times = check_row_gather(mesh_wd, device)
    t0 = time.time()
    sph_wd = build_quiet(sphere_world(), device=device)
    sph = sph_wd.spheres
    _log(f"[sphere world] {N_SPHERES} spheres, {sph.packet[0].shape[0]} wide nodes, "
         f"stack {sph.stack}; built in {time.time() - t0:.2f} s")
    sph_kernels, sph_device_times = check_packet(sph_wd, sph.packet, sph.stack, "sphere",
                                                 device, seed=8)
    lockstep_phase(mesh_wd, sph_wd, device)

    for device_times in (k1_device_times, bvh_device_times, k4_device_times, k7_device_times,
                         tri_device_times, mode_device_times, sph_device_times,
                         gather_device_times):
        device_times()
    found = {**tri_kernels, **mode_kernels, **gather_kernels, **sph_kernels}
    kernels = [k1, *(found[k] for k in ("k2", "k2r", "k2h", "k2rh", "k3")), k4,
               *(found[k] for k in ("k5a", "k5b", "k6a", "k6b")), k7]
    for entry in kernels:           # a device time the profiler lost is null
        if entry.get("device_ms") != entry.get("device_ms"):
            entry["device_ms"] = None
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
