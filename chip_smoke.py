#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``learn_path_tracing_tpu_torch``: the stage-10
cover scene through ``stages.common.run_path_traced`` →
``integrator.persistent.render_persistent`` → ``scene.world.hit`` → the
sphere-scan kernel) and checks it:

1. prints the card, its power limit, and the torch and CUDA versions;
2. builds every kernel of the path from the sources in the checkout;
3. holds each kernel against its plain PyTorch twin on the card, at the
   main path's shapes (the 57,344-ray primary wavefront of the cover scene
   at 1280x720, its first bounce, and random rays, some inside glass
   spheres): bitwise equal, timed with CUDA events (median of 20 runs);
4. renders a small image on the card and on the CPU and holds them to the
   agreement bounds of ``utils.checks`` (the CPU tests hold the port to the
   JAX package with the same bounds);
5. renders the full 1280x720, 64 spp, depth-32 cover scene after a warm-up,
   with every kernel launch count reset just before, and checks that the
   sphere-scan kernel was launched once per ``hit`` call and that the image
   is finite with a sane mean; writes ``outputs/chip_smoke_10_final.png``.

Any failed phase raises, so the script exits non-zero. The last lines are
the ``nvidia-smi`` name and power limit, a JSON line of the kernels, and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

RES = (1280, 720)
SPP = 64
DEPTH = 32
SCENE_SEED = 20230328
SMALL_RES, SMALL_SPP, SMALL_LIMIT = (64, 36), 4, 8


def _log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of ``fn()`` on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bitwise_equal(x, y) -> bool:
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return bool(torch.equal(x, y))


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


def check_sphere_scan(device):
    """K1 against its plain twin on the card; returns the kernels-line entry."""
    import torch

    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss

    wd, sets = scan_inputs(device)
    max_err = 0.0
    for name, (ro, rd) in sets.items():
        t, idx, attr = ss.intersect_spheres_scan(ro, rd, wd.scan_table, wd.scan_attrs)
        t2, idx2, attr2 = ss.intersect_spheres_scan_plain(ro, rd, wd.scan_table,
                                                          wd.scan_attrs)
        torch.cuda.synchronize()
        hit_k, hit_p = torch.isfinite(t), torch.isfinite(t2)
        both = hit_k & hit_p
        err = float(torch.max(torch.abs(t[both] - t2[both]))) if bool(both.any()) else 0.0
        err = max(err, float(torch.max(torch.abs(attr - attr2))))
        max_err = max(max_err, err)
        same = (bitwise_equal(t, t2) and bitwise_equal(idx, idx2)
                and bitwise_equal(attr, attr2))
        _log(f"[k1] {name}: {ro.shape[0]} rays, hit rate "
             f"{float(hit_k.float().mean()):.4f}, bitwise equal: {same}, "
             f"max |diff| {err:.3g}, hit/miss mismatches "
             f"{int((hit_k != hit_p).sum())}, idx mismatches {int((idx != idx2).sum())}")
        if not same:
            raise AssertionError(f"sphere-scan kernel differs from its twin on '{name}'")

    ro, rd = sets["primary"]
    ms = cuda_ms(lambda: ss.intersect_spheres_scan(ro, rd, wd.scan_table, wd.scan_attrs))
    plain_ms = cuda_ms(lambda: ss.intersect_spheres_scan_plain(
        ro, rd, wd.scan_table, wd.scan_attrs))
    _log(f"[k1] time at {ro.shape[0]} rays x {wd.scan_table.shape[0]} spheres: "
         f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms (median of 20)")
    return {"name": "sphere_scan", "route": "cuda",
            "source": "learn_path_tracing_tpu_torch/csrc/sphere_scan.cu",
            "replaces": "learn_path_tracing_tpu/ops/sphere_scan.py:49",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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


def headline(device):
    import numpy as np
    import torch

    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
    from learn_path_tracing_tpu_torch.ops import sphere_scan as ss
    from learn_path_tracing_tpu_torch.stages.common import run_path_traced
    from learn_path_tracing_tpu_torch.utils.config import STAGE_CONFIGS

    world = random_scene(seed=SCENE_SEED)
    cam = stage10_camera(RES)
    t0 = time.time()
    render_persistent(world.device(device), cam.params(device), RES, spp=1,
                      limit=DEPTH, seed=-1)
    torch.cuda.synchronize()
    _log(f"[headline] warm-up (spp 1) {time.time() - t0:.2f} s")

    cfg = STAGE_CONFIGS[10].with_(width=RES[0], height=RES[1], spp=SPP,
                                  propagate_limit=DEPTH, device=device,
                                  out="outputs/chip_smoke_10_final.png")
    ss.intersect_spheres_scan.launches = 0
    img, rep = run_path_traced(world, cam, cfg, "10_final.png")
    launches = ss.intersect_spheres_scan.launches
    arr = img.cpu().numpy()
    mean = float(arr.mean())
    chunk = rep["chunks"][0]
    _log(f"[headline] {RES[0]}x{RES[1]} spp {SPP} depth {DEPTH}: "
         f"{rep['seconds']:.3f} s, {rep['segments']} segments, "
         f"{rep['mrays']:.3f} Mrays/s, {rep['passes']} passes (pool {chunk['pool']}, "
         f"full-width {chunk['passes_full']}, drain widths {chunk['drain_widths']}, "
         f"drain passes {chunk['drain_passes']}), sphere-scan launches {launches}, "
         f"image mean {mean:.5f}")
    if launches != rep["passes"]:
        raise AssertionError(f"sphere-scan launches {launches} != hit calls {rep['passes']}")
    if not np.isfinite(arr).all() or not 0.05 < mean < 0.95:
        raise AssertionError(f"headline image is not sane: mean {mean}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from learn_path_tracing_tpu_torch.ops import build, sphere_scan

    card = card_line()
    _log(f"[info] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    device = "cuda"

    t0 = time.time()
    sphere_scan.load_kernel()
    _log(f"[build] sphere_scan built and loaded in {time.time() - t0:.2f} s")
    for line in build.BUILD_LOGS.get("sphere_scan", "").splitlines():
        _log(f"[build]   {line}")

    entry = check_sphere_scan(device)
    check_gpu_vs_cpu(device)
    entry["launches"] = headline(device)

    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
