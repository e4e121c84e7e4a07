"""Shared plumbing for the staged tutorial scripts.

Counterpart of ``learn_path_tracing_tpu.stages.common``: each stage module
mirrors one reference stage (same scene, camera, resolution and spp defaults,
same output filename under ``outputs/``). Run as
``python -m learn_path_tracing_tpu_torch.stages.s10_final [--spp N] [--device cuda|cpu]``
(the card unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..camera.camera import CameraParams, generate_rays
from ..core import color, image
from ..integrator.persistent import render_persistent
from ..integrator.wavefront import sky_background
from ..scene import world as world_mod
from ..utils.config import RenderConfig

# Work items (pixels * spp) per render_persistent call. The JAX package sized
# this to keep each device call under its runtime's watchdog; the port keeps
# the same chunk schedule because each chunk's RNG seed is ``seed + first
# sample``, so the same schedule gives the same image.
CHUNK_WORK_ITEMS = 250_000_000


def require_device(device) -> None:
    """Raise unless ``device`` can run here: asking for CUDA (the default)
    on a machine without a CUDA device fails instead of rendering on the
    CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to render on the CPU")


def parse_args(cfg: RenderConfig, description="", argv=None) -> RenderConfig:
    """CLI over a stage's RenderConfig preset; returns the merged config.
    Raises (``require_device``) if the device cannot run here."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--width", type=int, default=cfg.width)
    p.add_argument("--height", type=int, default=cfg.height)
    p.add_argument("--spp", type=int, default=cfg.spp)
    p.add_argument("--out", type=str, default=cfg.out)
    p.add_argument("--limit", type=int, default=cfg.propagate_limit,
                   help="bounce limit")
    p.add_argument("--seed", type=int, default=cfg.seed)
    p.add_argument("--device", type=str, default=cfg.device,
                   help="torch device to render on (default: cuda; the CPU "
                        "only when asked for with --device cpu)")
    p.add_argument("--hit-backend", type=str, default=cfg.hit_backend,
                   choices=["auto", "cuda", "xla", "bvh"],
                   help="scene.world.hit backend; 'bvh' builds the sphere BVH and "
                        "walks it (kernel K3 on the card)")
    a = p.parse_args(argv)
    require_device(a.device)
    return cfg.with_(width=a.width, height=a.height, spp=a.spp, out=a.out,
                     propagate_limit=a.limit, seed=a.seed, device=a.device,
                     hit_backend=a.hit_backend)


def _shade_normals(world_data, rays):
    hits = world_mod.hit(world_data, rays)
    return torch.where(hits.hit[:, None], 0.5 * (hits.normal + 1.0),
                       sky_background(rays.rd))


def render_normal_shaded(world_data, cam: CameraParams, resolution,
                         camera_model: str = "center"):
    """Primary-ray visualization used by stages 3-5: hit → 0.5*(normal+1),
    miss → sky gradient (3_adding_a_sphere/__main__.py:27-40)."""
    rays = generate_rays(cam, resolution, 0, 0, model=camera_model)
    w, h = resolution
    return _shade_normals(world_data, rays).reshape(w, h, 3)


def render_normal_shaded_aa(world_data, cam: CameraParams, resolution, spp: int,
                            camera_model: str = "thinlens"):
    """Stage 5: jittered primary rays accumulated over spp."""
    w, h = resolution
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=cam.device)
    for s in range(spp):
        acc = acc + _shade_normals(
            world_data, generate_rays(cam, resolution, 0, s, model=camera_model))
    return (acc / spp).reshape(w, h, 3)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_path_traced(world, camera, cfg: RenderConfig, out_name, post=True):
    """Timed full render + post-process + PNG write (the render() pattern of
    10_final/__main__.py:99-118).

    The spp axis is split into chunks of at most ``CHUNK_WORK_ITEMS`` work
    items; chunk results average into the final image, each chunk with the
    seed ``cfg.seed + first sample`` (plain progressive MC accumulation).
    Returns ``(image f32[W,H,3], report)``; the report holds the wall
    seconds, segments, Mrays/s, the integrator's pass counts and the linear
    image before post-processing.
    """
    res = (cfg.width, cfg.height)
    dev = cfg.device
    require_device(dev)
    wd = world.device(dev, use_bvh=cfg.hit_backend == "bvh")
    cp = camera.params(dev)

    n_pix = cfg.width * cfg.height
    ideal = max(1, min(cfg.spp, CHUNK_WORK_ITEMS // n_pix))
    # prefer a power-of-two chunk dividing the pixel count (the grouped
    # schedule of render_persistent needs spp | n)
    chunk = ideal
    for c in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2):
        if c <= ideal and n_pix % c == 0:
            chunk = c
            break
    _sync(dev)
    start = time.time()
    acc = torch.zeros((cfg.width, cfg.height, 3), dtype=torch.float32, device=dev)
    segs_total, done, passes, chunks = 0, 0, 0, []
    while done < cfg.spp:
        s = min(chunk, cfg.spp - done)
        img, segs, st = render_persistent(
            wd, cp, res, spp=s, limit=cfg.propagate_limit,
            seed=cfg.seed + done, bsdf=cfg.bsdf, scene=cfg.scene,
            camera_model=cfg.camera_model, hit_backend=cfg.hit_backend,
            stats=True)
        acc = acc + img * (s / cfg.spp)
        segs_total += segs
        passes += st["passes_full"] + sum(st["drain_passes"])
        chunks.append(st)
        done += s
    img = color.post_process(acc) if post else acc
    _sync(dev)
    elapsed = time.time() - start
    mrays = segs_total / max(elapsed, 1e-9) / 1e6
    print(f"Time elapsed: {elapsed:.2f}s  ({segs_total:.3e} ray segments, "
          f"{mrays:.1f} Mrays/s, {passes} passes on {dev})")

    out = cfg.out or f"outputs/{out_name}"
    image.write_png(img, out)
    print(f"wrote {out}")
    return img, {"seconds": elapsed, "segments": segs_total, "mrays": mrays,
                 "passes": passes, "chunks": chunks, "out": out, "linear": acc}
