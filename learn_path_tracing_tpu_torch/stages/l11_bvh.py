"""Legacy stage 11: sphere BVH + orbiting camera (the reference's
11_bvh.py:487-535): the cover scene with legacy materials (absorptivity,
continuous roughness), SAH sphere BVH, fov 20, thin lens (10, 0.1), camera
orbiting at radius 15, rendered by the wavefront integrator with the legacy
BSDF. Frames are written as PNGs (the reference's window has no analog).

    python -m learn_path_tracing_tpu_torch.stages.l11_bvh \\
        [--hit-backend auto|bvh --out X.png --width W --height H --spp N --device cuda|cpu]

``--hit-backend auto`` scans the spheres (K1 on the card); ``bvh`` walks
the scene's sphere BVH (K3). Without ``--out`` the stage writes eight
orbit frames ``outputs/l11_bvh_NNN.png``; with it, the first frame only.
The render runs on the card unless ``--device cpu`` is given.
"""

import math
import random as _random
import time

from ..camera import LegacyCamera
from ..core.types import Material
from ..integrator.wavefront import render
from ..scene.world import Sphere, World
from ..utils.config import STAGE_CONFIGS
from .common import _sync, parse_args
from .legacy_common import save_frame

FRAMES = 8


def legacy_random_scene(size=11, seed=1234) -> World:
    """The stage's world; Python's ``random`` with the JAX package's seed
    places the same spheres."""
    rng = _random.Random(seed)
    world = World()
    world.add(Sphere((0, -10000, 0), 10000, Material(
        albedo=(1, 1, 1), roughness=1, metallic=0, ior=1.5, absorptivity=0.5)))
    for a in range(-size, size):
        for b in range(-size, size):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if ((center[0] - 4) ** 2 + center[2] ** 2) ** 0.5 > 0.9:
                albedo = (rng.random(), rng.random(), rng.random())
                if choose < 0.8:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=albedo, roughness=1, metallic=0, ior=1.5)))
                elif choose < 0.95:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=tuple(0.5 + 0.5 * c for c in albedo),
                        roughness=0.5 * rng.random(), metallic=1, ior=0)))
                else:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=tuple(0.75 + 0.25 * c for c in albedo),
                        roughness=0.2 * rng.random(), metallic=0, ior=1.5,
                        transparency=1)))
    world.add(Sphere((0, 1, 0), 1.0, Material(albedo=(1, 1, 1), roughness=0,
                                              metallic=0, ior=1.5, transparency=1)))
    world.add(Sphere((-4, 1, 0), 1.0, Material(albedo=(0.4, 0.2, 0.1),
                                               roughness=1, metallic=0, ior=1.5)))
    world.add(Sphere((4, 1, 0), 1.0, Material(albedo=(0.7, 0.6, 0.5),
                                              roughness=0, metallic=1, ior=0)))
    return world


def orbit_camera(res, i) -> LegacyCamera:
    """The camera of orbit frame ``i``."""
    cam = LegacyCamera(res)
    cam.set_fov(20)
    cam.set_len(10, 0.1)
    cam.set_position((15 * math.cos(0.1 * i + 1e-4), 2, 15 * math.sin(0.1 * i + 1e-4)))
    cam.look_at((0, 0, 0))
    return cam


def main(argv=None):
    """Render the orbit; returns ``(last frame f32[W,H,3] gamma-corrected,
    report)`` with its wall seconds, segments, Mrays/s and linear image
    (``linear``). Frame ``i`` renders with the seed ``--seed`` + ``i``."""
    args = parse_args(STAGE_CONFIGS["l11"], description=__doc__, argv=argv)
    res = (args.width, args.height)
    wd = legacy_random_scene().device(args.device, use_bvh=True)
    for i in range(FRAMES):
        cam = orbit_camera(res, i)
        _sync(args.device)
        start = time.time()
        img, segs = render(wd, cam.params(args.device), res, spp=args.spp,
                           limit=min(args.limit, 10), seed=args.seed + i, bsdf="legacy",
                           hit_backend=args.hit_backend, early_exit=args.early_exit)
        _sync(args.device)
        elapsed = time.time() - start
        mrays = segs / max(elapsed, 1e-9) / 1e6
        print(f"frame {i}: {elapsed:.2f}s ({segs:.3e} ray segments, {mrays:.1f} Mrays/s, "
              f"hit backend {args.hit_backend} on {args.device})")
        out = img ** (1 / 2.2)
        path = args.out or f"outputs/l11_bvh_{i:03d}.png"
        save_frame(out, path)
        if args.out:
            break
    return out, {"seconds": elapsed, "segments": segs, "mrays": mrays, "out": path,
                 "linear": img}


if __name__ == "__main__":
    main()
