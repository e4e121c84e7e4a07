"""Legacy stage 13: one PBR-textured unit sphere under an equirect
environment map (the reference's 13_texture.py:638-663), camera at
(13, 2, 3)·0.3, fov 30, rendered by the wavefront integrator with the
legacy BSDF.

    python -m learn_path_tracing_tpu_torch.stages.l13_texture \\
        [--assets DIR --width W --height H --spp N --limit D --device cuda|cpu]

The reference's run-dir-relative asset paths (``./textures/sandyground1``,
``./textures/cayley_interior_2k.exr``) resolve against ``--assets``
(default: the current directory). Missing assets fall back to the neutral
material and the sky gradient, with a warning each. The render runs on the
card unless ``--device cpu`` is given.
"""

import argparse
import time

from ..camera import LegacyCamera
from ..integrator.wavefront import render
from ..ops.row_gather import gather
from ..scene.legacy_world import LegacyWorld
from ..utils.config import STAGE_CONFIGS
from .common import _sync, parse_args
from .legacy_common import make_asset_path_map, save_frame

TEXTURE = "./textures/sandyground1"
ENVIRONMENT = "./textures/cayley_interior_2k.exr"


def scene(path_map, resolution):
    """The stage's populated ``LegacyWorld`` (call ``build()``) and its
    ``LegacyCamera``; ``path_map`` rewrites the reference's asset paths."""
    world = LegacyWorld()
    world.textures.add(path_map(TEXTURE), 0, size=(2048, 2048))
    world.environments.add(path_map(ENVIRONMENT), 0, size=(2048, 1024))
    world.add_sphere((0, 0, 0), 1.0, transparency=0, texture_id=0)
    world.set_environment(0)
    cam = LegacyCamera(resolution)
    cam.set_fov(30)
    cam.set_position((13 * 0.3, 2 * 0.3, 3 * 0.3))
    cam.look_at((0, 0, 0))
    return world, cam


def main(argv=None):
    """Render the stage; returns ``(image f32[W,H,3] gamma-corrected,
    report)`` with the wall seconds, segments, Mrays/s, the linear image
    (``linear``), the row-gather kernel launches of the render by kernel
    (``launches``: none on the CPU, where the plain version runs), the
    world's tensors (``world``) and whether the environment is the
    sky-gradient fallback (``env_gradient``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--assets", default=".",
                   help="directory the reference's './textures/...' paths resolve against")
    known, rest = p.parse_known_args(argv)
    args = parse_args(STAGE_CONFIGS["l13"], description=__doc__, argv=rest)
    res = (args.width, args.height)

    world, cam = scene(make_asset_path_map(known.assets), res)
    wd = world.build(device=args.device)
    before = dict(gather.launches)
    _sync(args.device)
    start = time.time()
    img, segs = render(wd, cam.params(args.device), res, spp=args.spp, limit=args.limit,
                       seed=args.seed, bsdf=args.bsdf, scene="legacy",
                       early_exit=args.early_exit)
    _sync(args.device)
    elapsed = time.time() - start
    launches = {k: n - before[k] for k, n in gather.launches.items() if n != before[k]}
    mrays = segs / max(elapsed, 1e-9) / 1e6
    print(f"Time elapsed: {elapsed:.2f}s  ({segs:.3e} ray segments, {mrays:.1f} Mrays/s "
          f"on {args.device}; row-gather launches {launches})")
    out = img ** (1 / 2.2)
    path = args.out or "outputs/l13_texture.png"
    save_frame(out, path)
    return out, {"seconds": elapsed, "segments": segs, "mrays": mrays, "out": path,
                 "linear": img, "launches": launches, "world": wd,
                 "env_gradient": wd.env_gradient_h is not None}


if __name__ == "__main__":
    main()
