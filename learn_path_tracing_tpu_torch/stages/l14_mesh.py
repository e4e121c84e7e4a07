"""Legacy stage 14: triangle meshes from a serialized world
(the reference's 14_mesh.py:1020 loads a prebuilt ``.world.npy`` instead of
rebuilding the BVH), rendered with progressive accumulation (one batch of
``--spp`` samples) through the hybrid integrator.

    python -m learn_path_tracing_tpu_torch.stages.l14_mesh --world path/to/x.world.npy \\
        [--width W --height H --spp N --limit D --device cuda|cpu]

The world's relative texture paths ('./textures/…') resolve against the
directory of the world file.
"""

import argparse
import os
import time
import warnings

import torch

from ..camera import LegacyCamera
from ..scene.legacy_world import LegacyWorld
from ..utils.config import STAGE_CONFIGS
from ..viewer.progressive import ProgressiveRenderer
from .common import _sync, parse_args
from .legacy_common import make_asset_path_map, save_frame


def main(argv=None):
    """Render one progressive batch; returns ``(frame f32[W,H,3], report)``
    with the wall seconds, segments, Mrays/s, the hybrid integrator's pass
    counts, the loader's fallback warnings (``load_warnings``) and whether
    the environment is the sky-gradient fallback (``env_gradient``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--world", required=True, help="path to a .world.npy file")
    known, rest = p.parse_known_args(argv)
    args = parse_args(STAGE_CONFIGS["l14"], description=__doc__, argv=rest)
    res = (args.width, args.height)
    path = known.world

    # a missing texture or environment falls back quietly (neutral fill, sky
    # gradient); the report lists each fallback
    world = LegacyWorld()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wd = world.load(path, path_map=make_asset_path_map(os.path.dirname(path)),
                        device=args.device)
    load_warnings = [str(w.message) for w in caught]

    cam = LegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))

    # 'jitter' is bit-identical to the legacy camera's degenerate thin lens
    # (aperture 0, focal length 1) and skips its disk sample
    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp,
                             limit=args.limit, seed=args.seed, bsdf="legacy",
                             scene="legacy", camera_model="jitter")
    _sync(args.device)
    start = time.time()
    frame = pr.render(moved=True)
    _sync(args.device)
    elapsed = time.time() - start
    st = pr.last_stats
    mrays = st["segments"] / max(elapsed, 1e-9) / 1e6
    print(f"Time elapsed: {elapsed:.2f}s  ({st['segments']:.3e} ray segments, "
          f"{mrays:.1f} Mrays/s, {st['n_chunks']} slabs + {st['passes']} pool "
          f"passes on {args.device})")
    out = args.out or f"outputs/l14_{os.path.basename(path).split('.')[0]}.png"
    save_frame(frame, out)
    return frame, dict(st, seconds=elapsed, mrays=mrays, out=out,
                       primary_hit_fraction=st["primary_hits"] / (res[0] * res[1] * args.spp),
                       load_warnings=load_warnings,
                       env_gradient=wd.env_gradient_h is not None)


if __name__ == "__main__":
    main()
