"""Legacy stage 14: triangle meshes from a serialized world
(the reference's 14_mesh.py:1020 loads a prebuilt ``.world.npy`` instead of
rebuilding the BVH), rendered with progressive accumulation (one batch of
``--spp`` samples) through the hybrid integrator or the wavefront engine.

    python -m learn_path_tracing_tpu_torch.stages.l14_mesh --world path/to/x.world.npy \\
        [--width W --height H --spp N --limit D --device cuda|cpu \\
         --packet-version 1|2|3 --engine hybrid|wavefront]

``--packet-version`` is the JAX package's ``LPT_PACKET_VERSION``: the mesh
traversal kernel (2: K2, 1: K5a, 3: K5b; the image does not depend on it).
The world's relative texture paths ('./textures/…') resolve against the
directory of the world file. The render runs on the card unless
``--device cpu`` is given.
"""

import argparse
import os
import time
import warnings

from ..camera import LegacyCamera
from ..ops.packet_traverse import VERSIONS, traverse
from ..scene.legacy_world import LegacyWorld
from ..utils.config import STAGE_CONFIGS
from ..viewer.progressive import ProgressiveRenderer
from .common import _sync, parse_args
from .legacy_common import make_asset_path_map, save_frame


def main(argv=None):
    """Render one progressive batch; returns ``(frame f32[W,H,3], report)``
    with the wall seconds, segments, Mrays/s, the engine's stats (the
    hybrid integrator's pass counts and primary hit fraction), the linear
    image (``linear``), the packet version and the traversal kernel
    launches of the render by kernel (``launches``: none on the CPU, where
    the plain twin runs), the loader's fallback warnings
    (``load_warnings``) and whether the environment is the sky-gradient
    fallback (``env_gradient``)."""
    cfg = STAGE_CONFIGS["l14"]
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--world", required=True, help="path to a .world.npy file")
    p.add_argument("--packet-version", type=int, choices=VERSIONS,
                   default=cfg.packet_version,
                   help="mesh traversal kernel, the JAX package's LPT_PACKET_VERSION "
                        "(2: K2, 1: K5a, 3: K5b)")
    p.add_argument("--engine", choices=("hybrid", "wavefront"), default="hybrid",
                   help="progressive engine (default: hybrid)")
    known, rest = p.parse_known_args(argv)
    args = parse_args(cfg.with_(packet_version=known.packet_version),
                      description=__doc__, argv=rest)
    res = (args.width, args.height)
    path = known.world

    # a missing texture or environment falls back quietly (neutral fill, sky
    # gradient); the report lists each fallback
    world = LegacyWorld()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wd = world.load(path, path_map=make_asset_path_map(os.path.dirname(path)),
                        device=args.device, packet_version=args.packet_version)
    load_warnings = [str(w.message) for w in caught]

    cam = LegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))

    # 'jitter' is bit-identical to the legacy camera's degenerate thin lens
    # (aperture 0, focal length 1) and skips its disk sample
    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp,
                             limit=args.limit, seed=args.seed, bsdf="legacy",
                             scene="legacy", camera_model="jitter", engine=known.engine)
    before = dict(traverse.launches)
    _sync(args.device)
    start = time.time()
    frame = pr.render(moved=True)
    _sync(args.device)
    elapsed = time.time() - start
    launches = {k: n - before[k] for k, n in traverse.launches.items() if n != before[k]}
    st = pr.last_stats
    mrays = st["segments"] / max(elapsed, 1e-9) / 1e6
    passes = (f"{st['n_chunks']} slabs + {st['passes']} pool passes"
              if known.engine == "hybrid" else "wavefront passes")
    print(f"Time elapsed: {elapsed:.2f}s  ({st['segments']:.3e} ray segments, "
          f"{mrays:.1f} Mrays/s, {passes} on {args.device}; packet version "
          f"{args.packet_version}, kernel launches {launches})")
    out = args.out or f"outputs/l14_{os.path.basename(path).split('.')[0]}.png"
    save_frame(frame, out)
    report = dict(st, seconds=elapsed, mrays=mrays, out=out, engine=known.engine,
                  packet_version=args.packet_version, launches=launches,
                  linear=(pr.acc / pr.spp).reshape(res[0], res[1], 3),
                  load_warnings=load_warnings, env_gradient=wd.env_gradient_h is not None)
    if known.engine == "hybrid":
        report["primary_hit_fraction"] = st["primary_hits"] / (res[0] * res[1] * args.spp)
    return frame, report


if __name__ == "__main__":
    main()
