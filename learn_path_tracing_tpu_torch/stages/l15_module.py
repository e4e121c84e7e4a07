"""Legacy stage 15: the full module — OBJ + MTL textures + environment, SAH
BVH build, ``.world.npy`` save, progressive accumulation (the reference's
15_module.py:1048-1070: the Yoimiya character at fov 30, camera (0,8,-30) →
(0,8,0), accumulating 32 spp per render() call).

    python -m learn_path_tracing_tpu_torch.stages.l15_module \\
        [--assets DIR --passes N --width W --height H --spp N --device cuda|cpu]

The assets are the reference's layout under ``--assets`` (default the JAX
package's root): ``models/Yoimiya/Yoimiya_ShapeChange.obj`` with its MTL
and textures, and ``textures/cayley_interior_2k.exr``. A missing asset
raises, naming the file. The world is saved as ``Yoimiya.world.npy`` in the
output image's directory (default ``outputs/``); the passes accumulate
through ``viewer.progressive.ProgressiveRenderer`` (the hybrid engine: K2,
K6a and K6b on the card). The render runs on the card unless ``--device
cpu`` is given.
"""

import argparse
import os
import time

import numpy as np

from ..camera import LegacyCamera
from ..io.obj import load_obj
from ..scene.legacy_world import LegacyWorld
from ..utils.config import STAGE_CONFIGS
from ..viewer.progressive import ProgressiveRenderer
from .common import _sync, parse_args
from .legacy_common import DEFAULT_ASSET_ROOT, make_asset_path_map, save_frame

OBJ = "models/Yoimiya/Yoimiya_ShapeChange.obj"
ENVIRONMENT = "./textures/cayley_interior_2k.exr"


def _require(path):
    if not os.path.exists(path):
        raise FileNotFoundError(f"l15 asset missing: {path}")


def build_yoimiya_world(asset_root=DEFAULT_ASSET_ROOT, obj_path=None, exr_path=ENVIRONMENT,
                        save_path=None, device=None):
    """The stage's world on ``device``: the OBJ (default ``asset_root/OBJ``)
    turned 180° about +y with ``flip_z`` and ``flip_textcoord``, its
    materials' textures, and the EXR environment (a './…' path resolves
    against ``asset_root``); saved to ``save_path`` when given. Raises
    ``FileNotFoundError`` naming the first missing asset."""
    path_map = make_asset_path_map(asset_root)
    obj_path = obj_path or os.path.join(asset_root, OBJ)
    _require(obj_path)
    # rotate(pi, 0): yaw 180° about +y (15_module.py:1059)
    rot = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float64)
    mesh = load_obj(obj_path, texture_start_id=1, flip_z=True, flip_textcoord=True,
                    transform=rot)
    _require(path_map(exr_path))
    world = LegacyWorld()
    world.environments.add(exr_path, 0, size=(2048, 1024))
    for tex in mesh.textures:
        path = tex["file_path"]
        if not (os.path.exists(path) or os.path.exists(path + "_albedo.png")):
            raise FileNotFoundError(f"l15 asset missing: {path}")
        world.textures.add(path, tex["id"])
    world.add_mesh(mesh)
    world.set_environment(0)
    wd = world.build(path_map=path_map, device=device)
    if save_path:
        world.save(save_path)
        print(f"saved scene cache: {save_path}")
    return wd


def main(argv=None):
    """Build, save and render the stage; returns ``(frame f32[W,H,3],
    report)`` with the last pass's wall seconds, segments and Mrays/s, the
    total spp, the saved world's path (``world``), the linear image
    (``linear``) and the renderer's stats of the last pass."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--assets", default=DEFAULT_ASSET_ROOT,
                   help="root of the reference's asset tree")
    p.add_argument("--passes", type=int, default=2, help="progressive passes")
    known, rest = p.parse_known_args(argv)
    args = parse_args(STAGE_CONFIGS["l15"], description=__doc__, argv=rest)
    res = (args.width, args.height)
    out = args.out or "outputs/l15_module.png"
    world_path = os.path.join(os.path.dirname(out) or ".", "Yoimiya.world.npy")
    os.makedirs(os.path.dirname(world_path), exist_ok=True)
    wd = build_yoimiya_world(known.assets, save_path=world_path, device=args.device)

    cam = LegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))

    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp, limit=args.limit,
                             seed=args.seed, bsdf="legacy", scene="legacy")
    for i in range(known.passes):
        _sync(args.device)
        start = time.time()
        frame = pr.render(moved=(i == 0))
        _sync(args.device)
        elapsed = time.time() - start
        segs = pr.last_stats["segments"]
        mrays = segs / max(elapsed, 1e-9) / 1e6
        save_frame(frame, out)
        print(f"pass {i + 1}/{known.passes}: total spp={pr.spp}, {elapsed:.2f}s "
              f"({segs:.3e} ray segments, {mrays:.1f} Mrays/s on {args.device})")
    return frame, dict(pr.last_stats, seconds=elapsed, mrays=mrays, out=out, spp_total=pr.spp,
                       world=world_path, linear=(pr.acc / pr.spp).reshape(res[0], res[1], 3))


if __name__ == "__main__":
    main()
