"""Legacy stage 12: free-fly camera with progressive accumulation (the
reference's 12_free_view.py:553-579).

There is no window here; the stage runs a scripted WASD-style flythrough:
each keyframe applies camera moves (the reference's move_front /
move_right / move_up / rotate controls) and renders a progressively
accumulated frame, resetting the accumulation on movement, as the
reference's ``render(moved)`` does. ``--script`` takes a comma-separated
move list (e.g. "w,w,a,r+10-5,.,.") where '.' holds still (accumulates)
and 'r+Y-P' rotates.

    python -m learn_path_tracing_tpu_torch.stages.l12_free_view \\
        [--script TOKENS --width W --height H --spp N --device cuda|cpu]

Frames render through ``viewer.progressive.ProgressiveRenderer`` over the
l11 world's sphere BVH (the wavefront engine with ``hit_backend='bvh'``:
K3 on the card). Without ``--out`` every keyframe is written to
``outputs/l12_free_view_NNN.png``; with it, the first keyframe only.
"""

import argparse
import re

from ..camera import LegacyCamera
from ..utils.config import STAGE_CONFIGS
from ..viewer.progressive import ProgressiveRenderer
from .common import parse_args
from .l11_bvh import legacy_random_scene
from .legacy_common import save_frame

VELOCITY = 1.0
SCRIPT = "w,w,.,.,d,r+15+0,.,."


def apply_move(cam: LegacyCamera, token: str) -> bool:
    """Apply one move token; returns True if the camera moved."""
    if token == ".":
        return False
    if token == "w":
        cam.move_front(VELOCITY)
    elif token == "s":
        cam.move_front(-VELOCITY)
    elif token == "a":
        cam.move_right(-VELOCITY)
    elif token == "d":
        cam.move_right(VELOCITY)
    elif token == "space":
        cam.move_up(VELOCITY)
    elif token == "shift":
        cam.move_up(-VELOCITY)
    elif token.startswith("r"):
        m = re.match(r"r([+-]\d+)([+-]\d+)", token)
        if not m:
            raise ValueError(f"bad rotate token {token!r}")
        cam.rotate(float(m.group(1)), float(m.group(2)))
    else:
        raise ValueError(f"unknown move token {token!r}")
    return True


def start_camera(res) -> LegacyCamera:
    cam = LegacyCamera(res)
    cam.set_fov(20)
    cam.set_position((13, 2, 3))
    cam.look_at((0, 0, 0))
    return cam


def main(argv=None):
    """Run the script; returns ``(last frame f32[W,H,3], report)`` with the
    renderer's total spp after each keyframe (``spp``), the camera after the
    last move (``camera``) and the renderer (``renderer``)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--script", default=SCRIPT, help="comma-separated move tokens")
    known, rest = p.parse_known_args(argv)
    args = parse_args(STAGE_CONFIGS["l12"], description=__doc__, argv=rest)
    res = (args.width, args.height)
    wd = legacy_random_scene().device(args.device, use_bvh=True)
    cam = start_camera(res)
    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp,
                             limit=min(args.limit, 10), seed=args.seed, bsdf="legacy",
                             scene="spheres", hit_backend="bvh")
    spp = []
    for i, token in enumerate(known.script.split(",")):
        moved = apply_move(cam, token)
        frame = pr.render(moved=moved)
        save_frame(frame, args.out or f"outputs/l12_free_view_{i:03d}.png")
        spp.append(pr.spp)
        print(f"frame {i}: token={token!r} moved={moved} spp={pr.spp}")
        if args.out:
            break
    return frame, {"spp": spp, "camera": cam, "renderer": pr}


if __name__ == "__main__":
    main()
