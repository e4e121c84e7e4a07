"""Stage 9: thin-lens depth of field (9_dof/__main__.py: camera (3,0.5,2)
looking at (0,0.35,0), focal = |position|, aperture 0.2)."""

import math

from ..camera import Camera
from ..models import stage8_scene
from .common import parse_args, run_path_traced
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[9], description=__doc__, argv=argv)
    cam = Camera((args.width, args.height))
    cam.set_position((3.0, 0.5, 2.0))
    cam.look_at((0.0, 0.35, 0.0))
    cam.set_len(focal_length=math.sqrt(3.0 ** 2 + 0.5 ** 2 + 2.0 ** 2),
                aperture=0.2)
    return run_path_traced(stage8_scene(), cam, args, "9_dof.png")


if __name__ == "__main__":
    main()
