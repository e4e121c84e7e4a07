"""Stage 7: metal BSDFs (7_reflect/__main__.py: camera (0,0,4), spp 8192)."""

from ..camera import Camera
from ..models import stage7_scene
from .common import parse_args, run_path_traced
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[7], description=__doc__, argv=argv)
    cam = Camera((args.width, args.height))
    cam.set_direction(0, 0)
    cam.set_position((0.0, 0.0, 4.0))
    return run_path_traced(stage7_scene(), cam, args, "7_reflect.png")


if __name__ == "__main__":
    main()
