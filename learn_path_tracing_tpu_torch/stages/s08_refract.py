"""Stage 8: dielectric refraction (8_refract/__main__.py: camera (0,0.4,4))."""

from ..camera import Camera
from ..models import stage8_scene
from .common import parse_args, run_path_traced
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[8], description=__doc__, argv=argv)
    cam = Camera((args.width, args.height))
    cam.set_direction(0, 0)
    cam.set_position((0.0, 0.4, 4.0))
    return run_path_traced(stage8_scene(), cam, args, "8_refract.png")


if __name__ == "__main__":
    main()
