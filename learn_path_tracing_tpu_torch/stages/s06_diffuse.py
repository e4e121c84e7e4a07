"""Stage 6: Lambertian path tracing, 3 spheres + ground, ACES+gamma
(6_diffuse/__main__.py: 1280x720, spp 8192, depth 32, camera (0,0,4))."""

from ..camera import Camera
from ..models import stage6_scene
from .common import parse_args, run_path_traced
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[6], description=__doc__, argv=argv)
    cam = Camera((args.width, args.height))
    cam.set_direction(0, 0)
    cam.set_position((0.0, 0.0, 4.0))
    return run_path_traced(stage6_scene(), cam, args, "6_diffuse.png")


if __name__ == "__main__":
    main()
