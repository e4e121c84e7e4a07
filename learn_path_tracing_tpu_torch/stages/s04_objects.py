"""Stage 4: sphere + ground world, normal shading (4_objects/__main__.py)."""

import time

from ..camera import Camera
from ..core import image
from ..models import stage4_scene
from .common import parse_args, render_normal_shaded
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[4], description=__doc__, argv=argv)
    res = (args.width, args.height)
    cam = Camera(res)
    cam.set_direction(0, 0)
    cam.set_position((0.0, 0.0, 3.0))
    start = time.time()
    img = render_normal_shaded(stage4_scene().device(args.device),
                               cam.params(args.device), res)
    print(f"Time elapsed: {time.time() - start:.2f}s")
    image.write_png(img, args.out or "outputs/4_objects.png")
    return img


if __name__ == "__main__":
    main()
