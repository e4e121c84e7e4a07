"""Stage 3: single sphere, primary-ray normal shading
(3_adding_a_sphere/__main__.py:28-51)."""

import time

from ..camera import Camera
from ..core import image
from ..models import stage3_scene
from .common import parse_args, render_normal_shaded
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[3], description=__doc__, argv=argv)
    res = (args.width, args.height)
    cam = Camera(res)
    cam.set_direction(0, 0)
    start = time.time()
    img = render_normal_shaded(stage3_scene().device(args.device),
                               cam.params(args.device), res)
    print(f"Time elapsed: {time.time() - start:.2f}s")
    image.write_png(img, args.out or "outputs/3_adding_a_sphere.png")
    return img


if __name__ == "__main__":
    main()
