"""Stage 2: visualize camera ray directions as the sky gradient
(2_camera_and_ray/__main__.py: camera at origin, yaw 0 / pitch 30)."""

import time

from ..camera import Camera
from ..camera.camera import generate_rays
from ..core import image
from ..integrator.wavefront import sky_background
from .common import parse_args
from ..utils.config import STAGE_CONFIGS


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[2], description=__doc__, argv=argv)
    res = (args.width, args.height)
    cam = Camera(res)
    cam.set_direction(0, 30, 0)
    start = time.time()
    rays = generate_rays(cam.params(args.device), res, 0, 0, model="center")
    img = sky_background(rays.rd).reshape(res[0], res[1], 3)
    print(f"Time elapsed: {time.time() - start:.2f}s")
    image.write_png(img, args.out or "outputs/2_camera_and_ray.png")
    return img


if __name__ == "__main__":
    main()
