"""Stage 1: fill a UV gradient and save it (1_save_img/__main__.py:1-19)."""

import time

import torch

from ..core import image
from .common import parse_args
from ..utils.config import STAGE_CONFIGS


def shader(resolution_w, resolution_h, device=None):
    w, h = resolution_w, resolution_h
    i = torch.arange(w, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(h, dtype=torch.float32, device=device)[None, :]
    r = (i / w).expand(w, h)
    g = (j / h).expand(w, h)
    return torch.stack([r, g, torch.zeros_like(r)], dim=-1)


def main(argv=None):
    args = parse_args(STAGE_CONFIGS[1], description=__doc__, argv=argv)
    start = time.time()
    img = shader(args.width, args.height, args.device)
    print(f"Time elapsed: {time.time() - start:.2f}s")
    image.write_png(img, args.out or "outputs/1_save_img.png")
    return img


if __name__ == "__main__":
    main()
