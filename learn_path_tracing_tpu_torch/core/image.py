"""Image buffers and PNG I/O.

Images follow the reference's field convention: shape ``(W, H, 3)`` with
``img[i, j]`` meaning pixel column ``i`` (left→right) and row ``j``
(bottom→top). ``write_png``/``read_png`` convert to/from the top-down
``(H, W, 3)`` raster layout, so outputs compare directly with the JAX
package's PNGs.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_raster(img_wh3) -> np.ndarray:
    """(W, H, 3) float [0,1] → (H, W, 3) uint8, top row first."""
    a = np.clip(_numpy(img_wh3), 0.0, 1.0)
    a = (a * 255.0 + 0.5).astype(np.uint8)
    return np.transpose(a, (1, 0, 2))[::-1]


def from_raster(raster_hw3: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 top-down → (W, H, 3) float32 in [0,1], bottom-up."""
    a = np.asarray(raster_hw3)[::-1].astype(np.float32) / 255.0
    return np.transpose(a, (1, 0, 2))


def write_png(img_wh3, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(np.ascontiguousarray(to_raster(img_wh3))).save(path)


def read_png(path: str) -> np.ndarray:
    """Read a PNG into the framework's (W, H, 3) float [0,1] convention."""
    from PIL import Image

    raster = np.asarray(Image.open(path).convert("RGB"))
    return from_raster(raster)
