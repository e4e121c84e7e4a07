"""Shared helpers for the legacy-line stage scripts (counterpart of
``learn_path_tracing_tpu.stages.legacy_common``)."""

from __future__ import annotations

import os


def make_asset_path_map(asset_root: str):
    """Rewrite the reference's run-dir-relative texture paths ('./models/…',
    './textures/…') to ``asset_root``; other paths pass through."""

    def path_map(p: str) -> str:
        if p.startswith("./"):
            return os.path.join(asset_root, p[2:])
        return p

    return path_map


def save_frame(img, path):
    from ..core import image as image_io

    image_io.write_png(img, path)
    print(f"wrote {path}")
