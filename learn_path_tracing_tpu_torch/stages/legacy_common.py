"""Shared helpers for the legacy-line stage scripts (counterpart of
``learn_path_tracing_tpu.stages.legacy_common``)."""

from __future__ import annotations

import os

# where the reference's asset tree lies (its run-dir-relative './models/…'
# and './textures/…' paths resolve against it), as in the JAX package
DEFAULT_ASSET_ROOT = "/root/reference/assets"


def make_asset_path_map(asset_root: str | None = None):
    """Rewrite the reference's run-dir-relative texture paths ('./models/…',
    './textures/…') to ``asset_root`` (default ``DEFAULT_ASSET_ROOT``);
    other paths pass through."""
    root = asset_root or DEFAULT_ASSET_ROOT

    def path_map(p: str) -> str:
        if p.startswith("./"):
            return os.path.join(root, p[2:])
        return p

    return path_map


def companion_obj_for(world_path: str, asset_root: str | None = None) -> str | None:
    """Companion OBJ for 14-era ``.world.npy`` files, which embed no texture
    configs (the reference loads textures separately from the OBJ's
    materials, 14_mesh.py:994-999), under ``asset_root`` (default
    ``DEFAULT_ASSET_ROOT``). None for 15-era files and unknown worlds."""
    stem = os.path.basename(world_path).split(".world.npy")[0]
    mapping = {
        "Zhongli": "models/Zhongli/Zhongli.obj",
        "Ganyu": "models/Ganyu/Ganyu.obj",
        "Yoimiya_ShapeChange": "models/Yoimiya/Yoimiya_ShapeChange.obj",
    }
    rel = mapping.get(stem)
    return os.path.join(asset_root or DEFAULT_ASSET_ROOT, rel) if rel else None


def save_frame(img, path):
    from ..core import image as image_io

    image_io.write_png(img, path)
    print(f"wrote {path}")
