"""Texture atlas: bin-packing manager, host loaders, bilinear sampler.

Counterpart of ``learn_path_tracing_tpu.io.texture``:

- ``TextureManager``: guillotine 2D bin packing over a free-rect list,
  configs sorted by height then width descending, first-fit split. Packed
  rects are serialized into ``.world.npy`` files, so the placements are the
  JAX package's, decision for decision.
- ``build_texture_atlas`` / ``build_environment_atlas``: PBR sets
  (``<base>_albedo/_roughness/_metallic/_normal.png``) or plain images into
  a packed ``f32[W, H, 8]`` material atlas (albedo rgb, normal xyz,
  roughness, metallic); equirect EXR/PNG environments into ``f32[W, H, 3]``.
  Missing files fall back to a neutral material or the sky gradient, with
  a warning.
- ``sample_bilinear``: the classic 4-texel bilinear tap with per-rect
  wrap-around, on the ``[W, H, C]`` atlas.

The JAX package's strip-packed atlas (``pack_strips`` /
``sample_bilinear_strips``) exists for TPU row gathers and is not carried
over: the port samples the classic atlas, whose taps equal the strip
sampler's to float rounding (the JAX package's own test shows the two
agree).
"""

from __future__ import annotations

import os
import struct
import warnings
import zlib

import numpy as np
import torch


# ---------------------------------------------------------------- packing --

class TextureManager:
    """Guillotine bin packer for atlas rectangles (tallest first, first-fit
    over the free list, band split with the right sliver scanned before the
    upper band)."""

    def __init__(self, size):
        self.size = (int(size[0]), int(size[1]))
        self.configs: list[dict] = []
        # free regions as (x, y, w, h) tuples, scanned front-to-back
        self._free: list[tuple[int, int, int, int]] = []

    def add(self, file_path, id, size=None):
        if size is None:
            size = _probe_size(file_path)
        self.configs.append({"file_path": file_path,
                             "size": (int(size[0]), int(size[1])),
                             "id": int(id)})

    def _place(self, w, h):
        """First-fit placement; splits the chosen region into a right
        sliver (same height band, scanned first) and the band above."""
        for i, (x, y, fw, fh) in enumerate(self._free):
            if fw < w or fh < h:
                continue
            self._free[i:i + 1] = [(x + w, y, fw - w, h),
                                   (x, y + h, fw, fh - h)]
            return {"low": (x, y), "high": (x + w, y + h)}
        return None

    def build(self):
        self._free = [(0, 0, self.size[0], self.size[1])]
        # tallest first, widest as tiebreaker (stable for equal sizes)
        self.configs.sort(key=lambda c: (-c["size"][1], -c["size"][0]))
        for cfg in self.configs:
            area = self._place(*cfg["size"])
            if area is None:
                raise MemoryError(
                    "texture atlas full: no free region fits "
                    f"{cfg['size']} (atlas {self.size})")
            cfg["area"] = area

    def dump(self):
        return {"size": self.size, "configs": self.configs}

    def load(self, data):
        self.size = tuple(data["size"])
        self.configs = []
        for cfg in data["configs"]:
            area = cfg["area"]
            self.configs.append({
                "file_path": cfg["file_path"],
                "size": tuple(cfg["size"]),
                "id": int(cfg["id"]),
                "area": {"low": tuple(int(x) for x in area["low"]),
                         "high": tuple(int(x) for x in area["high"])},
            })


def _probe_size(file_path):
    path = file_path if os.path.exists(file_path) else file_path + "_albedo.png"
    if path.endswith(".exr"):
        from .exr import read_exr

        arr = read_exr(path)
        return (arr.shape[1], arr.shape[0])  # (w, h)
    from PIL import Image

    with Image.open(path) as img:
        return img.size  # (w, h)


# ------------------------------------------------------------ host loaders --

def _decode(path, size, mode=None):
    from PIL import Image

    img = Image.open(path)
    if mode:
        img = img.convert(mode)
    img = img.resize(size, Image.LANCZOS)
    a = np.asarray(img, np.float32) / 255.0
    if a.ndim == 3:
        a = a.transpose(1, 0, 2)[..., :3]
        return np.flip(a, 1)
    return np.flip(a.transpose(1, 0), 1)


def _neutral(size):
    """Neutral material fill: albedo, roughness, metallic, normal."""
    return (np.full((*size, 3), 0.5, np.float32), np.ones(size, np.float32),
            np.zeros(size, np.float32),
            np.broadcast_to(np.array([0.5, 0.5, 1.0], np.float32),
                            (*size, 3)).copy())


def build_texture_atlas(configs, atlas_size, path_map=None) -> np.ndarray:
    """Fill a packed ``f32[W, H, 8]`` atlas from packing configs.

    ``path_map(file_path) -> str`` rewrites stored (possibly relative)
    paths; missing files produce a neutral gray material + warning.
    """
    w, h = atlas_size
    atlas = np.zeros((w, h, 8), np.float32)
    for cfg in configs:
        low, high = cfg["area"]["low"], cfg["area"]["high"]
        size = (high[0] - low[0], high[1] - low[1])
        path = cfg["file_path"]
        if path_map is not None:
            path = path_map(path)
        try:
            if os.path.exists(path):
                albedo, roughness, metallic, normal = _neutral(size)
                albedo = _decode(path, size)
            elif os.path.exists(path + "_albedo.png"):
                albedo = _decode(path + "_albedo.png", size)
                roughness = _decode(path + "_roughness.png", size, "L")
                metallic = _decode(path + "_metallic.png", size, "L")
                normal = _decode(path + "_normal.png", size)
            else:
                raise FileNotFoundError(path)
        except FileNotFoundError:
            warnings.warn(f"texture missing, using neutral fill: {path}")
            albedo, roughness, metallic, normal = _neutral(size)

        sl = np.s_[low[0]:high[0], low[1]:high[1]]
        atlas[sl][..., 0:3] = albedo ** 2.2
        atlas[sl][..., 3:6] = normal * 2.0 - 1.0
        atlas[sl][..., 6] = roughness ** 2
        atlas[sl][..., 7] = metallic ** 2
    return atlas


def build_environment_atlas(configs, atlas_size, path_map=None):
    """Fill an equirect environment atlas ``f32[W, H, 3]`` (linear HDR).

    Returns ``(atlas, gradient_ids)``: ``gradient_ids`` is the set of config
    ids whose source file was missing and therefore hold the procedural sky
    gradient, which ``environment_color`` can evaluate in closed form."""
    w, h = atlas_size
    atlas = np.zeros((w, h, 3), np.float32)
    gradient_ids = set()
    for cfg in configs:
        low, high = cfg["area"]["low"], cfg["area"]["high"]
        size = (high[0] - low[0], high[1] - low[1])
        path = cfg["file_path"]
        if path_map is not None:
            path = path_map(path)
        env = None
        if os.path.exists(path):
            if path.endswith(".exr"):
                from .exr import read_exr

                try:
                    env = np.asarray(read_exr(path), np.float32)[..., :3]
                except (ValueError, KeyError, struct.error, zlib.error) as e:
                    # a file outside the subset the codec reads
                    warnings.warn(f"EXR decode failed ({e}): {path}")
            else:
                from PIL import Image

                env = np.asarray(Image.open(path).convert("RGB"),
                                 np.float32) / 255.0
        if env is None:
            warnings.warn(f"environment missing, using sky gradient: {path}")
            gradient_ids.add(int(cfg["id"]))
            # vertical white→blue gradient like the modern stages
            v = np.linspace(0.0, 1.0, size[1], dtype=np.float32)
            top = np.array([0.5, 0.7, 1.0], np.float32)
            bottom = np.array([1.0, 1.0, 1.0], np.float32)
            grad = bottom[None] * (1 - v)[:, None] + top[None] * v[:, None]
            env_uv = np.broadcast_to(grad[None, :, :], (*size, 3)).copy()
        else:
            if env.shape[:2][::-1] != size:
                # nearest resize (resampling HDR data through PIL is lossy)
                ys = np.linspace(0, env.shape[0] - 1, size[1]).astype(int)
                xs = np.linspace(0, env.shape[1] - 1, size[0]).astype(int)
                env = env[ys][:, xs]
            env_uv = np.flip(env.transpose(1, 0, 2)[..., :3], 1)
        atlas[low[0]:high[0], low[1]:high[1]] = env_uv
    return atlas, frozenset(gradient_ids)


def make_info_arrays(configs):
    """Pack configs' areas into dense ``i32[K,2]`` low/high arrays indexed
    by id (numpy)."""
    ids = [cfg["id"] for cfg in configs]
    k = (max(ids) + 1) if ids else 1
    low = np.zeros((k, 2), np.int32)
    high = np.ones((k, 2), np.int32)
    for cfg in configs:
        low[cfg["id"]] = cfg["area"]["low"]
        high[cfg["id"]] = cfg["area"]["high"]
    return low, high


# ---------------------------------------------------------- device sampler --

def _gather2d(img, x, y):
    """``img [W,H,C]``; ``x, y`` integer ``[N]`` → ``f32[N,C]``. The
    material atlas is stored in bfloat16; texels widen to f32 before the
    blend weights apply."""
    h = img.shape[1]
    flat = img.reshape(-1, img.shape[2])
    return flat[x * h + y].to(torch.float32)


def sample_bilinear(img, info_low, info_high, tex_id, u, v):
    """Bilinear atlas tap with per-rect wrap-around. ``tex_id`` integer
    ``[N]``, ``u, v: f32[N]`` → ``f32[N, C]``."""
    tex_id = tex_id.to(torch.int64)
    low = info_low[tex_id].to(torch.int64)
    high = info_high[tex_id].to(torch.int64)
    wpix = high[:, 0] - low[:, 0]
    hpix = high[:, 1] - low[:, 1]
    uu = u * wpix.to(torch.float32) - 0.5
    vv = v * hpix.to(torch.float32) - 0.5
    l = uu.to(torch.int32).to(torch.int64)   # trunc toward zero
    r = l + 1
    b = vv.to(torch.int32).to(torch.int64)
    t = b + 1
    wl = r.to(torch.float32) - uu
    wb = t.to(torch.float32) - vv
    lb = wl * wb
    lt = wl * (1.0 - wb)
    rb = (1.0 - wl) * wb
    rt = (1.0 - wl) * (1.0 - wb)
    lw = low[:, 0] + torch.remainder(l, wpix)
    rw = low[:, 0] + torch.remainder(r, wpix)
    bw = low[:, 1] + torch.remainder(b, hpix)
    tw = low[:, 1] + torch.remainder(t, hpix)
    return (lb[:, None] * _gather2d(img, lw, bw)
            + lt[:, None] * _gather2d(img, lw, tw)
            + rb[:, None] * _gather2d(img, rw, bw)
            + rt[:, None] * _gather2d(img, rw, tw))
