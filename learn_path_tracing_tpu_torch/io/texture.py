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
- ``sample_bilinear`` / ``sample_nearest``: the classic 4-texel bilinear
  and the nearest tap with per-rect wrap-around, on the ``[W, H, C]`` atlas.
- ``StripAtlas`` / ``pack_strips`` / ``sample_bilinear_strips``: the
  strip-packed atlas the mesh path samples, byte for byte the JAX
  package's table, and its tap: one info-row gather and one pair-row
  gather per lane, both through ``ops.row_gather.gather`` (K6a, K6b).
"""

from __future__ import annotations

import os
import struct
import warnings
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.row_gather import gather


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

    def clear(self):
        self.configs = []

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


def make_info_arrays(configs, max_id=None):
    """Pack configs' areas into dense ``i32[K,2]`` low/high arrays indexed
    by id (numpy), with at least ``max_id + 1`` rows when ``max_id`` is
    given (ids without a config get ``low = 0``, ``high = 1``)."""
    ids = [cfg["id"] for cfg in configs]
    k = (max(ids) + 1) if ids else 1
    if max_id is not None:
        k = max(k, max_id + 1)
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


def sample_nearest(img, info_low, info_high, tex_id, u, v):
    """Nearest atlas tap with per-rect wrap-around on the classic
    ``[W, H, C]`` atlas → ``f32[N, C]``."""
    tex_id = tex_id.to(torch.int64)
    low = info_low[tex_id].to(torch.int64)
    high = info_high[tex_id].to(torch.int64)
    wpix = high[:, 0] - low[:, 0]
    hpix = high[:, 1] - low[:, 1]
    x = (u * wpix.to(torch.float32)).to(torch.int32).to(torch.int64)   # trunc
    y = (v * hpix.to(torch.float32)).to(torch.int32).to(torch.int64)
    return _gather2d(img, low[:, 0] + torch.remainder(x, wpix),
                     low[:, 1] + torch.remainder(y, hpix))


# ------------------------------------------------- strip-packed atlas taps --
#
# Strip packing stores runs of T horizontally adjacent texels per table row,
# consecutive strips overlapping by one texel (stride T-1), with each
# texture rect's u-wrap baked in cyclically, so the two texels (l, l+1) of a
# bilinear footprint always lie in one strip. Each table row also carries
# the strip of the next texel row (the v-wrap baked in), so a whole bilinear
# tap is ONE random row gather (the pair row), plus one gather of the
# texture's 16-byte info row.


@dataclass(frozen=True)
class StripAtlas:
    """Strip-packed atlas plus per-texture rects and strip indexing (the JAX
    package's ``StripAtlas``, field for field)."""

    table: torch.Tensor      # [R, 2*T*C] pair rows (bf16 material / f32 env)
    info_low: torch.Tensor   # i32[K, 2] rect corners in the virtual atlas
    info_high: torch.Tensor  # i32[K, 2]
    base: torch.Tensor       # i32[K] first table row of each rect
    spr: torch.Tensor        # i32[K] strips per texel row of each rect
    info: torch.Tensor       # i32[K, 4] (w, h, base, spr): the tap's info row


def pack_strips(atlas_np, info_low, info_high, texels: int, dtype=None) -> StripAtlas:
    """Strip-pack ``atlas_np [W, H, C]`` per texture rect (on the CPU;
    ``dtype``: the table's torch type, float32 when None).

    Row layout is texel-major: ``row[j*C:(j+1)*C]`` is texel ``x0+j`` (mod
    the rect width). Rect rows are y-major: row index ``base + y*spr +
    strip``. Columns ``[0, T*C)`` hold texel row ``y``, columns ``[T*C,
    2*T*C)`` texel row ``(y+1) mod h``. The table is the JAX package's
    byte for byte."""
    low = np.asarray(info_low)
    high = np.asarray(info_high)
    c = atlas_np.shape[2]
    stride = texels - 1
    k = low.shape[0]
    base = np.zeros((k,), np.int32)
    spr = np.zeros((k,), np.int32)
    total = 0
    for i in range(k):
        w = int(high[i, 0] - low[i, 0])
        h = int(high[i, 1] - low[i, 1])
        base[i] = total
        spr[i] = -(-w // stride)
        total += h * int(spr[i])
    table = np.zeros((max(total, 1), 2 * texels * c), np.float32)
    for i in range(k):
        x0, y0 = int(low[i, 0]), int(low[i, 1])
        w = int(high[i, 0] - x0)
        h = int(high[i, 1] - y0)
        rect = atlas_np[x0:x0 + w, y0:y0 + h]               # [w, h, C]
        s = int(spr[i])
        xs = (np.arange(s)[:, None] * stride + np.arange(texels)[None]) % w
        # [s, texels, h, C] -> rows [h * s, texels * C], y-major; the pair
        # half is texel row y+1 mod h (written in place, no concatenation)
        block = rect[xs].transpose(2, 0, 1, 3).reshape(h, s, texels * c)
        rows = table[base[i]:base[i] + h * s].reshape(h, s, 2 * texels * c)
        rows[..., :texels * c] = block
        rows[..., texels * c:] = np.roll(block, -1, axis=0)
    info = np.stack([high[:, 0] - low[:, 0], high[:, 1] - low[:, 1], base, spr],
                    axis=1).astype(np.int32)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32))

    # a torch-owned copy (16-byte aligned for the row gathers)
    return StripAtlas(table=torch.from_numpy(table).to(dtype or torch.float32, copy=True),
                      info_low=i32(low), info_high=i32(high), base=i32(base),
                      spr=i32(spr), info=i32(info))


def _imod_f32(a, m):
    """``mod(a, m)`` of int32 values through f32 arithmetic, as the JAX
    package computes it (exact while ``|a|, m < 2**24``; a rect extent below
    1 counts as 1)."""
    af = a.to(torch.float32)
    mf = torch.clamp_min(m.to(torch.float32), 1.0)
    q = torch.floor(af / mf)
    return (af - q * mf).to(torch.int32)


def sample_bilinear_strips(atlas: StripAtlas, tex_id, u, v, channels: int):
    """Bilinear tap over a strip-packed atlas → ``f32[N, channels]``: the
    texels and weights of ``sample_bilinear`` (same rect wrap-around),
    fetched as one info-row and one pair-row gather (``ops.row_gather``).

    ``tex_id`` follows the row gathers' rule, as JAX's ``jnp.take`` does: an
    id in ``[-K, 0)`` wraps, any other id past the last rect taps a fill
    row and gives NaN, except on a single-texture atlas, where every lane
    reads rect 0 (the info row is broadcast, not gathered)."""
    c = channels
    texels = atlas.table.shape[1] // (2 * c)
    stride = texels - 1
    n = u.shape[0]
    if atlas.info.shape[0] == 1:
        info = atlas.info[0].expand(n, atlas.info.shape[1])
    else:
        info = gather(atlas.info, tex_id)
    wpix, hpix, base, spr = info.unbind(1)
    uu = u * wpix.to(torch.float32) - 0.5
    vv = v * hpix.to(torch.float32) - 0.5
    l = uu.to(torch.int32)   # trunc toward zero, as ti.cast does
    b = vv.to(torch.int32)
    wl = ((l + 1).to(torch.float32) - uu)[:, None]
    wb = ((b + 1).to(torch.float32) - vv)[:, None]
    lm = _imod_f32(l, wpix)
    sx = torch.div(lm, stride, rounding_mode="floor")
    off = lm - sx * stride
    by = _imod_f32(b, hpix)
    tc = texels * c
    row = (base.to(torch.int64) + by.to(torch.int64) * spr.to(torch.int64)
           + sx.to(torch.int64))
    pair_row = gather(atlas.table, row)                     # [N, 2*T*C]
    # The JAX package blends the whole strip (wb * row_b + (1 - wb) * row_t,
    # elementwise) and then selects the texel pair at ``off`` as a one-hot
    # sum over the ``stride`` static slices. Here the pair is indexed
    # directly and only its 2*C columns are blended. Equal bit for bit on
    # finite tables: the blend is elementwise, so the selected columns hold
    # the same values; the one-hot sum starts from +0 and adds the selected
    # value and 0 * x = ±0 for every other slot, and adding ±0 leaves a
    # value unchanged except that a -0 becomes +0, which ``+ 0.0`` repeats.
    # On a fill (NaN) row both forms give NaN.
    cols = off.to(torch.int64)[:, None] * c + torch.arange(2 * c, device=u.device)
    pair_b = torch.gather(pair_row[:, :tc], 1, cols).to(torch.float32)
    pair_t = torch.gather(pair_row[:, tc:], 1, cols).to(torch.float32)
    pair = (wb * pair_b + (1.0 - wb) * pair_t) + 0.0       # [N, 2*C]
    return wl * pair[:, :c] + (1.0 - wl) * pair[:, c:]
