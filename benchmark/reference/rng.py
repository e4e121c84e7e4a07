"""The path tracer's counter-based RNG, frozen: PCG-RXS-M-XS over
``(seed, sample, bounce, stream, pixel, dim)``.

Every random number of a render is a pure function of those counters, so
the reference draws the program's samples without running any of it. The
hash states are ``int64`` tensors holding ``uint32`` values; each product or
sum is masked back to 32 bits. Python ints in give Python ints out.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
INV_2_24 = float(1.0 / (1 << 24))
STREAM_CAMERA = 0
STREAM_BSDF = 1


def u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def pcg(x):
    x = u32(x)
    x = (x * 747796405 + 2891336453) & MASK
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK
    return (word >> 22) ^ word


def fold(h, v):
    h = u32(h)
    v = u32(v)
    return pcg(h ^ ((v + GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK))


def stream(seed, sample, bounce=0, stream_id: int = STREAM_BSDF):
    h = pcg(u32(seed) ^ 0x6C078965)
    h = fold(h, sample)
    return fold(h, (u32(bounce) * 2654435761 + stream_id) & MASK)


def base(stream_h, pixel_ids):
    return fold(stream_h, pixel_ids)


def uniform(base_h, dim: int):
    """Uniform f32 in [0, 1): the top 24 bits of dimension ``dim``."""
    bits = pcg((u32(base_h) + ((dim * GOLDEN) & MASK)) & MASK)
    return (bits >> 8).to(torch.float32) * INV_2_24
