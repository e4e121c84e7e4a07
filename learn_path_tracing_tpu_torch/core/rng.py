"""Counter-based (stateless) RNG: the PCG-RXS-M-XS hash of the JAX package.

Every random number is a pure function of ``(seed, sample, bounce, stream,
pixel, dim)``, bit-identical to ``learn_path_tracing_tpu.core.rng``. PyTorch
has no complete uint32 arithmetic, so hash states are ``int64`` tensors that
always hold a value in ``[0, 2**32)``: each product or sum is masked back to
32 bits. A product of a 32-bit state with the multipliers below stays under
2**62, so no step overflows int64.

The same functions take Python ints, and then return Python ints: a scalar
counter (a seed, or a sample shared by the whole wavefront) is hashed on
the host and never becomes a device tensor, which would cost a
host-to-device copy and a stream synchronisation.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2**32 / phi — Weyl increment used to decorrelate dims.
_INV_2_24 = float(1.0 / (1 << 24))


def _u32(x):
    """An integer tensor as int64 holding its uint32 value; a Python int as
    its uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def pcg(x):
    """PCG-RXS-M-XS: advance a 32-bit LCG state and apply output permutation."""
    x = _u32(x)
    x = (x * 747796405 + 2891336453) & _MASK
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _MASK
    return (word >> 22) ^ word


def fold(h, v):
    """Mix value ``v`` into hash state ``h`` (boost-style combine + PCG mix)."""
    h = _u32(h)
    v = _u32(v)
    return pcg(h ^ ((v + _GOLDEN + ((h << 6) & _MASK) + (h >> 2)) & _MASK))


# Stream tags keep distinct consumers of the same (seed, sample, bounce)
# counter space decorrelated.
STREAM_CAMERA = 0
STREAM_BSDF = 1
STREAM_LIGHT = 2


def stream(seed, sample, bounce=0, stream_id: int = STREAM_BSDF):
    """Per-(sample, bounce) hash state. ``sample`` and ``bounce`` may be ints
    or per-lane tensors; the result broadcasts like them."""
    h = pcg(_u32(seed) ^ 0x6C078965)
    h = fold(h, sample)
    h = fold(h, (_u32(bounce) * 2654435761 + stream_id) & _MASK)
    return h


def base(stream_h, pixel_ids):
    """Fold per-pixel counters into a stream hash → per-pixel base ``[N]``."""
    return fold(stream_h, pixel_ids)


def bits(base_h, dim: int):
    """Raw 32 random bits for dimension ``dim`` of a base hash."""
    return pcg((_u32(base_h) + ((dim * _GOLDEN) & _MASK)) & _MASK)


def uniform(base_h, dim: int):
    """Uniform float32 in [0, 1) for dimension ``dim``. Shape follows ``base_h``.
    ``bits >> 8`` has 24 bits, so the float conversion and scale are exact."""
    return (bits(base_h, dim) >> 8).to(torch.float32) * _INV_2_24


def uniform2(base_h, dim: int):
    return uniform(base_h, dim), uniform(base_h, dim + 1)


def uniform3(base_h, dim: int):
    return (
        uniform(base_h, dim),
        uniform(base_h, dim + 1),
        uniform(base_h, dim + 2),
    )
