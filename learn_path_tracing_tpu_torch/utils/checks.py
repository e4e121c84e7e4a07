"""Agreement checks between two Monte-Carlo renders of the same scene.

Two renders with the same RNG counters trace the same paths until a float32
difference of a few ulps (a transcendental function, a multiply-add
contraction) flips a discrete event: hit or miss, the Fresnel roulette, a
grazing refraction. From then on that one sample follows another path, and
its pixel moves by up to ``1/spp`` of the sky radiance. So renders from two
implementations agree pixel for pixel almost everywhere, and where they do
not, the difference is Monte-Carlo noise. The bounds below hold a pair of
renders to that:

- ``SEGMENT_RTOL``: traced ray segments within 0.5 %;
- ``MEAN_ABS_FRAC``: the mean absolute pixel difference at most 1 % of the
  image's mean radiance;
- ``PIXEL_AGREE_MIN``: at least 80 % of the pixels equal to within 1e-4.

Measured between the port and the JAX package on the CPU (cover scene,
32x18, spp 4, limit 8): segments 0.19 % apart, mean difference 0.29 % of
the mean, 89 % of pixels within 1e-4.
"""

from __future__ import annotations

import numpy as np

SEGMENT_RTOL = 0.005
MEAN_ABS_FRAC = 0.01
PIXEL_AGREE_MIN = 0.80
PIXEL_ATOL = 1e-4


def render_agreement(img_a, img_b, segs_a, segs_b) -> dict:
    """Agreement metrics of two ``[W,H,3]`` linear images and their segment
    counts; ``ok`` tells whether all three bounds hold."""
    a = np.asarray(img_a, np.float64)
    b = np.asarray(img_b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"image shapes differ: {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    seg_rel = abs(float(segs_a) - float(segs_b)) / max(float(segs_b), 1.0)
    mean_frac = float(diff.mean() / max(np.abs(b).mean(), 1e-12))
    agree = float((diff.max(axis=-1) <= PIXEL_ATOL).mean())
    return {
        "segments_rel": seg_rel,
        "mean_abs_frac": mean_frac,
        "pixels_agree": agree,
        "max_abs": float(diff.max()),
        "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
        "ok": bool(np.isfinite(a).all() and np.isfinite(b).all()
                   and seg_rel <= SEGMENT_RTOL and mean_frac <= MEAN_ABS_FRAC
                   and agree >= PIXEL_AGREE_MIN),
    }
