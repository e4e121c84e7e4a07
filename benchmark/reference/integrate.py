"""The plain reference integrator: every (pixel, sample) path on its own.

A path starts at its camera ray, and at each bounce ``b < limit`` it is
traced once (one segment); a miss adds the escape radiance times its
throughput to its pixel and ends it, a hit scatters it with the BSDF stream
of ``(seed, sample, b, pixel)``, and a path still alive after ``limit``
segments adds nothing. Each radiance is added to its pixel in fixed point
(round to 2**-32 units, int64), the program's documented accumulator, so
the sum does not depend on order. Work runs in blocks of items with the
dead paths compacted away after every bounce, so it fits on one card.
"""

from __future__ import annotations

import torch

from . import rng

FIXED_ONE = 2.0 ** 32


def render(pixels, spp: int, limit: int, seed, primary, hit, escape, scatter,
           block: int = 1 << 20):
    """``(acc int64[P,3], segments int64[P])`` over the absolute pixel ids
    ``pixels`` (int64 ``[P]``), samples ``0 .. spp-1`` each.

    ``primary(pix, sample) -> (ro, rd)``; ``hit(ro, rd) -> (hit, point,
    normal, mat)``; ``escape(rd) -> [N,3]``; ``scatter(rd, thr, point,
    normal, mat, base) -> (ro, rd, thr)``."""
    dev = pixels.device
    n_pix = pixels.shape[0]
    acc = torch.zeros((n_pix, 3), dtype=torch.int64, device=dev)
    segments = torch.zeros((n_pix,), dtype=torch.int64, device=dev)
    total = n_pix * spp
    for i0 in range(0, total, block):
        item = torch.arange(i0, min(total, i0 + block), dtype=torch.int64, device=dev)
        row, sample = item // spp, item % spp
        pix = pixels[row]
        ro, rd = primary(pix, sample)
        thr = torch.ones_like(ro)
        for b in range(limit):
            if row.numel() == 0:
                break
            segments.index_add_(0, row, torch.ones_like(row))
            hit_mask, point, normal, mat = hit(ro, rd)
            esc = torch.nonzero(~hit_mask).squeeze(1)
            contrib = (escape(rd[esc]) * thr[esc]).to(torch.float32)
            acc.index_add_(0, row[esc], torch.round(contrib * FIXED_ONE).to(torch.int64))
            if b + 1 == limit:
                break
            keep = torch.nonzero(hit_mask).squeeze(1)
            row, sample, pix = row[keep], sample[keep], pix[keep]
            base = rng.base(rng.stream(seed, sample, b, rng.STREAM_BSDF), pix)
            ro, rd, thr = scatter(rd[keep], thr[keep], point[keep], normal[keep],
                                  {k: v[keep] for k, v in mat.items()}, base)
    return acc, segments


def image(acc, spp: int):
    """Mean radiance ``f32[P,3]`` from the fixed-point sums, as the program
    rounds them."""
    return (acc.to(torch.float64) / FIXED_ONE).to(torch.float32) / spp
