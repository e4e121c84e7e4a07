"""How ``correct`` is decided: the kept frame against the plain reference.

After the window has closed and the program's state is freed, the reference
(``reference/<name>.py`` of the configuration) renders the kept frame's
seed at the cell's spp, over every pixel (``"pixels": "all"``) or over a
sample of pixels drawn from the run's seed. The numbers compared, each
against the limit in the cell's traffic file:

- ``mean_abs_frac``: mean absolute difference of the compared pixels'
  radiance over the reference's mean radiance;
- ``pixels_differ``: share of compared pixels whose largest channel
  difference exceeds ``PIXEL_ATOL``;
- ``segments_rel``: the frame's traced segments against the reference's
  (over a pixel sample: the sample's count scaled to the frame), relative;
- ``repeated_frames``: window frames whose segment count and image sum equal
  the frame before (a render that hands back old state);
- ``nonfinite_frames``: window frames whose image holds a NaN or an inf.
"""

from __future__ import annotations

import torch

from ..reference import integrate
from . import registry

PIXEL_ATOL = 1e-4
NUMBERS = ("mean_abs_frac", "pixels_differ", "segments_rel", "repeated_frames",
           "nonfinite_frames")


def pixels(cell, config, seed, device):
    """The absolute pixel ids the reference renders (int64, sorted)."""
    w, h = config["resolution"]
    n = w * h
    want = cell["compare"]["pixels"]
    if want == "all" or want >= n:
        return torch.arange(n, dtype=torch.int64, device=device)
    g = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(n, generator=g)[:want].sort().values.to(device)


def reference_frame(config, cell, scene, frame_seed, pix, dtype=torch.float32):
    """``(image f32[P,3] on the host, segments over the pixels)`` of the
    reference."""
    ref = registry.module("reference", config["reference"])
    kw = {"dtype": dtype} if dtype != torch.float32 else {}
    acc, segs = ref.render(scene, config, frame_seed, cell["spp"], pix, **kw)
    return integrate.image(acc, cell["spp"]).cpu(), int(segs.sum())


def readings(prog_image, prog_segments, ref_image, ref_segments, pix, n_pixels) -> dict:
    """The image and segment numbers of one frame (see the module doc)."""
    prog = prog_image.detach().reshape(-1, 3).cpu()[pix.cpu()].to(torch.float64)
    ref = ref_image.to(torch.float64)
    diff = (prog - ref).abs()
    scale = ref.abs().mean().clamp_min(1e-12)
    diff = torch.nan_to_num(diff, nan=float("inf"))
    expected = ref_segments * n_pixels / pix.numel()
    return {"mean_abs_frac": float(diff.mean() / scale),
            "pixels_differ": float((diff.max(dim=1).values > PIXEL_ATOL).to(torch.float64).mean()),
            "segments_rel": abs(prog_segments - expected) / max(expected, 1.0)}


def frame_checks(frames, checks) -> dict:
    """``repeated_frames`` and ``nonfinite_frames`` of the window, from each
    frame's segment count and its ``(finite, image sum)`` check."""
    repeated = sum(1 for k in range(1, len(frames))
                   if frames[k]["segments"] == frames[k - 1]["segments"]
                   and checks[k][1] == checks[k - 1][1])
    return {"repeated_frames": repeated,
            "nonfinite_frames": sum(1 for ok, _ in checks if not ok)}


def verdict(numbers, limits) -> tuple:
    """``(correct, checks)``: each number beside its limit, in ``NUMBERS``
    order; correct when none exceeds its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
