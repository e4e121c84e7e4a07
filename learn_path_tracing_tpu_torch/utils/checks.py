"""Numerical checks: render agreement, image validity, device smoke test,
and a NaN trap.

Counterpart of ``learn_path_tracing_tpu.utils.checks`` (``validate_image``,
``device_smoke_test``, ``checked_trace``), plus ``render_agreement``.

**Agreement between two Monte-Carlo renders of the same scene.**

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
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

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


def validate_image(img, label: str = "image") -> None:
    """Host-side post-render check: raises ``FloatingPointError`` on a
    non-finite value (naming its share and the first index) or a negative
    one, with the JAX package's messages."""
    a = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    bad = ~np.isfinite(a)
    if bad.any():
        idx = np.argwhere(bad)[0]
        raise FloatingPointError(
            f"{label}: {bad.mean():.2%} non-finite values (first at {idx.tolist()})")
    if (a < 0).any():
        raise FloatingPointError(f"{label}: negative radiance present")


def device_smoke_test(device="cuda") -> bool:
    """The reference's legacy/test.py device check: ``|(1, 2, 2)| = 3``
    computed on ``device``. Raises without a CUDA device unless asked for
    the CPU (``stages.common.require_device``)."""
    from ..stages.common import require_device

    require_device(device)
    a = torch.tensor([1.0, 2.0, 2.0], device=device)
    n = float(torch.sqrt(torch.sum(a * a)))
    if not n > 3.0 - 1e-3:
        raise AssertionError(f"device vector math broken: |a|={n}")
    return True


# factory ops whose output is uninitialised memory, which may hold NaN bits
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _float_tensors(tree):
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _has_nan(tensors) -> bool:
    return any(bool(torch.isnan(t).any()) for t in tensors)


class _NanTrap(TorchDispatchMode):
    """Raises on the first op whose floating output holds a NaN while none
    of its floating inputs held one before it ran."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return func(*args, **kwargs)
        nan_in = _has_nan(_float_tensors((args, kwargs)))
        out = func(*args, **kwargs)
        if not nan_in and _has_nan(_float_tensors(out)):
            raise FloatingPointError(f"checked_trace: NaN produced by {func}")
        return out


def checked_trace(fn, *args, **kwargs):
    """Runs ``fn(*args, **kwargs)`` with every PyTorch op checked, the
    counterpart of checkify's float checks: raises ``FloatingPointError``,
    naming the op, on the first op that makes a NaN from NaN-free inputs,
    even if a later op masks it away. Infinities pass (``1/rd`` in the slab
    tests is meant to give them). The hand-written kernels run outside
    PyTorch's dispatcher and are not checked inside; their outputs reach
    the next op's check as inputs. A debugging tool: each op's operands are
    read back to the host."""
    with _NanTrap():
        return fn(*args, **kwargs)
