"""The NVIDIA H100's published peaks and the roofline arithmetic.

NVIDIA's H100 SXM data sheet, dense rates: 67 TFLOP/s in FP32 outside the
tensor cores (packed bf16x2 outside them: twice that), 3.35 TB/s of HBM3.
A kernel's least time is the larger of its operations over the peak rate
and its bytes (each input read once, each output written once) over the
memory rate. The sphere tests (kernels K1 and K4) count
20 FP32 operations a (ray, sphere) pair: ``oc`` (3), ``half_b`` (5), ``c0``
(6), the discriminant (2), its square root and the two roots (4). The
program rounds every operation on its own (no fused multiply-add), so a
sphere scan cannot pass half of this bound: the no-FMA ceiling is 50 %.
"""

from __future__ import annotations

from .trace import kernel_seconds

FP32_FLOP_PER_S = 67e12
BF16X2_FLOP_PER_S = 2 * FP32_FLOP_PER_S
HBM_BYTES_PER_S = 3.35e12
SPHERE_PAIR_FLOP = 20


def bound_seconds(n_bytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    """``(least seconds, 'bytes' or 'operations')`` of moving ``n_bytes``
    and doing ``flops`` operations at ``flop_per_s``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sphere_scan_seconds(segments: int, spheres: int) -> float:
    """Least seconds for ``segments`` rays each tested against ``spheres``
    spheres: operations over the FP32 peak (the tables stay in cache, so the
    bytes bound is far lower)."""
    return segments * spheres * SPHERE_PAIR_FLOP / FP32_FLOP_PER_S


def share(bound_s: float, measured_s: float):
    """``bound_s`` over ``measured_s`` in %, or None where nothing ran."""
    if measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s


def sphere_kernel_share(record, kernel: str):
    """A sphere-scan kernel's share of its roofline over the traced frames:
    the least time for their segments, each tested against every sphere of
    the scene, over the device time of the kernels named ``kernel``, in %;
    None where nothing ran."""
    tr = record["trace"]
    measured = kernel_seconds(tr, kernel) if tr else 0.0
    if not measured or not record["spheres"]:
        return None
    segments = sum(f["segments"] for f in record["frames"][:tr["frames"]])
    return share(sphere_scan_seconds(segments, record["spheres"]), measured)
