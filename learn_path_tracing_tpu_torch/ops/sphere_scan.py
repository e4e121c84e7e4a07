"""Kernel K1: brute-force sphere-scan nearest hit, with its plain twin.

``intersect_spheres_scan`` is the port of the JAX package's
``ops/sphere_scan.intersect_spheres_pallas``: for each ray, the nearest
sphere of the whole table in exact f32 (``oc = ro - c`` first), and the
winner's 16 attribute floats. For a CUDA tensor it launches the hand-written
kernel of ``csrc/sphere_scan.cu``; for a CPU tensor it runs the plain twin
``intersect_spheres_scan_plain``, the same math in PyTorch. There is no
fallback between the two: a CUDA tensor launches the kernel or raises. The
kernel splits the table into ``team_slices(N, S, SMs)`` slices scanned by
warps side by side and reduces their results to the least ``(t, idx)``,
which is the serial scan's result.

Tables (built once per world by ``pack_spheres``):

- ``table f32[S,8]``: ``cx, cy, cz, r², flag`` and three unused columns.
  ``flag`` is 1 for an opaque sphere, 2 for a transparent one and 0 for
  padding; a sphere with radius <= 0 gets ``r² = -inf``, so it never hits.
- ``attrs f32[S,16]``: one sphere-major row per sphere, gathered for the
  winner (see ``scene.world.hit`` for the columns).

Outputs: ``t f32[N]`` (+inf on a miss), ``idx i32[N]`` (0 on a miss, as the
TPU kernel leaves it), ``attr f32[N,16]`` (the row of ``idx``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

T_MIN = 1e-4
N_ATTR = 16
TABLE_COLS = 8
_CX, _CY, _CZ, _R2, _FLAG = range(5)
PLAIN_CHUNK = 128  # spheres per step of the plain twin (bounds its [N, chunk] temporaries)
# the kernel's warp teams (csrc/sphere_scan.cu): slices per group of 32 rays
SLICE_CHOICES = (1, 2, 4, 8, 16, 32)
MAX_SLICES = SLICE_CHOICES[-1]
WARPS_PER_SM = 32         # warps a team choice aims to put on each SM
MIN_SLICE = 16            # spheres a slice keeps at least


def pack_spheres(centers, radii, transparency):
    """The kernel's sphere table ``f32[S,8]`` from ``centers f32[S,3]``,
    ``radii f32[S]`` and ``transparency f32[S]``, on their device."""
    s = centers.shape[0]
    table = torch.zeros((s, TABLE_COLS), dtype=torch.float32, device=centers.device)
    real = radii > 0
    table[:, _CX:_CZ + 1] = centers
    table[:, _R2] = torch.where(real, radii * radii,
                                torch.full_like(radii, -float("inf")))
    flags = torch.where(transparency > 0, 2.0, 1.0).to(torch.float32)
    table[:, _FLAG] = torch.where(real, flags, torch.zeros_like(flags))
    return table


def _check(ro, rd, table, attrs):
    n, s = ro.shape[0], table.shape[0]
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)),
                           ("table", table, (s, TABLE_COLS)),
                           ("attrs", attrs, (s, N_ATTR))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"sphere scan: {name} must be f32{list(shape)}, "
                             f"got {x.dtype}{list(x.shape)}")
        if x.device != ro.device:
            raise ValueError(f"sphere scan: {name} is on {x.device}, "
                             f"rays on {ro.device}")
    if s < 1:
        raise ValueError("sphere scan: empty sphere table")


def team_slices(n: int, s: int, sms: int) -> int:
    """Sphere slices ``P`` of the kernel's warp teams for ``n`` rays over
    ``s`` spheres on a card of ``sms`` SMs: the least power of two that puts
    ``WARPS_PER_SM`` warps on each SM, at most 32 and at most
    ``s / MIN_SLICE`` (so a slice keeps at least ``MIN_SLICE`` spheres). On
    the H100's 132 SMs, 57,344 rays over 512 spheres take 4; the drain
    widths 7,168, 1,024 and 256 take 32."""
    ray_warps = -(-n // 32)
    p = 1
    while (p < MAX_SLICES and ray_warps * p < sms * WARPS_PER_SM
           and 2 * p * MIN_SLICE <= s):
        p *= 2
    return p


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def intersect_spheres_scan(ro, rd, table, attrs, t_min: float = T_MIN):
    """Nearest hit of ``N`` rays over the sphere table → ``(t, idx, attr)``.

    CUDA tensors launch the kernel (and count the launch in
    ``intersect_spheres_scan.launches``) with ``team_slices`` slices for the
    card's SM count; CPU tensors take the plain twin.
    """
    _check(ro, rd, table, attrs)
    if ro.device.type == "cpu":
        return intersect_spheres_scan_plain(ro, rd, table, attrs, t_min)
    if ro.device.type != "cuda":
        raise ValueError(f"sphere scan: no kernel for device {ro.device}")
    sms = _sm_count(ro.device.index if ro.device.index is not None
                    else torch.cuda.current_device())
    return _launch(ro, rd, table, attrs, t_min, team_slices(ro.shape[0], table.shape[0], sms))


intersect_spheres_scan.launches = 0


def _launch(ro, rd, table, attrs, t_min, slices):
    """The kernel with ``slices`` sphere slices per group of 32 rays (one of
    ``SLICE_CHOICES``; the result does not depend on it)."""
    if slices not in SLICE_CHOICES:
        raise ValueError(f"sphere scan: slices must be one of {SLICE_CHOICES}, got {slices}")
    for name, x in (("ro", ro), ("rd", rd), ("table", table), ("attrs", attrs)):
        if not x.is_contiguous():
            raise ValueError(f"sphere scan kernel: {name} must be contiguous")
    lib = load_kernel()
    n, s = ro.shape[0], table.shape[0]
    dev = ro.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    attr = torch.empty((n, N_ATTR), dtype=torch.float32, device=dev)
    if n == 0:
        return t, idx, attr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lpt_sphere_scan(ro.data_ptr(), rd.data_ptr(), table.data_ptr(),
                                  attrs.data_ptr(), t.data_ptr(), idx.data_ptr(),
                                  attr.data_ptr(), n, s, float(t_min), slices, stream)
    if err != 0:
        msg = lib.lpt_error_string(err).decode()
        raise RuntimeError(f"sphere scan kernel launch failed: {msg} ({err})")
    intersect_spheres_scan.launches += 1
    return t, idx, attr


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library with its C signatures."""
    lib = build.load("sphere_scan")
    vp = ctypes.c_void_p
    lib.lpt_sphere_scan.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                    ctypes.c_int, vp]
    lib.lpt_sphere_scan.restype = ctypes.c_int
    lib.lpt_error_string.argtypes = [ctypes.c_int]
    lib.lpt_error_string.restype = ctypes.c_char_p
    return lib


def intersect_spheres_scan_plain(ro, rd, table, attrs, t_min: float = T_MIN):
    """Plain PyTorch twin of the kernel, on any device: the same operations in
    the same order, each rounded on its own (IEEE f32, no FMA contraction),
    chunked over spheres, with a first-index argmin. It agrees with the
    kernel bit for bit."""
    n, s = ro.shape[0], table.shape[0]
    dev = ro.device
    t_min_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    ro_c = [ro[:, d:d + 1] for d in range(3)]                       # [N, 1]
    rd_c = [rd[:, d:d + 1] for d in range(3)]
    t_best = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    idx_best = torch.zeros((n,), dtype=torch.int64, device=dev)
    for s0 in range(0, s, PLAIN_CHUNK):
        tab = table[s0:s0 + PLAIN_CHUNK]
        c = [tab[None, :, _CX + d] for d in range(3)]                # [1, sc]
        r2 = tab[None, :, _R2]
        flag = tab[None, :, _FLAG]
        oc = [ro_c[d] - c[d] for d in range(3)]                      # [N, sc]
        half_b = -((oc[0] * rd_c[0] + oc[1] * rd_c[1]) + oc[2] * rd_c[2])
        c0 = ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]) - r2
        disc = half_b * half_b - c0
        # sqrt of a negative disc is NaN; every compare with NaN is false, so
        # misses and padding (r2 = -inf) fall out of the t >= t_min test.
        # PyTorch's vectorized f32 sqrt on the CPU is not always correctly
        # rounded; the f64 sqrt rounded to f32 is, like the kernel's IEEE sqrt.
        sq = torch.sqrt(disc.to(torch.float64)).to(torch.float32)
        t_near = half_b - sq
        use_far = (t_near < t_min_t) & (flag > 1.5)
        t = torch.where(use_far, half_b + sq, t_near)
        t = torch.where(t >= t_min_t, t, inf)
        t_chunk, i_chunk = torch.min(t, dim=1)   # first index of the minimum
        better = t_chunk < t_best
        t_best = torch.where(better, t_chunk, t_best)
        idx_best = torch.where(better, i_chunk + s0, idx_best)
    return t_best, idx_best.to(torch.int32), attrs[idx_best]
