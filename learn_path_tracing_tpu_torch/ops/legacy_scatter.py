"""Kernel K7: the legacy BSDF's scatter, one thread a lane.

``scatter`` is ``bsdf.bsdf.scatter_legacy`` on CUDA tensors: it launches the
hand-written kernel of ``csrc/legacy_scatter.cu``, which computes the whole
call (the seven uniforms of the lane's base hash, both lobes and the
selects) in one launch, where the plain PyTorch body issues ~300 eager ops.
Its plain twin is that body, ``bsdf.bsdf.scatter_legacy_plain``, which
``scatter_legacy`` runs for tensors on any other device; K7 gives its bits
on the card. K7 replaces no Pallas kernel: on the TPU, XLA fuses the plain
body into one fusion.

Operands (``N`` lanes, all on one CUDA device): the rays' ``rd`` and
``throughput`` and the hits' ``point``, ``normal`` and ``material.albedo``
f32[N, 3]; the material's ``roughness``, ``metallic``, ``ior``,
``transparency`` and ``absorptivity`` f32[N]; ``base`` int64[N]
(``core.rng.base``). A gathered view that is not contiguous is copied
first. Each launch counts in ``scatter.launches``, and its lanes in
``scatter.lanes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.types import Hits, Rays
from . import build

LANE_BYTES = 124    # read: five f32 rows of 3, five f32 scalars, the i64 hash; written: 36
_ROWS = ("rd", "throughput", "point", "normal", "albedo")
_SCALARS = ("roughness", "metallic", "ior", "transparency", "absorptivity")


def _operands(rays: Rays, hits: Hits, base) -> dict:
    """K7's operands by name, in the C entry's order, after checking each:
    raises ``ValueError`` naming the first whose type, dtype, shape or
    device is not the layout's. Touches no device."""
    if not isinstance(base, torch.Tensor) or base.dtype != torch.int64 or base.dim() != 1:
        got = (f"{base.dtype}{list(base.shape)}" if isinstance(base, torch.Tensor)
               else type(base).__name__)
        raise ValueError(f"legacy scatter: base must be a torch.int64[N] tensor, got {got}")
    n, dev = base.shape[0], base.device
    mat = hits.material
    ops = {"rd": rays.rd, "throughput": rays.throughput, "point": hits.point,
           "normal": hits.normal, "albedo": mat.albedo,
           **{k: getattr(mat, k) for k in _SCALARS}}
    for name, x in ops.items():
        shape = (n, 3) if name in _ROWS else (n,)
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"legacy scatter: {name} must be torch.float32{list(shape)}, "
                             f"got {x.dtype}{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"legacy scatter: {name} is on {x.device}, base on {dev}")
    ops["base"] = base
    return ops


def scatter(rays: Rays, hits: Hits, base) -> Rays:
    """``scatter_legacy(rays, hits, base)`` through K7, on CUDA tensors:
    the next ``ro``, ``rd`` and ``throughput`` of every lane, ``alive``
    passed through. Raises ``ValueError`` for operands off the layout or on
    any other device (the plain twin is
    ``bsdf.bsdf.scatter_legacy_plain``)."""
    ops = _operands(rays, hits, base)
    dev = base.device
    if dev.type != "cuda":
        raise ValueError(f"legacy scatter kernel: no kernel for device {dev} "
                         "(the plain version is bsdf.bsdf.scatter_legacy_plain)")
    ops = {k: x.contiguous() for k, x in ops.items()}
    n = base.shape[0]
    ro, rd, thp = torch.empty((3, n, 3), dtype=torch.float32, device=dev).unbind(0)
    out = Rays(ro=ro, rd=rd, throughput=thp, alive=rays.alive)
    if n == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lpt_legacy_scatter(*(x.data_ptr() for x in ops.values()), ro.data_ptr(),
                                     rd.data_ptr(), thp.data_ptr(), n, stream)
    if err != 0:
        msg = lib.lpt_error_string(err).decode()
        raise RuntimeError(f"legacy scatter kernel launch failed: {msg} ({err})")
    scatter.launches += 1
    scatter.lanes += n
    return out


scatter.launches = 0
scatter.lanes = 0


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library with its C signature."""
    lib = build.load("legacy_scatter")
    vp = ctypes.c_void_p
    lib.lpt_legacy_scatter.argtypes = [vp] * 14 + [ctypes.c_longlong, vp]
    lib.lpt_legacy_scatter.restype = ctypes.c_int
    lib.lpt_error_string.argtypes = [ctypes.c_int]
    lib.lpt_error_string.restype = ctypes.c_char_p
    return lib
