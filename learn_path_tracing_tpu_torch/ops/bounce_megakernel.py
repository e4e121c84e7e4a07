"""Kernel K4: one fused persistent bounce pass per lane.

``bounce_pass`` is the port of the JAX package's
``ops/bounce_megakernel.bounce_pass`` (its Pallas kernel ``_kernel``), the
pass of ``integrator.persistent``'s mega engine. For every lane it runs one
whole pass of the persistent integrator: the nearest sphere, the winner's
material, the escaped ray's sky radiance, ``scatter_modern``, the work-item
advance and the thin-lens primary ray of the lane's next item. It launches
the hand-written kernel of ``csrc/bounce_megakernel.cu`` on CUDA tensors and
raises for any other device.

The kernel's plain version is the integrator's own step on this state
layout, so it lives with the integrator
(``integrator.persistent.bounce_pass_plain``), and the integrator's
``mega_pass`` picks between the two by device: the plain version for CPU
tensors, this kernel for CUDA tensors, with no fallback between them.

State, the JAX package's layout (lane = column), so that numpy state
carries across unchanged:

- ``stf f32[16, N]``: rows 0-2 ``ro``, 3-5 ``rd``, 6-8 throughput, 9 alive
  (1.0 or 0.0), 10-12 the pass's escaped radiance ``contrib`` (written; the
  input rows are ignored), 13-15 zero;
- ``sti i32[8, N]``: row 0 the work-item counter ``k``, 1 the bounce, 2 the
  nearest sphere of the pass's ray (-1 on a miss or for a dead lane; the
  JAX kernel leaves this row 0), 3-7 zero.

``N = W·H`` lanes and ``spp | N``: lane ``L`` serves group ``g = L // spp``
and sample ``L % spp``; its item ``k`` is pixel ``g + k·(N/spp)``.

What the port does not carry over from the TPU kernel, because each is a
workaround for the TPU:

- the expanded quadratic on the MXU (``o·o − 2o·c + c·c − r²``), which is
  ill-conditioned on the r = 10000 ground: the scan is K1's exact
  ``oc = ro − c`` form over the world's K1 tables (``scan_table``,
  ``scan_attrs``), not ``pack_scene``'s rows;
- the one-hot MXU gather of the winner's attributes: a row load;
- the Abramowitz–Stegun polynomial acos (|err| ≤ 6.7e-5; Mosaic has no
  acos) and the direct slerp form: ``acosf`` and ``sampling.slerp``'s
  angle-difference form.

So the pass computes the modular engine's per-sample values, and the kernel
follows its plain version's operations in order (see the source's header).

Three additions over the JAX kernel: the pass can deposit its contributions
into the render's int64 fixed-point accumulator (``acc``, 2**-32 units,
order-free); it runs over a compacted list of lanes (``LaneList``) and
updates the state in place, so a render's passes visit only the lanes still
alive and, once, those that died in the pass before; and it counts the
lanes alive after it and those that died in it on the device
(``LaneList.counters``), which the render loop reads once per pass
(``LaneList.advance``). Since a dead lane never lives again and a pass
leaves a settled dead lane's rows as they are, the state after every listed
pass is the all-lanes pass's, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..camera.camera import LensFrame, lens_frame, thin_lens_rays
from ..utils.profiling import host_read
from . import build

T_MIN = 1e-4
STF_ROWS, STI_ROWS = 16, 8
# stf rows
RO, RD, THP, ALIVE, CONTRIB = 0, 3, 6, 9, 10
# sti rows
K, BOUNCE, OBJ = 0, 1, 2
# camera vector layout (f32[16], the JAX package's)
_POS, _DIR, _WA, _HA, _VW, _VH, _HALFAP, _FOCAL = 0, 3, 6, 9, 12, 13, 14, 15

FIXED_ONE = 2.0 ** 32   # accumulator units per unit radiance


def pack_camera(cam, resolution):
    """The thin-lens constants of ``cam`` (``CameraParams``) at
    ``resolution`` as ``f32[16]`` on its device: position, view direction,
    width and height axes, view width and height, half aperture, focal
    length (the JAX package's layout)."""
    f = lens_frame(cam, resolution)
    return torch.cat([f.position, f.direction, f.width_axis, f.height_axis,
                      torch.stack([f.view_width, f.view_height, f.half_aperture,
                                   f.focal_length])]).to(torch.float32)


def unpack_camera(scalf) -> LensFrame:
    """``pack_camera``'s vector back as a ``LensFrame`` of views."""
    return LensFrame(
        position=scalf[_POS:_POS + 3], direction=scalf[_DIR:_DIR + 3],
        width_axis=scalf[_WA:_WA + 3], height_axis=scalf[_HA:_HA + 3],
        view_width=scalf[_VW], view_height=scalf[_VH],
        half_aperture=scalf[_HALFAP], focal_length=scalf[_FOCAL])


def initial_state(cam, resolution, spp: int, seed):
    """``(stf, sti)`` before the first pass: every lane alive on the primary
    ray of its item 0 (pixel ``L // spp``, sample ``L % spp``)."""
    w, h = resolution
    n = w * h
    dev = cam.device
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    ro, rd = thin_lens_rays(lens_frame(cam, resolution), resolution, lanes // spp,
                            seed, lanes % spp)
    stf = torch.zeros((STF_ROWS, n), dtype=torch.float32, device=dev)
    stf[RO:RO + 3] = ro.T
    stf[RD:RD + 3] = rd.T
    stf[THP:THP + 3] = 1.0
    stf[ALIVE] = 1.0
    return stf, torch.zeros((STI_ROWS, n), dtype=torch.int32, device=dev)


def check_operands(stf, sti, world_data, scalf, resolution, spp, acc=None, lanes=None):
    """Raise ``ValueError`` naming the first operand of a pass whose dtype,
    shape or device is not the layout's."""
    w, h = resolution
    n = w * h
    if spp < 1 or n % spp:
        raise ValueError(f"bounce pass: spp={spp} must divide W*H={n}")
    s = world_data.scan_table.shape[0]
    dev = stf.device
    operands = [("stf", stf, torch.float32, (STF_ROWS, n)),
                ("sti", sti, torch.int32, (STI_ROWS, n)),
                ("scalf", scalf, torch.float32, (16,)),
                ("scan_table", world_data.scan_table, torch.float32, (s, 8)),
                ("scan_attrs", world_data.scan_attrs, torch.float32, (s, 16))]
    if acc is not None:
        operands.append(("acc", acc, torch.int64, (n, 3)))
    if lanes is not None:
        operands += [("lanes", lanes.lanes, torch.int32, (n,)),
                     ("lanes.next", lanes.next, torch.int32, (n,))]
    for name, x, dtype, shape in operands:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"bounce pass: {name} must be {dtype}{list(shape)}, "
                             f"got {x.dtype}{list(x.shape)}")
        if x.device != dev:
            raise ValueError(f"bounce pass: {name} is on {x.device}, state on {dev}")


class LaneList:
    """The lanes a mega pass visits, on the state's device.

    ``lanes[:count]`` are distinct lanes, the first ``alive`` of them alive
    on entry and the rest dead lanes whose rows are not yet those of a dead
    lane (``of_state``). A pass over the list updates only those lanes, in
    place, and writes the next list into ``next`` and ``counters`` (the
    lanes alive after the pass, then the lanes that died in it: each lane
    is listed once more after its death); ``advance`` then reads the two
    counts (the pass's one host read, ``utils.profiling.host_read``) and
    makes that list the current one."""

    def __init__(self, lanes, count: int, alive: int):
        self.lanes = lanes                       # i32[N]
        self.count, self.alive = count, alive
        self.next = torch.empty_like(lanes)      # i32[N], written by a pass
        self.counters = torch.zeros((2,), dtype=torch.int32, device=lanes.device)

    @classmethod
    def of_state(cls, stf, sti) -> "LaneList":
        """The list a pass from ``(stf, sti)`` must visit: the alive lanes,
        then the dead lanes whose rows a pass would still change (contrib
        or rows 13-15 not zero, bounce not 0, sphere not -1, rows 3-7 of
        ``sti`` not zero)."""
        alive = stf[ALIVE] > 0.5
        settled = (~alive & (stf[CONTRIB:].view(torch.int32) == 0).all(0)
                   & (sti[BOUNCE] == 0) & (sti[OBJ] == -1) & (sti[OBJ + 1:] == 0).all(0))
        first = host_read(torch.nonzero, alive).flatten()
        rest = host_read(torch.nonzero, ~alive & ~settled).flatten()
        lanes = torch.zeros((stf.shape[1],), dtype=torch.int32, device=stf.device)
        lanes[:first.numel()] = first.to(torch.int32)
        lanes[first.numel():first.numel() + rest.numel()] = rest.to(torch.int32)
        return cls(lanes, first.numel() + rest.numel(), first.numel())

    def advance(self) -> int:
        """After a pass over the list: the next list becomes the current one;
        returns the number of lanes alive after the pass."""
        live, died = host_read(self.counters.tolist)
        if live + died != self.alive:
            raise RuntimeError(f"lane list: {live} alive + {died} died after the pass, "
                               f"but {self.alive} were alive on entry")
        self.lanes, self.next = self.next, self.lanes
        self.count, self.alive = self.alive, live
        return live


def bounce_pass(stf, sti, world_data, scalf, seed, resolution, spp: int, lanes: LaneList,
                limit: int = 32, t_min: float = T_MIN, acc=None):
    """One fused persistent pass of K4 on CUDA tensors, over the lanes of
    ``lanes`` (a ``LaneList``), in place.

    ``world_data`` is a ``SphereWorldData`` on the state's device; ``scalf``
    is ``pack_camera``'s vector; ``seed`` an int (negative seeds wrap to
    uint32, as in ``core.rng``). The pass updates the listed lanes' columns
    of ``stf``/``sti`` and writes the next list and its counts into
    ``lanes`` (read them with ``lanes.advance()``). When ``acc``
    (``i64[N,3]``) is given, it adds ``round(contrib · 2**32)`` of its
    escaped lanes at pixel ``g + k·(N/spp)`` (``k`` before the advance).
    Each launch counts in ``bounce_pass.launches``. State on any other
    device raises.
    """
    check_operands(stf, sti, world_data, scalf, resolution, spp, acc, lanes)
    if stf.device.type != "cuda":
        raise ValueError(f"bounce pass kernel: no kernel for device {stf.device} "
                         "(the plain version is integrator.persistent.bounce_pass_plain)")
    table, attrs = world_data.scan_table, world_data.scan_attrs
    for name, x in (("stf", stf), ("sti", sti), ("scalf", scalf), ("scan_table", table),
                    ("scan_attrs", attrs), ("acc", acc), ("lanes", lanes.lanes)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"bounce pass kernel: {name} must be contiguous")
    lib = load_kernel()
    w, h = resolution
    n = w * h
    dev = stf.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lpt_bounce_pass(
            stf.data_ptr(), sti.data_ptr(), table.data_ptr(), attrs.data_ptr(),
            scalf.data_ptr(), acc.data_ptr() if acc is not None else None,
            lanes.lanes.data_ptr(), lanes.count, lanes.alive, lanes.next.data_ptr(),
            lanes.counters.data_ptr(), n, table.shape[0], spp, w, h, limit, float(t_min),
            int(seed) & 0xFFFFFFFF, stream)
    if err != 0:
        msg = lib.lpt_error_string(err).decode()
        raise RuntimeError(f"bounce pass kernel launch failed: {msg} ({err})")
    bounce_pass.launches += 1


bounce_pass.launches = 0


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library with its C signatures."""
    lib = build.load("bounce_megakernel")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lpt_bounce_pass.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, vp,
                                    ci, ci, ci, ci, ci, ci, ctypes.c_float,
                                    ctypes.c_uint32, vp]
    lib.lpt_bounce_pass.restype = ci
    lib.lpt_error_string.argtypes = [ci]
    lib.lpt_error_string.restype = ctypes.c_char_p
    return lib
