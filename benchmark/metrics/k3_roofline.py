"""K3 (``ops.packet_traverse``'s ``packet_traverse_kernel<kSpheres>``: the
sphere BVH walk of ``scene.world.hit(backend='bvh')``) against its bytes
roofline over the traced frames, in %.

Bytes: every lane a launch takes reads its ``t_init`` (4 B) and active flag
(1 B) and writes ``t``, ``prim`` and ``iters`` (12 B), 17 B as
``k2_roofline`` counts; each active lane also reads its ray's origin and
direction (24 B). The lanes and the active lanes are the traced frames'
render stats ``kernels`` counts of ``k3`` (``traverse.lanes``, and
``packet_traverse.ACTIVE_LANES``, which the caller counts on the host). The node,
entry and leaf tables the walk reads are left out, so the bound is a lower
one and the share cannot pass 100 %. The bytes move at the HBM peak
(``harness.peaks``) over K3's device time in those frames.

K3 is one instance of the template that also carries K2 and its modes; its
leaf kind, the first template argument of the kernel's name in the trace,
tells it apart (``kSpheres`` = 1: ``packet_traverse_kernel<1, ...>``, or
``...kernelILi1E...`` where the name is mangled). Where no name shows a
template argument, the time of every ``packet_traverse_kernel`` is K3's
only if the traced frames counted K3 lanes and no lanes of K2 or its modes.
Nothing to read otherwise, or where the counts are absent.
"""

import re

from ..harness import peaks
from .k2_roofline import KERNELS, LANE_BYTES

NAME = "packet_traverse_kernel"
TEMPLATE = re.compile(NAME + r"(<\s*(\d+)\s*,|ILi(\d+)E)")
K3_LEAF = "1"
RAY_BYTES = 24


def _counts(record, kernel, counter):
    """The sum of ``counter`` of ``kernel`` over the traced frames' render
    stats (0 where the kernel did not launch); None where a frame's stats
    lack the ``kernels`` table or a launched kernel's counter."""
    total = 0
    for f in record["frames"][:record["trace"]["frames"]]:
        table = f["stats"].get("kernels")
        if table is None or (kernel in table and counter not in table[kernel]):
            return None
        total += table.get(kernel, {}).get(counter, 0)
    return total


def k3_seconds(record) -> float:
    """K3's device seconds in the traced frames (see the module doc)."""
    kernels = record["trace"]["kernels"]
    walks = {name: sec for name, (_, sec) in kernels.items() if NAME in name}
    leaves = {name: TEMPLATE.search(name) for name in walks}
    if any(leaves.values()):
        return sum(sec for name, sec in walks.items()
                   if leaves[name] and K3_LEAF in leaves[name].groups()[1:])
    others = [_counts(record, k, "lanes") for k in KERNELS if k != "k3"]
    if any(c is None or c > 0 for c in others):
        return 0.0
    return sum(walks.values())


def read(record):
    if not record["trace"]:
        return None
    measured = k3_seconds(record)
    lanes = _counts(record, "k3", "lanes") if measured else None
    active = _counts(record, "k3", "active_lanes") if lanes else None
    if not lanes or active is None:
        return None
    n_bytes = lanes * LANE_BYTES + active * RAY_BYTES
    return peaks.share(peaks.bound_seconds(n_bytes, 0.0)[0], measured)
