"""K2 (``ops.packet_traverse``'s ``packet_traverse_kernel``: the mesh walk,
its modes and the sphere walk K3) against its bytes roofline over the
traced frames, in %. Every lane a launch takes, active or not, reads its
``t_init`` (4 B) and active flag (1 B) and writes ``t``, ``prim`` and
``iters`` (12 B): 17 B a lane. An active lane also reads its ray's origin
and direction (24 B), and walks the node, entry and leaf tables (K2r also
its seeds); the launch counts do not say how many lanes were active, so
all of that is left out. The bound is thus a lower one, and the share
cannot pass 100 %. The lanes are the traced frames' render stats
``kernels`` counts (``traverse.lanes``), moved at the HBM peak
(``harness.peaks``), over the device time of ``packet_traverse_kernel`` in
those frames. Nothing to read where either is absent."""

from ..harness import peaks, trace

KERNELS = ("k2", "k2r", "k2h", "k2rh", "k3")   # every packet_traverse_kernel instance
LANE_BYTES = 17


def counted(record, kernels, counter):
    """The sum of ``counter`` over ``kernels`` in the traced frames' render
    stats; None where a traced frame's stats have no ``kernels`` table."""
    tr = record["trace"]
    total = 0
    for f in record["frames"][:tr["frames"]]:
        table = f["stats"].get("kernels")
        if table is None:
            return None
        total += sum(table[k][counter] for k in kernels if k in table)
    return total


def read(record):
    tr = record["trace"]
    measured = trace.kernel_seconds(tr, "packet_traverse_kernel") if tr else 0.0
    lanes = counted(record, KERNELS, "lanes") if measured else None
    if not lanes:
        return None
    return peaks.share(peaks.bound_seconds(lanes * LANE_BYTES, 0.0)[0], measured)
