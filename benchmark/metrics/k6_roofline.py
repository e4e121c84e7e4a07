"""K6a and K6b (``ops.row_gather``'s ``row_gather_narrow_kernel`` and
``row_gather_wide_kernel``) against their bytes roofline over the traced
frames, in %: the bytes of the rows they wrote (the render stats'
``kernels`` counts, ``gather.bytes``) at the HBM peak (``harness.peaks``),
over the two kernels' device time in those frames. The rows read and the
indices are left out, so the bound is a strict lower one and the share
cannot pass 100 %. Nothing to read where either is absent."""

from ..harness import peaks, trace
from .k2_roofline import counted

KERNELS = ("k6a", "k6b")
NAMES = ("row_gather_narrow_kernel", "row_gather_wide_kernel")


def read(record):
    tr = record["trace"]
    measured = trace.kernel_seconds(tr, *NAMES) if tr else 0.0
    written = counted(record, KERNELS, "bytes") if measured else None
    if not written:
        return None
    return peaks.share(peaks.bound_seconds(written, 0.0)[0], measured)
