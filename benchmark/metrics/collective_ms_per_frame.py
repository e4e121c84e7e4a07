"""Device ms a frame of the NCCL kernels on rank 0 (``parallel.mesh.combine``
and the window's stop vote), over the traced frames: the transfer and the
wait for the slowest tile."""

from ..harness import trace


def read(record):
    tr = record["trace"]
    sec = trace.kernel_seconds(tr, "nccl") if tr else 0.0
    return 1e3 * sec / tr["frames"] if sec else None
