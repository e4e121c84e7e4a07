"""Device ms a frame of the mesh traversal kernels (``ops.packet_traverse``:
K2 and its modes, K5a, K5b) on rank 0, over the traced frames."""

from ..harness import trace

KERNELS = ("packet_traverse_kernel", "packet_walk_v1_kernel", "packet_walk_v3_kernel")


def read(record):
    tr = record["trace"]
    sec = trace.kernel_seconds(tr, *KERNELS) if tr else 0.0
    return 1e3 * sec / tr["frames"] if sec else None
