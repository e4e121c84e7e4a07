"""Kernel launches a frame on rank 0: every CUDA kernel of the traced frames
(copies and fills left out), any name, over the traced frames."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["frames"] or not tr["kernels"]:
        return None
    return tr["launches"] / tr["frames"]
