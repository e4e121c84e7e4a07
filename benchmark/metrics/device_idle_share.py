"""Share of the traced frames on rank 0 in which the device did no work of
the frame, in %: 1 - compute / (traced frames x the median untraced frame's
wall time), where compute is the union of the device's operations other
than collectives (``harness.trace``: a collective's kernel spins while it
waits for the other ranks, and on a traced run they wait for frames that
the profiler stretched). The profiler's recording of every host operation
stretches a traced frame, a host-bound one most, so the traced window's own
length would read the idle share too high; the window's untraced frames
give a frame's length without it. Nothing to read where every frame was
traced."""

import statistics


def read(record):
    tr, frames = record["trace"], record["frames"]
    if not tr or not tr["kernels"]:
        return None
    rest = [f["end"] - f["start"] for f in frames[tr["frames"]:]]
    if not rest:
        return None
    return 100.0 * (1.0 - tr["compute_s"] / (tr["frames"] * statistics.median(rest)))
