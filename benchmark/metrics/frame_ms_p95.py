"""The 95th percentile, by nearest rank, of the wall time of every frame of
the window, in ms."""

from ..harness import stats


def read(record):
    return 1e3 * stats.p95([f["end"] - f["start"] for f in record["frames"]])
