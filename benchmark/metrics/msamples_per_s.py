"""Millions of samples a second: W x H x spp of every whole frame of the
window over the time from the first frame's start to the last one's end
(``harness.stats.rate``)."""

from ..harness import stats


def read(record):
    return stats.rate(record["frames"]) / 1e6
