"""The window's arithmetic: whole frames, the rate, the tail."""

from __future__ import annotations

import math


def rate(frames) -> float:
    """Samples a second over whole frames: every frame's ``samples`` over
    the time from the first frame's start to the last one's end."""
    span = frames[-1]["end"] - frames[0]["start"]
    return sum(f["samples"] for f in frames) / span


def p95(values) -> float:
    """The 95th percentile by nearest rank: the ``ceil(0.95 n)``-th
    smallest value."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)), 1) - 1]


def window_done(frames, seconds: float) -> bool:
    """Whether the window is over: ``seconds`` have passed since the first
    frame's start at the end of the frame in flight."""
    return frames[-1]["end"] - frames[0]["start"] >= seconds
