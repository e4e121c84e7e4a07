"""Tracing / profiling utilities.

Counterpart of ``learn_path_tracing_tpu.utils.profiling``:

- ``timed``: context manager printing wall time + derived Mrays/s (the
  card is synchronised before the clock is read);
- ``trace``: context manager wrapping ``torch.profiler`` around a block and
  writing a Chrome trace (``trace.json``) into ``logdir`` (open it in
  Perfetto or chrome://tracing);
- ``RayStats``: accumulates per-render live-ray counters (segments) into
  a structured report.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, segments=None):
    """Print elapsed wall time; if ``segments`` is a number or a callable
    returning the traced ray-segment count, also print Mrays/s."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    msg = f"[{label}] {dt:.3f}s"
    if segments is not None:
        segs = float(segments() if callable(segments) else segments)
        msg += f"  {segs:.3e} segments  {segs / dt / 1e6:.1f} Mrays/s"
    print(msg)


@contextlib.contextmanager
def trace(logdir: str = "outputs/lpt_trace"):
    """``torch.profiler`` (host, and the card where there is one) around a
    block; yields the profiler and writes ``<logdir>/trace.json`` after."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class RayStats:
    """Structured render statistics (the 'metrics/logging' subsystem)."""

    def __init__(self):
        self.records = []

    def add(self, *, label: str, seconds: float, segments: float,
            pixels: int, spp: int):
        self.records.append({
            "label": label,
            "seconds": round(seconds, 4),
            "segments": segments,
            "pixels": pixels,
            "spp": spp,
            "mrays_per_sec": round(segments / max(seconds, 1e-9) / 1e6, 2),
            "avg_bounces": round(segments / max(pixels * spp, 1), 3),
        })

    def report(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records)
