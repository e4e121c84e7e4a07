"""Wall-clock timing of whole renders.

Counterpart of ``learn_path_tracing_tpu.utils.benchlib``. The JAX package
forces completion with a scalar read-back and subtracts that read-back's
latency, a workaround for its remote TPU runtime; here a CUDA device
reports completion itself, so there is one timer: ``time_fn`` warms up,
then times each run on its own, from a CUDA event recorded before the run
to one recorded after it, synchronised at the run's end. On the CPU it
reads ``time.perf_counter`` around each run.
"""

from __future__ import annotations

import time

import torch


def time_fn(f, *args, iters: int = 3, warmup: int = 1, device="cuda"):
    """Runs ``f(*args)`` ``warmup`` times, then ``iters`` timed times.
    Returns ``(seconds of each timed run, the last run's output)``.
    ``device``: where ``f`` runs ('cuda' takes CUDA events, any other
    device the host clock)."""
    out = None
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        out = f(*args)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*args)
            end.record()
            end.synchronize()
            seconds.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = f(*args)
            seconds.append(time.perf_counter() - t0)
    return seconds, out
