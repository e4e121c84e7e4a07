"""Tracing / profiling utilities.

Counterpart of ``learn_path_tracing_tpu.utils.profiling``:

- ``timed``: context manager printing wall time + derived Mrays/s (the
  card is synchronised before the clock is read);
- ``trace``: context manager wrapping ``torch.profiler`` around a block and
  writing a Chrome trace (``trace.json``) into ``logdir``, a relative
  ``outputs/lpt_trace`` unless it is given one (open it in Perfetto or
  chrome://tracing);
- ``RayStats``: accumulates per-render live-ray counters (segments) into
  a structured report.

The port's own tracing, with two sinks:

- ``span(name)``: a context manager around one of the program's layers
  (``spanned(name)``: a decorator putting a function's calls inside it),
  named ``lpt.<layer>.<what>``. While ``torch.profiler`` records, it is a
  ``record_function`` (a ``user_annotation`` event of the Chrome trace, on
  the clock of the device's kernels). While a render that was asked for
  ``stats`` runs (``recording``), it adds its count and its self host
  seconds (its ``perf_counter`` time less that of the spans inside it) to
  the render's table. With neither sink open it returns a shared no-op
  after one check, allocating nothing.
- ``host_read(read, *args)``: ``read(*args)``, a device→host read (``int``,
  ``.tolist()``, ``.item()``, ``torch.nonzero``): the host waits on the
  device there. While the profiler records it is a ``record_function``
  named ``lpt.sync``; in the render's table it counts in ``host_reads`` and
  its wait goes to ``lpt.sync`` and out of the enclosing span's self time.
  Its bookkeeping is done before the read, while the device still works,
  but for one clock reading after it.

A render called with ``stats=True`` (``render_persistent``,
``render_hybrid``) adds to its stats dict:

- ``spans``: ``{name: [count, self seconds]}``, the root ``lpt.render.<engine>``
  included (its self time is the render's glue code);
- ``host_reads``: the render's device→host reads;
- ``kernels``: ``{kernel: {"launches", "lanes" | "bytes"}}``, the call's
  deltas of the hand-written kernels' counters (``ops.kernel_counters``,
  which the render hands to ``recording``), for each kernel it launched:
  nothing on the CPU, where the plain versions run.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import os
import time

import torch

SYNC_SPAN = "lpt.sync"

# the open render's table (``recording``), None outside one
_TABLE = contextvars.ContextVar("lpt_span_table", default=None)
_NULL = contextlib.nullcontext()   # the span of no sink, shared
_profiler_enabled = torch.autograd._profiler_enabled


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
    block; yields the profiler and writes ``<logdir>/trace.json`` after
    (``logdir`` relative to the working directory unless absolute)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def count_delta(before: dict, after: dict) -> dict:
    """The counts between two snapshots of the kernels' counters (``{kernel:
    {counter: total}}``), for each kernel whose launches changed."""
    return {k: {c: v - before[k][c] for c, v in counts.items()}
            for k, counts in after.items() if counts["launches"] != before[k]["launches"]}


class SpanTable:
    """One render call's spans, host reads and kernel counts (``recording``
    opens it and closes it). Its clock runs from one span boundary to the
    next, and each stretch goes to the innermost open span: its self time.
    ``counters()``, a snapshot of the kernels' counters (``{kernel:
    {counter: total}}``), is taken at the open and the close."""

    def __init__(self, counters):
        self.spans = {}          # name -> [count, self seconds]
        self.host_reads = 0
        self.sync_s = 0.0        # the host reads' waits, ``lpt.sync``
        self.open = []           # the open spans' entries, innermost last
        self.t = 0.0             # the last boundary's perf_counter
        self.timers = {}         # name -> its _Timer, made at its first span
        self.counters = counters
        self.kernels = counters()   # the totals at the open, deltas after the close

    def timer(self, name):
        """The ``_Timer`` of span ``name``, made at its first use."""
        entry = self.spans[name] = [0, 0.0]
        timer = self.timers[name] = _Timer(self, entry)
        return timer

    def close(self):
        self.kernels = count_delta(self.kernels, self.counters())

    def stats(self) -> dict:
        """The keys a render adds to its stats: ``spans``, ``host_reads``,
        ``kernels``."""
        spans = {k: list(v) for k, v in self.spans.items()}
        if self.host_reads:
            spans[SYNC_SPAN] = [self.host_reads, self.sync_s]
        return {"spans": spans, "host_reads": self.host_reads, "kernels": self.kernels}


class _Timer:
    """A span's sink in a table, one a name: entering and leaving it ends a
    stretch of the table's clock."""

    __slots__ = ("table", "entry")

    def __init__(self, table, entry):
        self.table, self.entry = table, entry

    def __enter__(self):
        table, now = self.table, time.perf_counter()
        if table.open:
            table.open[-1][1] += now - table.t
        table.t = now
        table.open.append(self.entry)
        return self

    def __exit__(self, *exc):
        table, now = self.table, time.perf_counter()
        entry = table.open.pop()
        entry[0] += 1
        entry[1] += now - table.t
        table.t = now
        return False


class _Profiled:
    """A span while the profiler records: a ``record_function``, and the
    table's timer when a table is open."""

    __slots__ = ("rf", "timer")

    def __init__(self, name, table):
        self.rf = torch.profiler.record_function(name)
        self.timer = None if table is None else table.timers.get(name) or table.timer(name)

    def __enter__(self):
        self.rf.__enter__()
        if self.timer is not None:
            self.timer.__enter__()
        return self

    def __exit__(self, *exc):
        if self.timer is not None:
            self.timer.__exit__(*exc)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around a layer of the program (module docstring)."""
    table = _TABLE.get()
    if _profiler_enabled():
        return _Profiled(name, table)
    if table is None:
        return _NULL
    return table.timers.get(name) or table.timer(name)


def spanned(name: str):
    """A decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


def host_read(read, *args):
    """``read(*args)``, a read that waits for the device (module docstring)."""
    table = _TABLE.get()
    if _profiler_enabled():
        with torch.profiler.record_function(SYNC_SPAN):
            return read(*args) if table is None else _waited(table, read, args)
    if table is None:
        return read(*args)
    return _waited(table, read, args)


def _waited(table, read, args):
    """``read(*args)`` counted in ``table``: its wait goes to ``lpt.sync``,
    and the clock's last boundary moves on by it, so that the enclosing
    span's self time leaves it out."""
    table.host_reads += 1
    t0 = time.perf_counter()
    out = read(*args)
    waited = time.perf_counter() - t0
    table.sync_s += waited
    table.t += waited
    return out


@contextlib.contextmanager
def recording(stats: bool, root: str, counters):
    """A render call: its root span ``root`` and, with ``stats``, its
    table (``SpanTable(counters)``), yielded (else None) and closed after
    the block."""
    if not stats:
        with span(root):
            yield None
        return
    table = SpanTable(counters)
    token = _TABLE.set(table)
    try:
        with span(root):
            yield table
    finally:
        _TABLE.reset(token)
        table.close()


@contextlib.contextmanager
def unrecorded():
    """A block whose spans and host reads count in no render's table (the
    profiler still sees its spans): work done once for later calls, such as
    capturing a CUDA graph."""
    token = _TABLE.set(None)
    try:
        yield
    finally:
        _TABLE.reset(token)


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
