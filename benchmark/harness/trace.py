"""Reduction of a ``torch.profiler`` session to the benchmark's record.

The session covers a few whole frames, each inside a ``frame`` span, and is
written as a Chrome trace. From its events this module keeps, within the
span of those frames (the traced window): every device operation (kernels, copies, fills), its name and
interval; the host's operations; and from them the device's busy time (the
union of its operations' intervals), each kernel name's count and time,
and the idle gaps of the device, each named by the outermost and innermost
host operation running at its middle. Intervals are ``(start, end)`` in
seconds of the profiler's clock.
"""

from __future__ import annotations

COPY_PREFIXES = ("Memcpy", "Memset")
COLLECTIVE = "nccl"       # in the name of every collective's kernel
FRAME_SPAN = "frame"
NAME_CHARS = 120          # a kernel name is cut to this length in the breakdown


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def host_names(host, times):
    """For each time of ``times`` (ascending), ``outer > inner``: the longest
    and the shortest host operation (``host`` is ``[(name, start, end)]``)
    that span it, or 'host' where none does (Python between operations)."""
    import heapq

    ordered = sorted(host, key=lambda ev: ev[1])
    active, out, k = [], [], 0
    for t in times:
        while k < len(ordered) and ordered[k][1] <= t:
            name, s, e = ordered[k]
            heapq.heappush(active, (e, s, name))
            k += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        if not active:
            out.append("host")
            continue
        spans = [(e - s, name) for e, s, name in active]
        outer, inner = max(spans)[1], min(spans)[1]
        out.append(outer if outer == inner else f"{outer} > {inner}")
    return out


def reduce(device, host, frames) -> dict:
    """The traced window's record from the device operations ``device``
    (``[(name, start, end)]``), the host operations ``host`` and the frame
    spans ``frames`` (``[(start, end)]``): ``window_s``, ``busy_s``,
    ``compute_s``, ``frames``, ``launches`` (kernels, copies and fills left out),
    ``kernels`` (``{name: [count, seconds]}``), ``device_ops`` and
    ``idle_gaps`` (each the ten largest ``[name, seconds]``)."""
    lo, hi = min(s for s, _ in frames), max(e for _, e in frames)
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    busy = union_seconds([(s, e) for _, s, e in inside])
    compute = union_seconds([(s, e) for n, s, e in inside if COLLECTIVE not in n.lower()])
    kernels = {}
    for name, s, e in inside:
        entry = kernels.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += e - s
    launches = sum(c for n, (c, _) in kernels.items() if not n.startswith(COPY_PREFIXES))
    by_name = {}
    for name, (_, sec) in kernels.items():
        short = name[:NAME_CHARS]
        by_name[short] = by_name.get(short, 0.0) + sec
    idle = {}
    holes = gaps([(s, e) for _, s, e in inside], lo, hi)
    for (s, e), name in zip(holes, host_names(host, [0.5 * (s + e) for s, e in holes])):
        idle[name] = idle.get(name, 0.0) + (e - s)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": hi - lo, "busy_s": busy, "compute_s": compute, "frames": len(frames), "launches": launches,
            "kernels": kernels, "device_ops": top(by_name), "idle_gaps": top(idle)}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def from_chrome_trace(path) -> tuple:
    """``(device, host, frames)`` event lists, in seconds, of a Chrome trace
    written by ``torch.profiler`` (its complete events: device kernels,
    copies and fills; host operations and runtime calls; the ``frame``
    spans on the host). Read from the file, which is far faster than the
    profiler's own event tree for a long session."""
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, frames = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) / 1e6
        e = s + float(ev.get("dur", 0.0)) / 1e6
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "user_annotation" and name == FRAME_SPAN:
            frames.append((s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
    return device, host, frames


def kernel_seconds(trace, *names) -> float:
    """Device seconds of the kernels whose name contains any of ``names``."""
    return sum(sec for name, (_, sec) in trace["kernels"].items()
               if any(n in name for n in names))
