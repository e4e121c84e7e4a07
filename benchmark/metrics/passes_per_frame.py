"""Bounce passes a frame (integrators), from the window frames' render stats.

Modular engine: ``passes_full`` + the drain levels' passes; mega engine:
``passes``; hybrid: ``passes`` (pool passes) + ``n_chunks`` (primary slabs).
Exact counts: a pass is a host round trip and a set of launches."""


def passes(stats):
    if "passes_full" in stats:
        return stats["passes_full"] + sum(stats["drain_passes"])
    if "n_chunks" in stats:
        return stats["passes"] + stats["n_chunks"]
    return stats.get("passes")


def read(record):
    counts = [passes(f["stats"]) for f in record["frames"]]
    counts = [c for c in counts if c is not None]
    return sum(counts) / len(counts) if counts else None
