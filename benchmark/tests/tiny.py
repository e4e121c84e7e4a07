"""Small copies of the benchmark's configurations for the CPU tests."""

from __future__ import annotations

from benchmark import run
from benchmark.harness import registry
from benchmark.scenes import rtiow, standin

COVER = dict(resolution=[32, 18], depth=6, grid_size=3)
WORLD = {"level": 2, "seed": 7, "tex_size": 64, "env_size": [64, 32]}
MESH = dict(resolution=[32, 16], depth=6, world=WORLD)


def config(name):
    """Configuration ``name`` at a CPU test's size, with its own digest."""
    cfg = registry.config(name)
    if cfg["scene"] == "rtiow":
        cfg.update(COVER)
        cfg["digest"] = rtiow.digest(rtiow.generate(cfg))
    else:
        cfg.update(MESH)
        cfg["digest"] = standin.digest(standin.generate(cfg))
    return cfg


def execute(name, seed, cache, seconds=0.3, trace=0, fault=None, spp=4, bench=None):
    """``run.execute`` of cell ``name`` of ``bench`` (``BENCHMARK.json``)
    at test size on the CPU, caching under ``cache``."""
    bench = bench or registry.spec()
    cell = {**registry.cell(name, bench), "spp": spp, "trace_frames": 1}
    return run.execute(cell, config(cell["config"]), registry.metrics_of(cell, bench, trace),
                       seed, seconds, trace, device="cpu", cache=str(cache), fault=fault)
