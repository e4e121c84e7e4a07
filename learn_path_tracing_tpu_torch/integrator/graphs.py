"""CUDA graphs of the integrators' passes: the one capture helper.

``integrator.wavefront.PassGraphs`` (a sphere world's primaries and bounce
pass) and ``integrator.persistent.ModularGraphs`` (the modular engine's
start and its bounce pass at each pool width) run their bodies over static
device buffers, capture them here once and replay them:

- ``takes_graphs``: whether a render takes its graphs, by what it observes;
- ``capture``: each body run once (the warm-up: the kernels load, the
  caches fill), then each captured as a ``torch.cuda.CUDAGraph``, the
  bodies of one call sharing one memory pool. The warm-up and the captures
  count no launch (``ops.uncounted``) and record no span in a render's
  table (``utils.profiling.unrecorded``);
- ``Graph.replay``: one replay, which counts the launches its capture made
  (``ops.count_replay``) as if they had been launched again;
- ``GRAPH_COUNTS``: the graphs captured and replayed in this process, whose
  deltas a render's stats report as ``graph`` (``graph_stats``);
- ``signature``, ``tensor_fields``: what a captured graph depends on, for
  the integrators' keys and buffers.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..ops import count_replay, kernel_counters, uncounted
from ..utils.profiling import count_delta, unrecorded

# CUDA graphs captured and replayed in this process
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def takes_graphs(scene: str, device, n: int) -> bool:
    """A render of ``n`` lanes takes CUDA graphs: a sphere world (the
    legacy world's traversal reads its error word on every call) on a CUDA
    device, with at least one lane, and no ``TorchDispatchMode`` open
    (``utils.checks.checked_trace``'s NaN trap reads every op's output,
    which a capture forbids and a replay would bypass)."""
    return (scene == "spheres" and torch.device(device).type == "cuda" and n > 0
            and _get_current_dispatch_mode() is None)


def tensor_fields(x):
    """``(name, tensor)`` of each tensor field of the dataclass ``x``."""
    return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)]


def signature(x, address: bool = True):
    """What a captured graph depends on in ``x`` (a tensor, a dataclass or
    tuple of them, or a plain value): each tensor's device, dtype, shape,
    strides and, with ``address``, its address; every other value."""
    if isinstance(x, torch.Tensor):
        return (str(x.device), x.dtype, tuple(x.shape), x.stride(),
                x.data_ptr() if address else None)
    if dataclasses.is_dataclass(x):
        return tuple(signature(getattr(x, f.name), address) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(signature(v, address) for v in x)
    return x


def graph_stats(before: dict) -> dict:
    """The graphs captured and replayed since the snapshot ``before`` of
    ``GRAPH_COUNTS``."""
    return {k: n - before[k] for k, n in GRAPH_COUNTS.items()}


class Graph:
    """A captured body: ``replay`` runs its kernels again on its device and
    counts the launches its capture made (``counts``)."""

    __slots__ = ("graph", "counts", "device")

    def __init__(self, graph, counts: dict, device):
        self.graph, self.counts, self.device = graph, counts, device

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        count_replay(self.counts)
        GRAPH_COUNTS["replays"] += 1


def capture(device, bodies) -> list:
    """``bodies`` (functions of no argument that read and write only
    buffers made outside them) captured on ``device``: each run once, then
    each captured, sharing one memory pool. Returns a ``Graph`` a body.

    Sharing the pool is safe because no tensor made inside a body outlives
    it: the graphs' temporaries are free at each body's end, so replays in
    any order, one at a time, overwrite nothing another graph keeps."""
    graphs = []
    with torch.cuda.device(device), unrecorded(), uncounted():
        for body in bodies:
            body()
        pool = torch.cuda.graph_pool_handle()
        for body in bodies:
            before = kernel_counters()
            graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA calls (the viewer's HTTP
            # threads) do not break this thread's capture
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                body()
            graphs.append(Graph(graph, count_delta(before, kernel_counters()), device))
    GRAPH_COUNTS["captures"] += len(graphs)
    return graphs
