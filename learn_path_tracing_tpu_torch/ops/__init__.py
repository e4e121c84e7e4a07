"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with its
plain PyTorch twin in the same module, except K4 (``bounce_megakernel``):
its plain version is the persistent integrator's own step, so it lives
there (``integrator.persistent.bounce_pass_plain``), and K7
(``legacy_scatter``): its plain version is the BSDF's own body
(``bsdf.bsdf.scatter_legacy_plain``)."""

import contextlib

from ..utils.profiling import count_delta
from . import bounce_megakernel, legacy_scatter, packet_traverse, row_gather, sphere_scan

# ``{kernel: {counter: n}}`` that ``kernel_counters`` adds to the kernels'
# own counters: what replayed CUDA graphs launched (``count_replay``), less
# what their warm-ups and captures launched (``uncounted``)
_GRAPHED = {}


def kernel_counters() -> dict:
    """``{kernel: {counter: total}}`` of the hand-written kernels' launch
    counters, the snapshot a render's stats table takes its ``kernels``
    deltas from (``utils.profiling.recording``): K1 and K4 count launches;
    K2's modes, K3, K5a and K5b also the lanes they take
    (``traverse.lanes``), and K3 the active lanes among them
    (``packet_traverse.ACTIVE_LANES``); K6a and K6b the bytes of the rows they
    write (``gather.bytes``); K7 its launches and lanes (``scatter.lanes``).
    A replayed CUDA graph's launches count as its captured calls did."""
    out = {"k1": {"launches": sphere_scan.intersect_spheres_scan.launches},
           "k4": {"launches": bounce_megakernel.bounce_pass.launches},
           "k7": {"launches": legacy_scatter.scatter.launches,
                  "lanes": legacy_scatter.scatter.lanes}}
    t, g = packet_traverse.traverse, row_gather.gather
    for k, n in t.launches.items():
        out[k] = {"launches": n, "lanes": t.lanes[k]}
        if k in packet_traverse.ACTIVE_LANES:
            out[k]["active_lanes"] = packet_traverse.ACTIVE_LANES[k]
    for k, n in g.launches.items():
        out[k] = {"launches": n, "bytes": g.bytes[k]}
    for k, counts in _GRAPHED.items():
        for c, n in counts.items():
            out[k][c] += n
    return out


def _graphed(counts: dict, sign: int):
    for k, c in counts.items():
        into = _GRAPHED.setdefault(k, dict.fromkeys(c, 0))
        for name, n in c.items():
            into[name] += sign * n


def count_replay(counts: dict):
    """Count one replay of a CUDA graph whose capture launched ``counts`` (a
    ``count_delta`` of two ``kernel_counters`` snapshots around it):
    ``integrator.graphs.Graph.replay``."""
    _graphed(counts, 1)


@contextlib.contextmanager
def uncounted():
    """A block whose launches leave ``kernel_counters`` as they were: a CUDA
    graph's warm-up and capture, which its replays count instead."""
    before = kernel_counters()
    try:
        yield
    finally:
        _graphed(count_delta(before, kernel_counters()), -1)
