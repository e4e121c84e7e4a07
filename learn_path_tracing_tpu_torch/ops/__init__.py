"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with its
plain PyTorch twin in the same module, except K4 (``bounce_megakernel``):
its plain version is the persistent integrator's own step, so it lives
there (``integrator.persistent.bounce_pass_plain``), and K7
(``legacy_scatter``): its plain version is the BSDF's own body
(``bsdf.bsdf.scatter_legacy_plain``)."""

from . import bounce_megakernel, legacy_scatter, packet_traverse, row_gather, sphere_scan


def kernel_counters() -> dict:
    """``{kernel: {counter: total}}`` of the hand-written kernels' launch
    counters, the snapshot a render's stats table takes its ``kernels``
    deltas from (``utils.profiling.recording``): K1 and K4 count launches;
    K2's modes, K3, K5a and K5b also the lanes they take
    (``traverse.lanes``), and K3 the active lanes among them
    (``packet_traverse.ACTIVE_LANES``); K6a and K6b the bytes of the rows they
    write (``gather.bytes``); K7 its launches and lanes (``scatter.lanes``)."""
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
    return out
