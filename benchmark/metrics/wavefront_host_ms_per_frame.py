"""Host ms a frame issuing the wavefront integrator's passes (host
dispatch): the median, over the window's untraced frames, of the self host
time of the spans ``lpt.wavefront.pass`` (the pass's own glue),
``lpt.wavefront.hit`` (the world's hit query: K3's launch and the hit
record), ``lpt.wavefront.escape`` (the sky term), ``lpt.bsdf.scatter`` (the
BSDF) and ``lpt.camera.primary`` (a sample's primary rays), from the render
stats' ``spans`` table. The host reads' waits are ``lpt.sync``'s, not these
spans'. Nothing to read where no untraced frame's table has these spans."""

from .host_wait_ms_per_frame import span_ms

SPANS = ("lpt.wavefront.pass", "lpt.wavefront.hit", "lpt.wavefront.escape",
         "lpt.bsdf.scatter", "lpt.camera.primary")


def read(record):
    tr = record["trace"]
    untraced = record["frames"][tr["frames"] if tr else 0:]
    if not any(SPANS[0] in f["stats"].get("spans", {}) for f in untraced):
        return None
    return span_ms(record, SPANS)
