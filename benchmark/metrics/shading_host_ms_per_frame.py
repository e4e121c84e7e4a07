"""Host ms a frame issuing the legacy shading (host dispatch): the median,
over the window's untraced frames, of the self host time of the spans
``lpt.legacy.attrs`` (``scene.legacy_world._attrs_rows``: the K6 row gathers
and the atlas taps), ``lpt.legacy.env`` (the environment's background) and
``lpt.bsdf.scatter`` (the BSDF), from the render stats' ``spans`` table.
Nothing to read where the stats have no span table."""

from .host_wait_ms_per_frame import span_ms

SHADING = ("lpt.legacy.attrs", "lpt.legacy.env", "lpt.bsdf.scatter")


def read(record):
    return span_ms(record, SHADING)
