"""K4 (``ops.bounce_megakernel``, ``bounce_pass_kernel``) against its
roofline: the least time for the traced frames' segments, each tested
against every sphere of the scene (``harness.peaks``), over K4's device
time in those frames, in %."""

from ..harness import peaks


def read(record):
    return peaks.sphere_kernel_share(record, "bounce_pass_kernel")
