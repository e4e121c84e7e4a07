"""Device-to-host reads a frame (integrators): the mean, over the window's
frames, of the render stats' ``host_reads`` (``utils.profiling.host_read``
in the program: the live and hit counts, the lane list's counts, the mesh
traversal kernel's error flag). Each read is a round trip in which the
device runs dry. Nothing to read where the stats lack the count."""


def read(record):
    counts = [f["stats"]["host_reads"] for f in record["frames"]
              if "host_reads" in f["stats"]]
    return sum(counts) / len(counts) if counts else None
