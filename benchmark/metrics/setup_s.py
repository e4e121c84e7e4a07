"""Set-up: from the start of ``run.py`` to the first timed frame's start, in
s (imports, the world, the process group, the kernels, the warm-up frame)."""


def read(record):
    return record["setup_s"]
