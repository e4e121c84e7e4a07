"""Peak device memory of the window (``torch.cuda.max_memory_allocated``
after a reset at its start), the largest over the ranks, in GiB."""


def read(record):
    peak = max(r["window_peak_bytes"] for r in record["ranks"])
    return peak / 2 ** 30 if peak else None
