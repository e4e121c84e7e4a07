"""Host ms a frame blocked on the device in the program's reads: the median,
over the window's untraced frames, of the self time of the ``lpt.sync``
span (``utils.profiling.host_read``) in the render stats' ``spans`` table.
Nothing to read where the stats have no span table."""

import statistics

SYNC = ("lpt.sync",)


def span_ms(record, names):
    """The median, over the untraced frames whose stats have a ``spans``
    table, of the self host ms of the spans ``names`` together; None where
    no frame has one."""
    tr = record["trace"]
    per = []
    for f in record["frames"][tr["frames"] if tr else 0:]:
        spans = f["stats"].get("spans")
        if spans is not None:
            per.append(1e3 * sum(spans[n][1] for n in names if n in spans))
    return statistics.median(per) if per else None


def read(record):
    return span_ms(record, SYNC)
