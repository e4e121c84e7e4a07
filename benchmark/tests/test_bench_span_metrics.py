"""The readers of the program's own spans and counters (render stats
``spans``, ``host_reads``, ``kernels``) on hand-worked records, and the
metrics they give in a small traced CPU run of each one-card cell."""

import json

import pytest

from benchmark.harness import peaks
from benchmark.metrics import (host_reads_per_frame, host_wait_ms_per_frame, k2_roofline,
                               k6_roofline, shading_host_ms_per_frame)
from benchmark.tests import tiny

READERS = (host_reads_per_frame, host_wait_ms_per_frame, shading_host_ms_per_frame,
           k2_roofline, k6_roofline)


def _frame(reads, spans, kernels):
    return {"start": 0.0, "end": 1.0, "segments": 10, "samples": 100,
            "stats": {"passes": 3, "host_reads": reads, "spans": spans, "kernels": kernels}}


def _record(traced=1):
    """Three frames, the first traced: its kernels ran 2 ms of
    ``packet_traverse_kernel`` and 1 + 3 ms of the row gathers."""
    k = {"k2": {"launches": 4, "lanes": 1_000_000},
         "k6a": {"launches": 2, "bytes": 1_000_000},
         "k6b": {"launches": 1, "bytes": 2_350_000}}
    frames = [
        _frame(10, {"lpt.sync": [10, 0.5], "lpt.legacy.attrs": [2, 0.1]}, k),
        _frame(20, {"lpt.sync": [20, 0.002], "lpt.legacy.attrs": [2, 0.010],
                    "lpt.legacy.env": [3, 0.004], "lpt.bsdf.scatter": [2, 0.006],
                    "lpt.hybrid.batch": [2, 1.0]}, k),
        _frame(30, {"lpt.sync": [30, 0.004], "lpt.legacy.attrs": [2, 0.030],
                    "lpt.bsdf.scatter": [2, 0.010]}, k)]
    tr = {"frames": traced, "launches": 7, "busy_s": 0.3, "window_s": 0.4,
          "kernels": {"void packet_traverse_kernel<0, false, false>(...)": [4, 2e-3],
                      "row_gather_narrow_kernel": [2, 1e-3],
                      "row_gather_wide_kernel": [1, 3e-3]}}
    return {"trace": tr, "frames": frames, "spheres": None}


def test_host_reads_are_the_mean_of_every_frame():
    assert host_reads_per_frame.read(_record()) == pytest.approx(20.0)


def test_span_readers_take_the_median_of_the_untraced_frames():
    rec = _record()
    # the untraced frames' lpt.sync: 2 and 4 ms
    assert host_wait_ms_per_frame.read(rec) == pytest.approx(3.0)
    # attrs + env + scatter: 10 + 4 + 6 = 20 ms and 30 + 0 + 10 = 40 ms
    assert shading_host_ms_per_frame.read(rec) == pytest.approx(30.0)
    rec["trace"] = None                  # no traced frame: every frame counts
    assert host_wait_ms_per_frame.read(rec) == pytest.approx(4.0)


def test_kernel_rooflines_from_the_traced_frames_counts():
    rec = _record()
    # 1e6 lanes x 17 B at 3.35 TB/s over 2 ms of packet_traverse_kernel
    assert k2_roofline.read(rec) == pytest.approx(
        100 * 17e6 / peaks.HBM_BYTES_PER_S / 2e-3)
    # 3.35 MB written at 3.35 TB/s (1 us) over 4 ms of the two gathers
    assert k6_roofline.read(rec) == pytest.approx(100 * 1e-6 / 4e-3)
    rec["trace"]["frames"] = 2           # the counts of both traced frames
    assert k6_roofline.read(rec) == pytest.approx(2 * 100 * 1e-6 / 4e-3)


def _absent(rec, what):
    if what == "no trace":
        rec["trace"] = None
    elif what == "no kernels ran":
        rec["trace"]["kernels"] = {}
    elif what == "every frame traced":
        rec["trace"]["frames"] = len(rec["frames"])
    else:                                # the parent's stats: no tables
        for f in rec["frames"]:
            f["stats"] = {"passes": 3}
    return rec


@pytest.mark.parametrize("what,silent", [
    ("no trace", {k2_roofline, k6_roofline}),
    ("no kernels ran", {k2_roofline, k6_roofline}),
    ("every frame traced", {host_wait_ms_per_frame, shading_host_ms_per_frame}),
    ("stats without the tables", set(READERS)),
])
def test_readers_find_nothing_where_their_inputs_are_absent(what, silent):
    rec = _absent(_record(), what)
    for reader in READERS:
        value = reader.read(rec)
        assert (value is None) == (reader in silent), (reader.__name__, value)


COUNTERS = {"cover_mega_spp64": {"host_reads_per_frame.kernel_bound"},
            "cover_auto_spp8": {"host_reads_per_frame"},
            "standin_hybrid_spp32": {"host_reads_per_frame"}}
SPANS = {"cover_mega_spp64": {"host_wait_ms_per_frame.kernel_bound"},
         "cover_auto_spp8": {"host_wait_ms_per_frame"},
         "standin_hybrid_spp32": {"host_wait_ms_per_frame", "shading_host_ms_per_frame"}}


@pytest.mark.parametrize("cell", sorted(COUNTERS))
def test_a_traced_cpu_run_reports_the_new_metrics(tmp_path, cell):
    """A traced run of each one-card cell at a test's size reports the
    cell's counter metrics, and its span metrics wherever the window had an
    untraced frame (a slow host can fill the window with the traced one).
    The kernel rooflines need the card's kernels, so they are absent."""
    code, out = tiny.execute(cell, 2 ** 31 + 77, tmp_path, seconds=3.0, trace=1)
    assert code == 0 and out["correct"]
    with open(tmp_path / "traces" / f"{cell}.record.json") as f:
        record = json.load(f)
    untraced = len(record["frames"]) - record["trace"]["frames"]
    got = set(out["metrics"])
    assert COUNTERS[cell] <= got
    assert (SPANS[cell] & got) == (SPANS[cell] if untraced else set())
    assert not {"k2_roofline", "k6_roofline"} & got
    reads = out["metrics"][next(iter(COUNTERS[cell]))]
    assert reads["value"] > 0 and reads["unit"] == "count"
