"""The benchmark's arithmetic on hand-worked inputs."""

import pytest

from benchmark.harness import peaks, stats, trace
from benchmark.harness.loop import frame_seed
from benchmark.metrics import (device_idle_share, frame_ms_p95, k1_roofline, k4_roofline,
                               launches_per_frame, msamples_per_s, passes_per_frame,
                               peak_mem_gib, setup_s)


def test_sphere_roofline_from_counts():
    # 1e9 segments x 485 spheres x 20 operations at 67 TFLOP/s
    assert peaks.sphere_scan_seconds(10 ** 9, 485) == pytest.approx(9.7e12 / 67e12)
    # 67 MB moved and 67 GFLOP: 1 ms by operations, 0.02 ms by bytes
    assert peaks.bound_seconds(67e6, 67e9) == (pytest.approx(1e-3), "operations")
    assert peaks.bound_seconds(3.35e9, 1.0) == (pytest.approx(1e-3), "bytes")
    assert peaks.share(0.01, 0.04) == pytest.approx(25.0)
    assert peaks.share(0.01, 0.0) is None


def _record(kernels, frames=2, segments=(1000, 3000), spheres=10):
    tr = {"frames": frames, "kernels": kernels, "launches": 7, "busy_s": 0.3,
          "window_s": 0.4}
    fr = [{"start": 0.0, "end": 0.5, "segments": s, "samples": 100, "stats": {"passes": 3}}
          for s in segments]
    return {"trace": tr, "frames": fr, "spheres": spheres,
            "ranks": [{"window_peak_bytes": 2 ** 30}, {"window_peak_bytes": 3 * 2 ** 30}]}


def test_kernel_rooflines_read_their_kernel():
    rec = _record({"bounce_pass_kernel(Args)": [5, 2e-9], "sphere_scan_kernel": [3, 4e-9]})
    bound = peaks.sphere_scan_seconds(4000, 10)           # 1.194e-9 s
    assert k4_roofline.read(rec) == pytest.approx(100 * bound / 2e-9)
    assert k1_roofline.read(rec) == pytest.approx(100 * bound / 4e-9)
    assert k4_roofline.read(_record({"other": [1, 1.0]})) is None   # nothing to read: no value


def test_idle_share_from_synthetic_intervals():
    # device busy [0,1] and [2,3] of the window [0,4]: idle 50 %
    red = trace.reduce([("k", 0.0, 1.0), ("k", 2.0, 3.0), ("Memcpy HtoD", 0.5, 0.9)],
                       [("aten::item", 1.0, 2.0), ("cudaStreamSynchronize", 1.2, 1.9)],
                       [(0.0, 4.0)])
    assert red["busy_s"] == pytest.approx(2.0)
    assert red["window_s"] == pytest.approx(4.0)
    assert red["launches"] == 2                              # the copy is not a launch
    # [1, 2] under a host sync, [3, 4] under no host operation
    assert sorted(red["idle_gaps"]) == [["aten::item > cudaStreamSynchronize", pytest.approx(1.0)],
                                        ["host", pytest.approx(1.0)]]
    # the traced frame is stretched to 4 s; untraced ones take 2.5 s (median):
    # busy 2 s of 2.5 s, idle 20 %
    fr = [{"start": 0.0, "end": 4.0}] + [{"start": 0.0, "end": d} for d in (2.0, 2.5, 9.0)]
    assert device_idle_share.read({"trace": red, "frames": fr}) == pytest.approx(20.0)
    assert device_idle_share.read({"trace": red, "frames": fr[:1]}) is None   # all traced


def test_idle_share_leaves_out_collectives():
    # rank 0 computes [0, 1] and waits in an all-gather [1, 3] of a 3 s frame
    red = trace.reduce([("k", 0.0, 1.0), ("ncclDevKernel_AllGather_RING_LL", 1.0, 3.0)],
                       [], [(0.0, 3.0)])
    assert red["busy_s"] == pytest.approx(3.0) and red["compute_s"] == pytest.approx(1.0)
    fr = [{"start": 0.0, "end": 3.0}, {"start": 0.0, "end": 2.0}]
    assert device_idle_share.read({"trace": red, "frames": fr}) == pytest.approx(50.0)


def test_union_and_gaps():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (3, 5)], 0, 6) == [(0, 1), (2, 3), (5, 6)]


def test_p95_and_whole_frame_window():
    values = list(range(1, 101))                 # nearest rank: the 95th value
    assert stats.p95(values) == 95
    assert stats.p95([7.0]) == 7.0
    frames = [{"start": 0.0, "end": 4.0, "samples": 10}, {"start": 4.0, "end": 9.0, "samples": 10}]
    assert not stats.window_done(frames[:1], 5.0)
    assert stats.window_done(frames, 5.0)       # the frame in flight is finished, not cut
    assert stats.rate(frames) == pytest.approx(20 / 9.0)


def test_counters_and_memory():
    rec = _record({"k": [14, 1e-3]})
    assert launches_per_frame.read(rec) == 7 / 2
    assert passes_per_frame.read(rec) == 3
    assert passes_per_frame.passes({"passes_full": 10, "drain_passes": (2, 3)}) == 15
    assert passes_per_frame.passes({"passes": 4, "n_chunks": 2}) == 6
    assert peak_mem_gib.read(rec) == 3.0


def test_end_to_end_readers():
    frames = [{"start": 1.0, "end": 1.5, "samples": 2e6}, {"start": 1.5, "end": 3.0, "samples": 2e6}]
    rec = {"frames": frames, "setup_s": 7.5}
    assert msamples_per_s.read(rec) == pytest.approx(2.0)          # 4e6 samples in 2 s
    assert frame_ms_p95.read(rec) == pytest.approx(1500.0)
    assert setup_s.read(rec) == 7.5


def test_frame_seeds_are_fixed_and_distinct():
    assert frame_seed(2 ** 31 + 5, 0) == frame_seed(2 ** 31 + 5, 0)
    seeds = {frame_seed(123, i) for i in range(-1, 1000)}
    assert len(seeds) == 1001 and all(0 <= s < 2 ** 31 for s in seeds)
