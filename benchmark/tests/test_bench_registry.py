"""Every part of every cell is found by its name, and a cell can be added
as data files alone."""

import json
import os

import pytest

from benchmark.harness import registry
from benchmark.tests import tiny


def test_every_part_found_by_name():
    bench = registry.spec()
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        assert cfg["name"] == c["name"] and c["file"] == f"benchmark/configs/{c['name']}.json"
        registry.module("scenes", cfg["scene"]).generate
        registry.module("reference", cfg["reference"]).render
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        drv = registry.module("drivers", cell["driver"])
        assert all(callable(getattr(drv, f)) for f in ("prepare", "setup", "frame"))
        assert set(cell["limits"]) >= {"mean_abs_frac", "pixels_differ", "segments_rel",
                                       "repeated_frames", "nonfinite_frames"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]).read)
    with pytest.raises(KeyError):
        registry.cell("no_such_cell", bench)


def test_metrics_of_a_cell_follow_their_workloads():
    bench = registry.spec()
    mega = registry.cell("cover_mega_spp64", bench)
    auto = registry.cell("cover_auto_spp8", bench)
    names = [m["name"] for m in registry.metrics_of(mega, bench, False)]
    assert names == ["msamples_per_s.kernel_bound", "frame_ms_p95", "setup_s"]
    assert [m["name"] for m in registry.metrics_of(auto, bench, False)] == ["msamples_per_s",
                                                                            "setup_s"]
    assert "k1_roofline" in [m["name"] for m in registry.metrics_of(auto, bench, True)]
    # every per-layer metric of a cell moves an end-to-end metric that the cell reports
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        e2e = {m["name"] for m in registry.metrics_of(cell, bench, False)}
        layer = registry.metrics_of(cell, bench, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer), w["name"]


def test_a_split_metric_has_one_reader():
    from benchmark.metrics import passes_per_frame

    assert registry.reader("passes_per_frame.kernel_bound") is passes_per_frame
    assert registry.reader("passes_per_frame") is passes_per_frame


def test_a_cell_added_as_data_files(tmp_path):
    """A new traffic file and a new entry: no code edited."""
    name = f"cover_mega_spp2_added{os.getpid()}"
    path = os.path.join(registry.HERE, "workloads", f"{name}.json")
    traffic = dict(registry.cell("cover_mega_spp64", registry.spec()), spp=2)
    for k in ("name", "config", "traffic", "chips", "why"):
        traffic.pop(k)
    bench = registry.spec()
    bench["workloads"].append({"name": name, "config": "rtiow_cover", "traffic": "mega_spp2",
                               "chips": 1, "why": "added by a test"})
    for m in bench["per_layer"]:
        if m["name"] == "passes_per_frame":
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(traffic, f)
    try:
        code, out = tiny.execute(name, 11, tmp_path, bench=bench, spp=2, trace=1)
    finally:
        os.remove(path)
    assert code == 0 and out["correct"]
    assert set(out["metrics"]) == {"passes_per_frame"}
