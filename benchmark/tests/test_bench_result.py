"""The result line: its five keys, the checks last, and the exit codes."""

import json

from benchmark import run
from benchmark.harness import guard
from benchmark.tests import tiny


def test_result_keys_and_checks_last(tmp_path):
    code, out = tiny.execute("cover_auto_spp8", 2 ** 31 + 12345, tmp_path)
    assert code == 0
    keys = list(out)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert keys[-1] == "checks"
    assert set(out["metrics"]) == {"msamples_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["device"]["count"] == 1 and out["correct"] and out["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_traced_result_has_device_times_and_breakdown(tmp_path):
    code, out = tiny.execute("cover_mega_spp64", 99, tmp_path, trace=1)
    assert code == 0
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "msamples_per_s.kernel_bound" not in out["metrics"]
    assert "passes_per_frame.kernel_bound" in out["metrics"]


def test_exit_codes(monkeypatch, capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) == 2
    monkeypatch.setattr(guard, "cards_missing", lambda chips: "no CUDA device is available")
    assert run.main(["--workload", "cover_mega_spp64", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""            # no result printed
