"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct."""

import pytest

from benchmark.tests import tiny

CASES = [(cell, fault) for cell in ("cover_mega_spp64", "cover_auto_spp8", "standin_hybrid_spp32")
         for fault in (None, "stale", "half", "altered")]
CASES += [("flagship_4card_spp32", None), ("flagship_4card_spp32", "exchange")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, tmp_path):
    code, out = tiny.execute(cell, 424242, tmp_path, seconds=0.6, fault=fault, spp=4)
    assert code == 0
    assert out["correct"] is (fault is None), out["checks"]
    if fault:
        assert out["failed"] >= 1
