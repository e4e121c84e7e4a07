"""The control comes out not correct: the reference in bfloat16 in the
program's place (sphere cells), the program with its bfloat16 mesh path on
(mesh cells). Small sizes on the CPU; ``test_control_at_cell_size`` runs
the same at the cells' own sizes on a card."""

import os

import pytest
import torch

from benchmark import readings
from benchmark.harness import compare, registry
from benchmark.tests import tiny

CONTROL = {"cover_mega_spp64": "rtiow_cover", "standin_hybrid_spp32": "standin_mesh"}


def _fails(cell_name, control):
    limits = registry.cell(cell_name, registry.spec())["limits"]
    return [any(r[k] > limits[k] for k in ("mean_abs_frac", "pixels_differ", "segments_rel"))
            for r in control.values()]


def test_sphere_control_fails_small(tmp_path):
    cfg = tiny.config("rtiow_cover")
    cfg["resolution"] = [64, 36]
    cfg["digest"] = registry.module("scenes", "rtiow").digest(
        registry.module("scenes", "rtiow").generate(cfg))
    program, control = readings.collect("cover_mega_spp64", [1, 2], [3, 4, 5], device="cpu",
                                        config=cfg, emit=lambda line: None, cache=str(tmp_path))
    assert all(r["mean_abs_frac"] == 0 and r["segments_rel"] == 0 for r in program.values())
    assert all(_fails("cover_mega_spp64", control))


def test_mesh_control_fails_small(tmp_path, monkeypatch):
    cfg = tiny.config("standin_mesh")
    cfg.update(resolution=[64, 40], world=dict(tiny.WORLD, level=4))
    cfg["digest"] = registry.module("scenes", "standin").digest(
        registry.module("scenes", "standin").generate(cfg))
    monkeypatch.delenv(readings.CONTROL_ENV, raising=False)
    program, control = readings.collect("standin_hybrid_spp32", [1, 2], [3, 4, 5], device="cpu",
                                        config=cfg, emit=lambda line: None, cache=str(tmp_path))
    assert all(r["mean_abs_frac"] == 0 for r in program.values())
    assert all(_fails("standin_hybrid_spp32", control))
    assert readings.CONTROL_ENV not in os.environ


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program, control = readings.collect(cell, [11, 12, 13], [21, 22, 23], emit=lambda line: None)
    limits = registry.cell(cell, registry.spec())["limits"]
    assert all(compare.verdict({**r, "repeated_frames": 0, "nonfinite_frames": 0}, limits)[0]
               for r in program.values())
    assert all(_fails(cell, control))
