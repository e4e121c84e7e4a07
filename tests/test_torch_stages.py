"""The port's stage scripts and package rules.

- Stage 10 runs through ``run_path_traced`` at a tiny size and writes a PNG.
- The deterministic stages 1-5 write the same PNG as the JAX package's
  stage scripts, to within 1/255 per channel (camera and normal math agree
  to a few ulps; a value on a rounding boundary of the 8-bit raster may
  land one step apart).
- Importing every module of the port loads neither JAX nor the JAX package.
- Every entry point renders on the card unless asked for the CPU: without a
  CUDA device, a run that does not say ``--device cpu`` fails.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import learn_path_tracing_tpu.stages as jstages
import learn_path_tracing_tpu_torch.stages as tstages
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.core.image import read_png
from learn_path_tracing_tpu_torch.models import stage4_scene
from learn_path_tracing_tpu_torch.stages import common, l14_mesh, s10_final
from learn_path_tracing_tpu_torch.utils.config import STAGE_CONFIGS, RenderConfig

torch.set_num_threads(2)


def test_stage10_writes_png(tmp_path):
    out = tmp_path / "10.png"
    img, rep = s10_final.main(["--width", "24", "--height", "16", "--spp", "4",
                               "--limit", "6", "--device", "cpu", "--out", str(out)])
    assert img.shape == (24, 16, 3) and torch.isfinite(img).all()
    png = read_png(str(out))
    assert png.shape == (24, 16, 3) and 0.05 < png.mean() < 0.95
    assert rep["segments"] > 24 * 16 * 4 and rep["passes"] >= 6
    assert len(rep["chunks"]) == 1 and rep["chunks"][0]["pool"] == 24 * 16


def test_stage10_hit_backend_bvh_renders_the_scan_image(tmp_path):
    """``--hit-backend bvh`` builds the world with its sphere BVH and walks
    it; the frame is the scan's bit for bit (the walk finds the scan's
    hits)."""
    args = ["--width", "16", "--height", "9", "--spp", "2", "--limit", "4",
            "--device", "cpu"]
    img, rep = s10_final.main(args + ["--hit-backend", "bvh", "--out", str(tmp_path / "b.png")])
    ref, ref_rep = s10_final.main(args + ["--out", str(tmp_path / "a.png")])
    assert rep["segments"] == ref_rep["segments"]
    assert torch.equal(rep["linear"].view(torch.int32), ref_rep["linear"].view(torch.int32))


def test_chunk_seeds_follow_the_jax_schedule(monkeypatch):
    """Each spp chunk renders with the seed cfg.seed + first sample."""
    seeds = []

    def fake(wd, cp, res, spp, seed, **kw):
        seeds.append((seed, spp))
        w, h = res
        return torch.zeros((w, h, 3)), 0, {"passes_full": 0, "drain_passes": ()}

    monkeypatch.setattr(common, "render_persistent", fake)
    monkeypatch.setattr(common, "CHUNK_WORK_ITEMS", 8 * 8 * 4)
    monkeypatch.setattr(common.image, "write_png", lambda img, path: None)
    cfg = common.RenderConfig(width=8, height=8, spp=10, seed=5, device="cpu")
    common.run_path_traced(stage4_scene(), Camera((8, 8)), cfg, "x.png")
    assert seeds == [(5, 4), (9, 4), (13, 2)]


@pytest.mark.parametrize("stage", ["s01_save_img", "s02_camera_and_ray",
                                   "s03_adding_a_sphere", "s04_objects",
                                   "s05_anti_aliasing"])
def test_deterministic_stage_png_matches_jax(stage, tmp_path, monkeypatch):
    import importlib

    size = ["--width", "40", "--height", "24", "--spp", "3"]
    t_out, j_out = tmp_path / "t.png", tmp_path / "j.png"
    importlib.import_module(f"{tstages.__name__}.{stage}").main(
        size + ["--device", "cpu", "--out", str(t_out)])
    monkeypatch.setattr(sys, "argv", [stage] + size + ["--out", str(j_out)])
    importlib.import_module(f"{jstages.__name__}.{stage}").main()
    t_png, j_png = read_png(str(t_out)), read_png(str(j_out))
    assert t_png.shape == j_png.shape == (40, 24, 3)
    assert np.abs(t_png - j_png).max() <= 1.0 / 255 + 1e-6


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import learn_path_tracing_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke, bench_torch
import learn_path_tracing_tpu_torch.__main__
for name in ("parallel.mesh", "parallel.launch", "parallel.dryrun", "viewer.serve",
             "accel.native"):
    assert pkg.__name__ + "." + name in sys.modules, name
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "learn_path_tracing_tpu"
       or k.startswith("learn_path_tracing_tpu.")]
assert not bad, bad
print("ok", len([k for k in sys.modules if k.startswith(pkg.__name__)]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_device_defaults_to_the_card(monkeypatch):
    """``RenderConfig`` and the stage CLIs default to ``cuda`` whether or not
    a card is present; without one, a run that does not ask for the CPU
    fails naming the missing CUDA device instead of rendering on the CPU."""
    assert RenderConfig().device == "cuda" and STAGE_CONFIGS["l14"].device == "cuda"
    checked = []
    monkeypatch.setattr(common, "require_device", checked.append)
    assert common.parse_args(STAGE_CONFIGS[10], argv=[]).device == "cuda"
    assert checked == ["cuda"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: common.parse_args(STAGE_CONFIGS[10], argv=[]),
                lambda: l14_mesh.main(["--world", "absent.world.npy"]),
                lambda: common.run_path_traced(stage4_scene(), Camera((8, 8)),
                                               RenderConfig(width=8, height=8, spp=1), "x.png")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert common.parse_args(STAGE_CONFIGS[10], argv=["--device", "cpu"]).device == "cpu"
