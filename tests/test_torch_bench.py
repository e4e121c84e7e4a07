"""The port's benchmark (``bench_torch.py``) and CLI
(``python -m learn_path_tracing_tpu_torch``) on the CPU at 32x18, spp 4,
limit 8, against the JAX package's renders and CLI.

Tolerances, with their reasons:

- The modular and mega cells: segments equal and images bit for bit (both
  deposit every sample into the same int64 fixed-point accumulator).
- Cells against the JAX package's ``render_persistent`` (the cover scene)
  and ``render_hybrid`` (``tests/test_hybrid.py``'s mini-world saved as a
  ``.world.npy``): ``utils.checks.render_agreement`` (segments within
  0.5 %, mean absolute difference at most 1 % of the mean, at least 80 %
  of pixels within 1e-4): a few ulps between the two implementations flip
  a few discrete events a render.
- Metric names, the stage list and exit codes: equal.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import bench_torch
import learn_path_tracing_tpu.__main__ as jcli
from learn_path_tracing_tpu.camera import LegacyCamera as JLegacyCamera
from learn_path_tracing_tpu.integrator.hybrid import render_hybrid as j_render_hybrid
from learn_path_tracing_tpu.integrator.persistent import render_persistent as j_render_persistent
from learn_path_tracing_tpu.models import random_scene as j_random_scene
from learn_path_tracing_tpu.models import stage10_camera as j_stage10_camera
from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld as JLegacyWorld
from learn_path_tracing_tpu_torch import __main__ as cli
from learn_path_tracing_tpu_torch.core.image import read_png
from learn_path_tracing_tpu_torch.io.obj import MeshData
from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES, SPP, LIMIT = (32, 18), 4, 8
CELL = dict(resolution=RES, spp=SPP, limit=LIMIT, device="cpu")
SMALL = ["--width", "32", "--height", "18", "--spp", "4", "--limit", "8", "--device", "cpu"]


@pytest.fixture(scope="module")
def cover_cells():
    return {engine: bench_torch.run_cell(engine=engine, **CELL)
            for engine in ("persistent", "mega")}


def test_modular_and_mega_cells_agree_bitwise(cover_cells):
    mod, mega = cover_cells["persistent"], cover_cells["mega"]
    assert mod["metric"] == "mrays_per_sec_chip_10final"
    assert mega["metric"] == "mrays_per_sec_chip_10final_mega"
    assert mod["segments"] == mega["segments"] > RES[0] * RES[1] * SPP
    assert torch.equal(mod["image"].view(torch.int32), mega["image"].view(torch.int32))
    for row in (mod, mega):
        assert row["unit"] == "Mrays/s" and row["card"] == "cpu" and len(row["frames"]) == 3
        line = json.loads(bench_torch.row_line(row))
        assert set(line) == set(bench_torch.ROW_KEYS)
        assert line["value"] == pytest.approx(row["segments"] / np.median(row["frames"]) / 1e6)
    # the warm-up at spp 1, then three frames
    assert len(mod["calls"]) == len(mega["calls"]) == 4


def test_cover_cell_against_jax(cover_cells):
    row = cover_cells["persistent"]
    img, segs = j_render_persistent(j_random_scene(seed=bench_torch.SCENE_SEED).device(),
                                    j_stage10_camera(RES).params(), RES, spp=SPP, limit=LIMIT,
                                    seed=0)
    rep = render_agreement(row["image"].numpy(), np.asarray(img), row["segments"], float(segs))
    assert rep["ok"], rep


def _mini_world(world_cls, mesh_cls):
    """``tests/test_hybrid.py``'s mini-world: a quad floor and a sphere
    under the sky-gradient environment."""
    world = world_cls()
    world.add_mesh(mesh_cls(
        positions=np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
        normals=np.array([[0, 1, 0]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.zeros((2, 3), np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.zeros(2, np.int32)))
    world.add_sphere((0, 1, 0), 0.8, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    return world


def test_mesh_cell_against_jax(tmp_path):
    path = str(tmp_path / "mini.world.npy")
    world = _mini_world(LegacyWorld, MeshData)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    world.save(path)
    row = bench_torch.run_cell(scene="yoimiya", world=path, **CELL)
    assert row["metric"] == "bvh_mrays_per_sec_chip_mini" and row["engine"] == "hybrid"

    cam = JLegacyCamera(RES)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jwd = JLegacyWorld().load(path)
    img, segs = j_render_hybrid(jwd, cam.params(), RES, spp=SPP, limit=LIMIT, seed=0,
                                bsdf="legacy", camera_model="jitter", scene="legacy")
    rep = render_agreement(row["image"].numpy(), np.asarray(img), row["segments"], float(segs))
    assert rep["ok"], rep


@pytest.mark.parametrize("kind,scene,world,res,spp,mega,name", [
    ("rate", "10_final", bench_torch.DEFAULT_WORLD, (1280, 720), 64, False,
     "mrays_per_sec_chip_10final"),
    ("rate", "yoimiya", bench_torch.DEFAULT_WORLD, (1280, 720), 64, False,
     "bvh_mrays_per_sec_chip_yoimiya"),
    ("rate", "yoimiya", "/x/standin.world.npy", (1280, 720), 64, False,
     "bvh_mrays_per_sec_chip_standin"),
    ("sweep", "10_final", bench_torch.DEFAULT_WORLD, (2560, 1440), 64, True,
     "mrays_per_sec_chip_10final_2560x1440_spp64_mega"),
    ("time1024", "10_final", bench_torch.DEFAULT_WORLD, (1920, 1080), 1024, True,
     "seconds_to_1024spp_1080p_10_final_mega"),
    ("flagship", "yoimiya", bench_torch.DEFAULT_WORLD, (3000, 2000), 32, False,
     "seconds_flagship_3000x2000_spp32_yoimiya"),
    ("flagship", "yoimiya", "Other.world.npy", (3000, 2000), 32, False,
     "seconds_flagship_3000x2000_spp32_Other"),
])
def test_metric_names(kind, scene, world, res, spp, mega, name):
    assert bench_torch.metric_name(kind, scene, world, res, spp, mega) == name


def test_missing_world_exits_2(tmp_path, capsys):
    missing = str(tmp_path / "absent.world.npy")
    for extra in (["--scene", "yoimiya"], ["--flagship"]):
        assert bench_torch.main(extra + ["--world", missing, "--device", "cpu"]) == 2
        out = capsys.readouterr()
        assert out.out == "" and missing in out.err


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--width", "8", "--height", "8", "--spp", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["smoke"])


def test_cli_bench_prints_a_row(capsys):
    assert cli.main(["bench"] + SMALL + ["--engine", "mega"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "mrays_per_sec_chip_10final_mega" and row["card"] == "cpu"


def test_cli_stages_lists_jax_keys(capsys):
    assert cli.STAGES.keys() == jcli.STAGES.keys()
    assert cli.main(["stages"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(jcli.STAGES)
    assert all(ln.split()[1].startswith("learn_path_tracing_tpu_torch.stages.") for ln in lines)


def test_cli_render_writes_the_stage_image(tmp_path):
    out = tmp_path / "s1.png"
    assert cli.main(["render", "--stage", "1", "--device", "cpu", "--width", "20",
                     "--height", "10", "--out", str(out)]) == 0
    png = read_png(str(out))
    assert png.shape == (20, 10, 3) and png[:, :, 2].max() == 0.0 and png[-1, 0, 0] > 0.9


@pytest.mark.parametrize("argv", [["render", "--stage", "99"], ["render", "l16"], ["render"],
                                  ["frobnicate"]])
def test_cli_rejects_unknown_input(argv, capsys):
    assert cli.main(argv) == jcli.main(list(argv)) == 2
