"""The frozen generators give the configurations' digests, and the arrays
of the generators they were copied from."""

import numpy as np
import pytest

from benchmark.harness import registry


@pytest.mark.parametrize("name", ["rtiow_cover", "standin_mesh", "standin_flagship_4card"])
def test_config_digest(name):
    cfg = registry.config(name)
    mod = registry.module("scenes", cfg["scene"])
    assert mod.digest(mod.generate(cfg)) == cfg["digest"]


def test_cover_scene_is_the_ports():
    from learn_path_tracing_tpu_torch.models import random_scene

    cfg = registry.config("rtiow_cover")
    arrays = registry.module("scenes", "rtiow").generate(cfg)
    wd = random_scene(seed=cfg["scene_seed"]).device("cpu")
    n = arrays["radius"].shape[0]
    assert n == 485
    assert np.array_equal(wd.centers.numpy()[:n], arrays["center"])
    assert np.array_equal(wd.radii.numpy()[:n], arrays["radius"])
    for k in ("albedo", "roughness", "metallic", "ior", "transparency"):
        assert np.array_equal(getattr(wd.materials, k).numpy()[:n], arrays[k])


def test_standin_writes_what_the_port_reads(tmp_path):
    from PIL import Image

    from learn_path_tracing_tpu_torch.io.exr import read_exr

    from benchmark.scenes import standin

    cfg = {"world": {"level": 1, "seed": 3, "tex_size": 32, "env_size": [16, 8]}}
    arrays = standin.generate(cfg)
    base, exr = standin.write_assets(arrays, str(tmp_path))
    assert np.array_equal(np.asarray(Image.open(base + "_roughness.png")), arrays["roughness"])
    assert np.array_equal(read_exr(exr), arrays["env"].astype(np.float16).astype(np.float32))


def test_standin_mesh_is_chip_smokes():
    import chip_smoke

    from benchmark.scenes import standin

    arrays = standin.generate({"world": {"level": 2, "seed": 5, "tex_size": 32,
                                         "env_size": [16, 8]}})
    mesh = chip_smoke._standin_mesh(2, 5)
    for k, v in (("positions", mesh.positions), ("normals", mesh.normals), ("uvs", mesh.uvs),
                 ("faces", mesh.face_p)):
        assert np.array_equal(arrays[k], v)
