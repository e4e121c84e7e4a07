"""Port parity: scenes, state conversion, color pipeline and PNG I/O of
learn_path_tracing_tpu_torch against the JAX package.

Tolerances: scene tables and converted state are equal array for array (the
same Python builders, the same float32 values); ACES/gamma to 2e-6 absolute
(both evaluate the same f32 formulas; the 3x3 matrix products may sum in
another order and pow differs by an ulp); PNG rasters byte for byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu import models as jmodels
from learn_path_tracing_tpu.core import color as jcolor
from learn_path_tracing_tpu.core import image as jimage
from learn_path_tracing_tpu_torch import convert
from learn_path_tracing_tpu_torch import models as tmodels
from learn_path_tracing_tpu_torch.core import color as tcolor
from learn_path_tracing_tpu_torch.core import image as timage

torch.set_num_threads(2)

FIELDS = ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity")


def _jax_leaves(wd):
    m = wd.materials
    return ([np.asarray(wd.centers), np.asarray(wd.radii)]
            + [np.asarray(getattr(m, f)) for f in FIELDS])


def _port_leaves(wd):
    m = wd.materials
    return ([wd.centers.numpy(), wd.radii.numpy()]
            + [getattr(m, f).numpy() for f in FIELDS])


@pytest.mark.parametrize("name", ["stage3_scene", "stage4_scene", "stage6_scene",
                                  "stage7_scene", "stage8_scene", "random_scene"])
def test_scene_tables_equal_jax(name):
    kw = {"seed": 20230328} if name == "random_scene" else {}
    jw = getattr(jmodels, name)(**kw)
    tw = getattr(tmodels, name)(**kw)
    assert tw.size == jw.size
    for got, want in zip(_port_leaves(tw.device("cpu")), _jax_leaves(jw.device())):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_materials_gather_matches_jax():
    """``Materials.gather`` with ``jnp.take``'s rule: in-range, negative
    (from the end) and out-of-range (NaN) indices."""
    jm = jmodels.random_scene(seed=20230328).device().materials
    tm = tmodels.random_scene(seed=20230328).device("cpu").materials
    idx = np.random.default_rng(3).integers(-600, 600, size=300).astype(np.int32)
    jg, tg = jm.gather(jnp.asarray(idx)), tm.gather(torch.as_tensor(idx))
    assert type(tg) is type(tm)
    for f in FIELDS:
        got, want = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert got.shape == want.shape and np.isnan(want).any()
        np.testing.assert_array_equal(got, want)


def test_cover_scene_shape():
    wd = tmodels.random_scene(seed=20230328).device("cpu")
    assert tmodels.random_scene(seed=20230328).size == 485
    assert wd.centers.shape == (512, 3)            # padded to a multiple of 128
    assert wd.scan_table.shape == (512, 8) and wd.scan_attrs.shape == (512, 16)
    assert torch.isinf(wd.scan_table[485:, 3]).all()   # padding never hits


def test_world_from_numpy_equals_port_scene():
    jwd = jmodels.random_scene(seed=20230328).device()
    wd = convert.world_from_numpy(*_jax_leaves(jwd))
    ref = tmodels.random_scene(seed=20230328).device("cpu")
    for got, want in zip(_port_leaves(wd), _port_leaves(ref)):
        np.testing.assert_array_equal(got, want)
    assert torch.equal(wd.scan_table, ref.scan_table)
    assert torch.equal(wd.scan_attrs, ref.scan_attrs)


def test_camera_from_numpy_equals_port_camera():
    jcp = jmodels.stage10_camera((64, 36)).params()
    cp = convert.camera_from_numpy(
        *(np.asarray(getattr(jcp, f)) for f in (
            "position", "yaw", "pitch", "roll", "fov", "focal_length", "aperture",
            "fov_scale")))
    ref = tmodels.stage10_camera((64, 36)).params()
    for f in ("position", "yaw", "pitch", "roll", "fov", "focal_length", "aperture",
              "fov_scale"):
        assert torch.equal(getattr(cp, f), getattr(ref, f)), f


@pytest.mark.parametrize("fn", ["aces_tonemap", "gamma_correct", "post_process"])
def test_color_matches_jax(fn):
    c = np.random.default_rng(0).uniform(0, 4, size=(500, 3)).astype(np.float32)
    c[:5] = 0.0
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(c)))
    got = getattr(tcolor, fn)(torch.as_tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_png_raster_and_roundtrip_match_jax(tmp_path):
    img = np.random.default_rng(1).uniform(-0.1, 1.1, size=(7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.to_raster(torch.as_tensor(img)),
                                  jimage.to_raster(img))
    p = str(tmp_path / "x.png")
    timage.write_png(torch.as_tensor(img), p)
    np.testing.assert_array_equal(timage.read_png(p), jimage.read_png(p))
