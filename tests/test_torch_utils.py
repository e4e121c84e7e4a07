"""The port's utilities against the JAX package's: ``utils.checks``
(``validate_image``, ``device_smoke_test``, ``checked_trace``),
``utils.profiling`` (``RayStats``, ``timed``, ``trace``),
``utils.benchlib.time_fn`` and ``accel.debug``.

Tolerances, with their reasons:

- Strings, error messages and tree statistics: equal (the same Python and
  numpy operations on the same arrays; the port's SAH build is the JAX
  package's byte for byte, ``tests/test_torch_bvh.py``).
- The AABB mask and the BVH heatmap: equal on at least 99.9 % of pixels.
  Both are slab tests of primary rays through pixel centres; a ray that
  grazes a box edge can fall on either side of it by the few ulps that the
  two implementations' ray directions differ.
"""

import json
import re

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.accel import debug as jdebug
from learn_path_tracing_tpu.accel.bvh import build_bvh as j_build_bvh
from learn_path_tracing_tpu.camera import Camera as JCamera
from learn_path_tracing_tpu.utils import checks as jchecks
from learn_path_tracing_tpu.utils.profiling import RayStats as JRayStats
from learn_path_tracing_tpu_torch.accel import debug
from learn_path_tracing_tpu_torch.accel.bvh import build_bvh
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.camera.camera import generate_rays
from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.utils import benchlib, checks, profiling

torch.set_num_threads(2)

AGREE_MIN = 0.999


@pytest.mark.parametrize("img", [np.array([[np.nan, 0, 0]], np.float32),
                                 np.array([[0, 1, 0], [0, np.inf, 0]], np.float32),
                                 np.array([[-0.1, 0, 0]], np.float32)])
def test_validate_image_raises_jax_errors(img):
    with pytest.raises(FloatingPointError) as jerr:
        jchecks.validate_image(img, "frame")
    for arg in (img, torch.as_tensor(img)):
        with pytest.raises(FloatingPointError, match=re.escape(str(jerr.value))):
            checks.validate_image(arg, "frame")
    checks.validate_image(np.ones((4, 4, 3), np.float32))


def test_device_smoke_test(monkeypatch):
    assert checks.device_smoke_test("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checks.device_smoke_test()


def test_checked_trace_raises_on_a_masked_nan():
    def masked(x):
        y = torch.sqrt(x - 2.0)                   # NaN for x < 2
        return torch.where(torch.isnan(y), torch.zeros_like(y), y)

    x = torch.ones(8)
    assert torch.equal(masked(x), torch.zeros(8))
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        checks.checked_trace(masked, x)


def test_checked_trace_passes_infinities_and_carried_nans():
    x = torch.tensor([0.0, -0.0, 2.0])
    assert torch.equal(checks.checked_trace(lambda v: 1.0 / v, x),
                       torch.tensor([float("inf"), float("-inf"), 0.5]))
    assert torch.equal(checks.checked_trace(lambda v: 1.0 / torch.clamp_min(v, 1e-9), x),
                       1.0 / torch.clamp_min(x, 1e-9))
    nan = torch.tensor([float("nan"), 1.0])
    assert torch.isnan(checks.checked_trace(lambda v: v * 2.0, nan)[0])
    # uninitialised buffers (which may hold NaN bits) are not a fault
    checks.checked_trace(lambda: torch.empty(1024).fill_(1.0))


def test_checked_trace_returns_what_fn_returns():
    """Camera rays make no NaN, so the trace returns the call's result."""
    cam = stage10_camera((16, 9)).params("cpu")
    rays = checks.checked_trace(generate_rays, cam, (16, 9), 3, 1)
    ref = generate_rays(cam, (16, 9), 3, 1)
    assert torch.equal(rays.ro, ref.ro) and torch.equal(rays.rd, ref.rd)


def test_checked_trace_passes_a_cover_scene_render():
    """A CPU render of the cover scene makes no NaN (the plain sphere scan
    clamps its discriminant before the ``sqrt``, as JAX's CPU path does), so
    the trace passes and returns the untraced render bit for bit."""
    wd = random_scene(seed=20230328).device("cpu")
    cam = stage10_camera((16, 9)).params("cpu")
    ref, ref_segs = render_persistent(wd, cam, (16, 9), spp=2, limit=8)
    img, segs = checks.checked_trace(render_persistent, wd, cam, (16, 9), spp=2, limit=8)
    assert segs == ref_segs and torch.equal(img, ref)


def test_ray_stats_report_equals_jax():
    kw = [dict(label="x", seconds=2.0, segments=4e6, pixels=1000, spp=4),
          dict(label="y", seconds=0.123456, segments=1234567, pixels=36, spp=7)]
    mine, ref = profiling.RayStats(), JRayStats()
    for k in kw:
        mine.add(**k)
        ref.add(**k)
    assert mine.report() == ref.report()
    assert json.loads(mine.report().splitlines()[0])["mrays_per_sec"] == 2.0


def test_timed_and_trace(tmp_path, capsys):
    with profiling.timed("block", segments=lambda: 1e6):
        torch.ones(16).sum()
    assert re.match(r"\[block\] \d+\.\d{3}s  1\.000e\+06 segments", capsys.readouterr().out)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert prof.events() and json.loads((tmp_path / "trace" / "trace.json").read_text())


def test_time_fn_times_each_run():
    calls = []
    seconds, out = benchlib.time_fn(lambda a: calls.append(a) or a * 2, 21, iters=3,
                                    warmup=2, device="cpu")
    assert out == 42 and calls == [21] * 5
    assert len(seconds) == 3 and all(s >= 0 for s in seconds)


def _seeded_bvhs(n=48, seed=5):
    r = np.random.default_rng(seed)
    centers = (r.random((n, 3)) * 10).astype(np.float32)
    radii = r.uniform(0.1, 0.6, (n, 1)).astype(np.float32)
    args = (centers - radii, centers + radii)
    return (build_bvh(*args, centroid=centers, max_depth=8, max_leaf=4),
            j_build_bvh(*args, centroid=centers, max_depth=8, max_leaf=4))


def test_tree_dump_and_stats_equal_jax():
    bvh, jbvh = _seeded_bvhs()
    assert debug.format_tree(bvh) == jdebug.format_tree(jbvh)
    assert debug.format_tree(bvh, max_lines=5) == jdebug.format_tree(jbvh, max_lines=5)
    assert debug.tree_stats(bvh) == jdebug.tree_stats(jbvh)


def _cams(res, pos, target):
    out = []
    for cls in (Camera, JCamera):
        cam = cls(res)
        cam.set_position(pos)
        cam.look_at(target)
        out.append(cam.params())
    return out


def test_aabb_mask_agrees_with_jax():
    res = (64, 48)
    cam, jcam = _cams(res, (0.0, 0.0, 5.0), (0.0, 0.0, 0.0))
    box = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    mask, jmask = debug.render_aabb_mask(*box, cam, res), jdebug.render_aabb_mask(*box, jcam, res)
    assert mask.shape == jmask.shape == res and mask.dtype == bool
    assert mask[32, 24] and not mask[0, :].any() and 0 < mask.sum() < mask.size
    assert (mask == jmask).mean() >= AGREE_MIN


def test_bvh_heatmap_agrees_with_jax():
    bvh, jbvh = _seeded_bvhs()
    res = (48, 36)
    cam, jcam = _cams(res, (5.0, 5.0, 25.0), (5.0, 5.0, 5.0))
    heat, jheat = debug.render_bvh_heatmap(bvh, cam, res), jdebug.render_bvh_heatmap(jbvh, jcam,
                                                                                     res)
    assert heat.shape == jheat.shape == res and heat.max() >= 1
    assert heat.max() <= bvh.data.shape[0]
    assert (heat == jheat).mean() >= AGREE_MIN
