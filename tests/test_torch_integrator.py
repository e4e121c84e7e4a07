"""The slice end to end: the port's persistent integrator on the stage-10
cover scene against the JAX package's, on the CPU at a small size.

Tolerances, with their reasons:

- First step (limit 1: camera, primary hits, sky): image to 1e-5 absolute
  and segments exactly equal. Only ulp-level camera differences remain, and
  a primary ray's sky radiance moves by that much.
- Full bounces (limit 8), against the JAX package's default CPU path: the
  schedule (pool, drain widths) exactly equal, and the images held to
  ``utils.checks.render_agreement`` (segments within 0.5 %, mean absolute
  difference at most 1 % of the mean, at least 80 % of pixels within 1e-4).
  Paths stay identical until a few-ulp difference flips a discrete event
  (the JAX CPU path also intersects with the ill-conditioned expanded
  quadratic), and a flipped sample moves its pixel by up to 1/spp.
- Port against port (wavefront vs persistent, run against rerun): segments
  exactly equal; images to 1e-6 (wavefront sums samples in f32, the
  persistent integrator in fixed point) or bitwise. ``render_accumulate``
  in two calls and ``render_chunked`` against ``render``: bit for bit (the
  same samples added in the same order); against the JAX package's
  ``render_accumulate``/``render_chunked``: ``render_agreement``.

Determinism: the persistent integrator accumulates in int64 fixed point, so
its image does not depend on the order of the scatter-adds, and two runs
are bit for bit equal (``test_runs_are_bitwise_identical``).
"""

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.integrator.persistent import render_persistent as j_render_persistent
from learn_path_tracing_tpu.models import random_scene as j_random_scene
from learn_path_tracing_tpu.models import stage10_camera as j_stage10_camera
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator import persistent
from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent, schedule
from learn_path_tracing_tpu_torch.integrator.wavefront import (render, render_accumulate,
                                                               render_chunked)
from learn_path_tracing_tpu_torch.models import random_scene, stage8_scene, stage10_camera
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES = (32, 18)
SEED = 20230328


def _both(limit, spp=4):
    j_img, j_segs, j_st = j_render_persistent(
        j_random_scene(seed=SEED).device(), j_stage10_camera(RES).params(), RES,
        spp=spp, limit=limit, stats=True)
    t_img, t_segs, t_st = render_persistent(
        random_scene(seed=SEED).device("cpu"), stage10_camera(RES).params("cpu"), RES,
        spp=spp, limit=limit, stats=True)
    return (np.asarray(j_img), float(j_segs), j_st), (t_img.numpy(), t_segs, t_st)


def test_slice_first_step_matches_jax():
    (j_img, j_segs, _), (t_img, t_segs, _) = _both(limit=1)
    assert t_img.shape == (32, 18, 3) and t_img.dtype == np.float32
    assert t_segs == j_segs == 32 * 18 * 4
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-5)


def test_slice_full_bounces_matches_jax():
    (j_img, j_segs, j_st), (t_img, t_segs, t_st) = _both(limit=8)
    assert t_st["pool"] == int(j_st["pool"]) == 576
    assert t_st["drain_widths"] == tuple(int(w) for w in j_st["drain_widths"]) == (256,)
    rep = render_agreement(t_img, j_img, t_segs, j_segs)
    assert rep["ok"], rep
    assert np.isfinite(t_img).all() and 0.2 < t_img.mean() < 0.8


def test_headline_schedule():
    """The auto policy at 1280x720, spp 64: pool, items and drain levels as
    the JAX package computes them."""
    s = schedule(1280 * 720, 64)
    assert (s.grouped, s.pool, s.items_per, s.drain_widths) == (
        True, 57344, 1029, (7168, 1024, 256))
    assert not schedule(28 * 20, 6).grouped


@pytest.mark.parametrize("spp", [4, 6])     # grouped (spp | n) and not
def test_persistent_matches_wavefront(spp):
    world = stage8_scene().device("cpu")
    cam = Camera((28, 20))
    cam.set_position((0, 0.4, 4))
    a_img, a_seg = render(world, cam.params(), (28, 20), spp=spp, limit=8, seed=11)
    b_img, b_seg = render_persistent(world, cam.params(), (28, 20), spp=spp, limit=8,
                                     seed=11)
    assert a_seg == b_seg
    np.testing.assert_allclose(a_img.numpy(), b_img.numpy(), rtol=0, atol=1e-6)


def test_halved_ragged_pool_matches_wavefront(monkeypatch):
    """A pool that does not divide n*spp: items_per is a ceiling and the
    overshoot items are masked invalid, as at the headline size (57,344
    lanes x 1029 items > 921,600 x 64). A small POOL_FLOOR reaches the
    halving policy at a CPU-test size: 600 → 300 → 150 → 152 lanes (a
    multiple of spp), 16 items each for 2,400 work items."""
    monkeypatch.setattr(persistent, "POOL_FLOOR", 100)
    res = (30, 20)
    world = stage8_scene().device("cpu")
    cam = Camera(res)
    cam.set_position((0, 0.4, 4))
    s = persistent.schedule(600, 4)
    assert (s.pool, s.items_per, s.pool * s.items_per) == (152, 16, 2432)
    a_img, a_seg = render(world, cam.params(), res, spp=4, limit=8, seed=11)
    b_img, b_seg, st = render_persistent(world, cam.params(), res, spp=4, limit=8,
                                         seed=11, stats=True)
    assert st["pool"] == 152
    assert a_seg == b_seg
    np.testing.assert_allclose(a_img.numpy(), b_img.numpy(), rtol=0, atol=1e-6)


def test_runs_are_bitwise_identical():
    wd = random_scene(seed=SEED).device("cpu")
    cp = stage10_camera(RES).params("cpu")
    a = render_persistent(wd, cp, RES, spp=4, limit=6, seed=3)
    b = render_persistent(wd, cp, RES, spp=4, limit=6, seed=3)
    assert a[1] == b[1] and torch.equal(a[0], b[0])


def test_engine_mega_renders():
    """``engine='mega'`` renders the modular engine's image (the mega
    engine's own tests are in test_torch_mega.py)."""
    wd = random_scene(seed=SEED).device("cpu")
    cp = stage10_camera(RES).params()
    img, segs, st = render_persistent(wd, cp, RES, spp=4, limit=6, seed=3, engine="mega",
                                      stats=True)
    ref_img, ref_segs = render_persistent(wd, cp, RES, spp=4, limit=6, seed=3)
    assert img.shape == (32, 18, 3) and segs == ref_segs and st["passes"] >= 6
    assert torch.equal(img, ref_img)


def test_unknown_engine_raises():
    wd = random_scene(seed=SEED).device("cpu")
    with pytest.raises(ValueError, match="engine"):
        render_persistent(wd, stage10_camera(RES).params(), RES, spp=4, engine="wavefront")


def test_render_accumulate_and_chunked_match_jax():
    from learn_path_tracing_tpu.integrator.wavefront import render_accumulate as j_accumulate
    from learn_path_tracing_tpu.integrator.wavefront import render_chunked as j_chunked

    import jax.numpy as jnp

    wd, cam = random_scene(seed=SEED).device("cpu"), stage10_camera(RES).params("cpu")
    n = RES[0] * RES[1]
    acc, segs_a = render_accumulate(wd, cam, torch.zeros((n, 3)), 0, RES, 2, limit=8)
    acc, segs_b = render_accumulate(wd, cam, acc, 2, RES, 2, limit=8)
    img, segs = render(wd, cam, RES, 4, limit=8)
    assert segs_a + segs_b == segs
    assert torch.equal((acc / 4).reshape(RES[0], RES[1], 3), img)
    c_img, c_segs = render_chunked(wd, cam, RES, 4, limit=8, chunk_spp=3)
    assert c_segs == segs and torch.equal(c_img, img)

    jwd, jcam = j_random_scene(seed=SEED).device(), j_stage10_camera(RES).params()
    j_acc, j_segs = j_accumulate(jwd, jcam, jnp.zeros((n, 3), jnp.float32), jnp.uint32(0), RES,
                                 4, limit=8)
    rep = render_agreement((acc / 4).reshape(RES[0], RES[1], 3).numpy(),
                           (np.asarray(j_acc) / 4).reshape(RES[0], RES[1], 3), segs,
                           float(j_segs))
    assert rep["ok"], rep
    jc_img, jc_segs = j_chunked(jwd, jcam, RES, 4, limit=8, chunk_spp=3)
    rep = render_agreement(c_img.numpy(), np.asarray(jc_img), c_segs, float(jc_segs))
    assert rep["ok"], rep


@pytest.mark.parametrize("fn", ["trace_sample_pixels", "render", "render_accumulate",
                                "render_chunked"])
def test_early_exit_false_is_the_same_bits(fn):
    """``early_exit=False`` runs every one of the ``limit`` passes and gives
    the bits of ``early_exit=True`` (JAX's ``tests/test_early_exit.py``), and
    both agree with JAX's ``early_exit=False`` by ``render_agreement``."""
    import jax.numpy as jnp

    from learn_path_tracing_tpu.camera import Camera as JCamera
    from learn_path_tracing_tpu.camera.camera import pixel_grid as j_pixel_grid
    from learn_path_tracing_tpu.integrator import wavefront as jwf
    from learn_path_tracing_tpu.models import stage8_scene as j_stage8_scene
    from learn_path_tracing_tpu_torch.camera.camera import pixel_grid
    from learn_path_tracing_tpu_torch.integrator import wavefront as twf

    res, n = (32, 20), 32 * 20
    cams = [cls(res) for cls in (Camera, JCamera)]
    for c in cams:
        c.set_position((0, 0.4, 4))
    wd, cam = stage8_scene().device("cpu"), cams[0].params("cpu")
    jwd, jcam = j_stage8_scene().device(), cams[1].params()
    calls = {
        "trace_sample_pixels": (lambda m, w, c, **kw: m.trace_sample_pixels(
            w, c, res, pixel_grid(res) if m is twf else j_pixel_grid(res), 3, 1, 16, **kw)),
        "render": lambda m, w, c, **kw: m.render(w, c, res, 2, limit=16, **kw),
        "render_accumulate": (lambda m, w, c, **kw: m.render_accumulate(
            w, c, torch.zeros((n, 3)) if m is twf else jnp.zeros((n, 3), jnp.float32), 0, res,
            2, limit=16, **kw)),
        "render_chunked": (lambda m, w, c, **kw: m.render_chunked(
            w, c, res, 3, limit=16, chunk_spp=2, **kw)),
    }
    call = calls[fn]
    (a, sa), (b, sb) = (call(twf, wd, cam, early_exit=e) for e in (True, False))
    assert torch.equal(a, b) and sa == sb
    j, sj = call(jwf, jwd, jcam, early_exit=False)
    rep = render_agreement(b.reshape(-1, 3).numpy(), np.asarray(j).reshape(-1, 3), sb,
                           float(sj))
    assert rep["ok"], rep


def test_render_config_has_jax_fields(monkeypatch, tmp_path):
    """``RenderConfig`` takes JAX's fields in JAX's order, with its
    defaults, and a preset's ``early_exit`` reaches the stage's wavefront
    render."""
    import dataclasses

    from learn_path_tracing_tpu.utils.config import RenderConfig as JRenderConfig
    from learn_path_tracing_tpu_torch.stages import l11_bvh
    from learn_path_tracing_tpu_torch.utils.config import RenderConfig

    jf = [(f.name, f.default) for f in dataclasses.fields(JRenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(RenderConfig)]
    assert tf[:len(jf)] == jf
    args = (64, 36, 8, 2, 6, 1e-3, 7, "legacy", "spheres", "pinhole", "bvh", False, "x.png")
    assert dataclasses.asdict(RenderConfig(*args)) == {
        **dataclasses.asdict(JRenderConfig(*args)), "device": "cuda", "packet_version": 2}

    seen = []
    real = l11_bvh.render

    def spy(*a, **kw):
        seen.append(kw["early_exit"])
        return real(*a, **kw)

    monkeypatch.setattr(l11_bvh, "render", spy)
    monkeypatch.setattr(l11_bvh, "FRAMES", 1)
    monkeypatch.setitem(l11_bvh.STAGE_CONFIGS, "l11",
                        l11_bvh.STAGE_CONFIGS["l11"].with_(early_exit=False))
    l11_bvh.main(["--device", "cpu", "--width", "8", "--height", "6", "--spp", "1",
                  "--limit", "2", "--out", str(tmp_path / "l11.png")])
    assert seen == [False]
