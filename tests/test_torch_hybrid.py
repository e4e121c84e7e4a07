"""The mesh slice end to end: the port's hybrid integrator
(``integrator.hybrid.render_hybrid``) against its own wavefront and
persistent integrators and against the JAX package's ``render_hybrid``, on
the CPU at a small size.

Tolerances, with their reasons:

- Port against port: segments exactly equal; the image bit for bit equal to
  ``render_persistent``'s (both deposit every sample's radiance into the
  same int64 fixed-point accumulator, so the order of the adds does not
  matter) and within 1e-6 of ``wavefront.render``'s (it sums samples in
  f32). Any ``chunk_spp``/``cap``/``pool_w`` (the make-room branch
  included) gives the same bits; so do two runs, and the int64
  accumulators of two ``sample_base`` halves sum exactly to the one-shot
  render's (their f32 images average to it within 5e-7).
- Against the JAX package's ``render_hybrid`` (its default CPU path, which
  intersects triangles with another formula, ``accel/traverse.py:151``):
  ``utils.checks.render_agreement`` (segments within 0.5 %, mean absolute
  difference at most 1 % of the mean, at least 80 % of pixels within
  1e-4). A few ulps flip a few discrete events per render.
"""

import warnings

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.camera import Camera as JCamera
from learn_path_tracing_tpu.integrator.hybrid import render_hybrid as j_render_hybrid
from learn_path_tracing_tpu.io.obj import MeshData as JMeshData
from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld as JLegacyWorld
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
from learn_path_tracing_tpu_torch.integrator.wavefront import render
from learn_path_tracing_tpu_torch.io.obj import MeshData
from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES = (28, 20)


def _mini_world(world_cls, mesh_cls):
    """The JAX package's tests/test_hybrid.py mini-world: a quad floor and a
    sphere under the sky-gradient environment."""
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
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return world.build()


def _cam(cls=Camera):
    cam = cls(RES)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    return cam


@pytest.fixture(scope="module")
def wd():
    return _mini_world(LegacyWorld, MeshData)


def _hybrid(wd, spp=4, limit=8, seed=3, **kw):
    return render_hybrid(wd, _cam().params(), RES, spp=spp, limit=limit, seed=seed,
                         camera_model="thinlens", stats=True, **kw)


def test_hybrid_equals_persistent_and_wavefront(wd):
    img, segs, st = _hybrid(wd)
    p_img, p_segs = render_persistent(wd, _cam().params(), RES, spp=4, limit=8, seed=3,
                                      bsdf="legacy", scene="legacy", camera_model="thinlens")
    w_img, w_segs = render(wd, _cam().params(), RES, spp=4, limit=8, seed=3,
                           bsdf="legacy", scene="legacy", camera_model="thinlens")
    assert segs == p_segs == w_segs
    assert torch.equal(img, p_img)
    np.testing.assert_allclose(img.numpy(), w_img.numpy(), rtol=0, atol=1e-6)
    assert img.shape == (28, 20, 3) and st["passes"] > 0 and st["primary_hits"] > 0


@pytest.mark.parametrize("kw", [dict(chunk_spp=1), dict(chunk_spp=2, drain_ratio=4),
                                dict(chunk_spp=1, cap=256, pool_w=256),
                                dict(chunk_spp=4, cap=256, pool_w=512)])
def test_pool_geometry_does_not_change_the_image(wd, kw):
    """chunk_spp, cap, pool width and drain ratio are scheduling choices: the
    same bits and segments, including a cap below the survivor count
    (several batches) and pools that must make room."""
    base_img, base_segs, _ = _hybrid(wd)
    img, segs, st = _hybrid(wd, **kw)
    assert segs == base_segs
    assert torch.equal(img, base_img)
    if kw.get("pool_w") == 256:
        assert st["passes_chunkphase"] > 0          # the make-room branch ran


def test_two_runs_bit_identical_and_limit_one(wd):
    a = _hybrid(wd, seed=5)
    b = _hybrid(wd, seed=5)
    assert a[1] == b[1] and torch.equal(a[0], b[0])
    img, segs, st = _hybrid(wd, spp=2, limit=1, seed=1)
    w_img, w_segs = render(wd, _cam().params(), RES, spp=2, limit=1, seed=1, bsdf="legacy",
                           scene="legacy", camera_model="thinlens")
    assert segs == w_segs == RES[0] * RES[1] * 2 and st["passes"] == 0
    np.testing.assert_allclose(img.numpy(), w_img.numpy(), rtol=0, atol=1e-6)


def test_sample_base_accumulates_exactly(wd):
    """Two sample_base-offset halves sum to the one-shot render's int64
    accumulator exactly (the same RNG counters per absolute sample), and
    their images average to its image within f32 rounding."""
    from learn_path_tracing_tpu_torch.integrator.hybrid import _hybrid_core

    cam = _cam().params()

    def core(spp, base):
        return _hybrid_core(wd, cam, RES, RES[0] * RES[1], 0, base, spp, 6, 9, "legacy",
                            "thinlens", 0, 0, 0, 2)

    full, fsegs, _ = core(4, 0)
    a, sa, _ = core(2, 0)
    b, sb, _ = core(2, 2)
    assert sa + sb == fsegs and torch.equal(a + b, full)
    halves = [_hybrid(wd, spp=2, limit=6, seed=9, sample_base=k)[0] for k in (0, 2)]
    one, _, _ = _hybrid(wd, spp=4, limit=6, seed=9)
    np.testing.assert_allclose(((halves[0] + halves[1]) / 2).numpy(), one.numpy(),
                               rtol=0, atol=5e-7)


def test_hybrid_matches_jax_render_hybrid(wd):
    jwd = _mini_world(JLegacyWorld, JMeshData)
    j_img, j_segs = j_render_hybrid(jwd, _cam(JCamera).params(), RES, spp=4, limit=8, seed=3,
                                    bsdf="legacy", scene="legacy", camera_model="thinlens")
    img, segs, _ = _hybrid(wd)
    rep = render_agreement(img.numpy(), np.asarray(j_img), segs, float(j_segs))
    print(rep)
    assert rep["ok"], rep


def test_scene_must_be_legacy(wd):
    with pytest.raises(ValueError, match="legacy"):
        render_hybrid(wd, _cam().params(), RES, spp=1, scene="spheres")
    with pytest.raises(ValueError, match="divide"):
        render_hybrid(wd, _cam().params(), RES, spp=3, chunk_spp=2)
