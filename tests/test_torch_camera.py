"""Port parity: camera ray generation of learn_path_tracing_tpu_torch against
the JAX package's, on the same cameras, pixel ids and samples.

Tolerance: every component within 4 ulps of the array's largest magnitude
(ulp(1) for directions, ulp(|position|) for origins). The two sides round
the same f32 operations, but XLA fuses the jitted JAX graph (multiply-add
contraction) and the f32 sin/cos/sqrt implementations differ by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu import camera as jcam
from learn_path_tracing_tpu.camera import camera as jcam_mod
from learn_path_tracing_tpu.models import stage10_camera as j_stage10_camera
from learn_path_tracing_tpu_torch import camera as tcam
from learn_path_tracing_tpu_torch.camera import camera as tcam_mod
from learn_path_tracing_tpu_torch.models import stage10_camera as t_stage10_camera

torch.set_num_threads(2)

RES = (40, 24)
ULPS = 4


def assert_ulps(got, want, ulps=ULPS):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    atol = ulps * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _setup(cls, kind):
    cams = []
    for mod in (jcam, tcam):
        if kind == "stage10":
            c = (j_stage10_camera if mod is jcam else t_stage10_camera)(RES)
        else:
            c = getattr(mod, cls)(RES, fov=50.0, focal_length=3.0, aperture=0.3)
            c.set_position((1.0, 0.5, 4.0))
            c.set_direction(20.0, -12.0, 7.0)
        cams.append(c)
    return cams


def _pixels_samples():
    r = np.random.default_rng(7)
    pix = r.integers(0, RES[0] * RES[1], size=2000)
    samp = r.integers(0, 64, size=2000)
    return pix, samp


@pytest.mark.parametrize("model", ["center", "jitter", "thinlens"])
@pytest.mark.parametrize("cls,kind", [("Camera", "stage10"), ("Camera", "posed"),
                                      ("LegacyCamera", "posed")])
def test_rays_match_jax(model, cls, kind):
    jc, tc = _setup(cls, kind)
    pix, samp = _pixels_samples()
    gen = jax.jit(lambda p, s: jcam_mod.generate_rays_for_pixels(
        jc.params(), RES, p, 3, s, model=model))
    want = gen(jnp.asarray(pix, jnp.uint32), jnp.asarray(samp, jnp.uint32))
    got = tcam_mod.generate_rays_for_pixels(
        tc.params(), RES, torch.as_tensor(pix), 3, torch.as_tensor(samp), model=model)
    assert_ulps(got.rd.numpy(), want.rd)
    assert_ulps(got.ro.numpy(), want.ro)
    np.testing.assert_array_equal(got.throughput.numpy(), np.asarray(want.throughput))
    assert got.alive.all()


def test_rotation_matrix_matches_jax():
    for ypr in ((0.0, 0.0, 0.0), (-102.99, -8.53, 0.0), (20.0, -12.0, 7.0)):
        want = jax.jit(jcam_mod.rotation_matrix)(*[jnp.float32(v) for v in ypr])
        got = tcam_mod.rotation_matrix(*[torch.tensor(v) for v in ypr])
        assert_ulps(got.numpy(), want, ulps=2)


def test_jitter_equals_degenerate_thinlens_bitwise():
    cam = tcam.Camera(RES, fov=45.0)
    cam.set_position((1.0, 2.0, 3.0))
    cam.set_direction(30.0, 10.0, 5.0)   # focal_length 1, aperture 0
    pix, samp = _pixels_samples()
    p, s = torch.as_tensor(pix), torch.as_tensor(samp)
    a = tcam_mod.generate_rays_for_pixels(cam.params(), RES, p, 9, s, model="jitter")
    b = tcam_mod.generate_rays_for_pixels(cam.params(), RES, p, 9, s, model="thinlens")
    assert torch.equal(a.ro, b.ro) and torch.equal(a.rd, b.rd)


def test_thinlens_focal_plane_converges():
    """Rays of one pixel through different lens points meet on the focal
    plane (the JAX package's tests/test_camera.py invariant)."""
    cam = tcam.Camera((9, 9), fov=60)
    cam.set_len(focal_length=5.0, aperture=0.4)
    r1 = cam.get_rays(seed=0, sample=0)
    cam.set_len(focal_length=5.0, aperture=0.0)
    r0 = cam.get_rays(seed=0, sample=0)
    # the pinhole ray reaches the focal plane (z = -5) at t = 5 / -rd.z
    p0 = r0.ro + (5.0 / -r0.rd[:, 2:3]) * r0.rd
    p1 = r1.ro + ((5.0 + r1.ro[:, 2:3]) / -r1.rd[:, 2:3]) * r1.rd
    assert torch.allclose(p0, p1, atol=1e-4)
    assert float(torch.abs(r1.ro).max()) > 0.0
