"""``scene.world.hit(backend='bvh')`` of the port (a walk of the sphere BVH
through kernel K3's plain twin on the CPU) against the JAX package's
``hit(backend='bvh')`` and against the port's own brute-force scan
(``backend='auto'``), on the seeded cover scene (``models.random_scene``).

Ray sets (made from numpy seeds and the port's plain CPU path): the
stage-10 camera's primaries, their first bounces (origins on the sphere
surfaces, where ``t_min`` and glass's far root matter), and random rays
through the scene; 1,024 each.

Tolerances, with their reasons:

- The port's ``World.device(use_bvh=True)`` tables against JAX's BVH packed
  by JAX's own collapse and packer: byte for byte (the same numpy
  operations in the same order; ``tests/test_torch_bvh.py`` pins the
  builders).
- Against JAX's lockstep XLA walk: hit/miss and ``obj`` equal on every ray
  (ties could differ: JAX keeps the first sphere found, the port the
  smaller index; measured 0 of 3,072 rays differ), the materials exactly.
  ``t`` is not held to 1e-5: XLA on the CPU contracts the leaf test's
  multiply-adds into FMAs and sums ``oc·rd`` and ``oc·oc`` in its own
  order, and the cancellation in ``half_b² - (oc·oc - r²)`` amplifies that.
  Off the ground, to 1e-4 relative with 1e-6 absolute (measured at most
  5.9e-5 relative, 3.2e-7 absolute at t = 1.2e-4); on the r = 10000 ground,
  where one ulp of ``oc·oc`` (~1e8) is 8, to 1e-2 of ``max(t, 1)``
  (measured at most 2.8e-3 of it). The port's own ``t`` is the f32
  transcription's bit for bit (below, and ``test_torch_sphere_scan.py``).
- Against the port's scan: ``t``, ``obj``, hit and every field bit for bit.
  The pair test is the same sequence of rounded operations, and both break
  ties to the smaller index. The one difference of rule, ``t > t_min`` in
  the walk against ``t >= t_min`` in the scan, shows only at ``t == t_min``
  exactly, which none of these rays meets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.accel.wide import collapse as j_collapse
from learn_path_tracing_tpu.models import random_scene as j_random_scene
from learn_path_tracing_tpu.ops import packet_traverse as jpt
from learn_path_tracing_tpu.scene import world as jworld
from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_modern
from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels
from learn_path_tracing_tpu_torch.core import rng
from learn_path_tracing_tpu_torch.core.types import Rays
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.scene import world as tworld

torch.set_num_threads(2)

SEED = 20230328
N_RAYS = 1024
T_RTOL, T_ATOL = 1e-4, 1e-6     # off the ground
GROUND_TOL = 1e-2                # on the ground, of max(t, 1)
FIELDS = ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity")


@pytest.fixture(scope="module")
def worlds():
    """The cover scene on both sides, each with its BVH."""
    return (random_scene(seed=SEED).device("cpu", use_bvh=True),
            j_random_scene(seed=SEED).device(use_bvh=True))


def _rays(ro, rd):
    ro, rd = torch.as_tensor(ro), torch.as_tensor(rd)
    n = ro.shape[0]
    return Rays(ro=ro, rd=rd, throughput=torch.ones((n, 3)),
                alive=torch.ones(n, dtype=torch.bool))


def _ray_sets(wd):
    """``{name: (ro, rd)}`` numpy f32 ray sets over the cover scene."""
    res = (64, 16)
    pixel = torch.arange(N_RAYS)
    prim = generate_rays_for_pixels(stage10_camera(res).params("cpu"), res, pixel, 0, 0)
    hits = tworld.hit(wd, prim)
    bounce = scatter_modern(prim, hits, rng.base(rng.stream(0, 0, 0, rng.STREAM_BSDF), pixel))
    r = np.random.default_rng(7)
    ro = r.uniform([-12, 0.05, -12], [12, 4, 12], size=(N_RAYS, 3)).astype(np.float32)
    rd = r.normal(size=(N_RAYS, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return {"primary": (prim.ro.numpy(), prim.rd.numpy()),
            "bounce1": (bounce.ro.numpy(), bounce.rd.numpy()),
            "random": (ro, rd)}


def test_bvh_tables_are_jax_bvh_byte_for_byte(worlds):
    twd, jwd = worlds
    n = len(random_scene(seed=SEED).spheres)
    want = jpt.pack_sphere_packet_tables(
        j_collapse(jwd.bvh), np.asarray(jwd.centers)[:n], np.asarray(jwd.radii)[:n],
        np.asarray(jwd.materials.transparency)[:n])
    for got, ref in zip(twd.bvh, want):
        ref = np.asarray(ref)
        assert got.numpy().dtype == ref.dtype and got.numpy().shape == ref.shape
        assert got.numpy().tobytes() == ref.tobytes()
    assert twd.bvh_stack == tpt.stack_cap(want[1])


@pytest.mark.parametrize("kind", ["primary", "bounce1", "random"])
def test_bvh_hit_matches_jax(worlds, kind):
    twd, jwd = worlds
    ro, rd = _ray_sets(twd)[kind]
    th = tworld.hit(twd, _rays(ro, rd), backend="bvh")
    jr = jworld.Rays(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                     throughput=jnp.ones((N_RAYS, 3)), alive=jnp.ones(N_RAYS, bool))
    jh = jworld.hit(jwd, jr, backend="bvh")
    hit = np.asarray(jh.hit)
    assert 0.2 < hit.mean() <= 1.0
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    same = th.obj.numpy() == np.asarray(jh.obj)
    assert same.all(), f"{int((~same).sum())} rays differ in obj"
    t, jt = th.t.numpy()[hit], np.asarray(jh.t)[hit]
    ground = np.asarray(jh.obj)[hit] == 0
    np.testing.assert_allclose(t[~ground], jt[~ground], rtol=T_RTOL, atol=T_ATOL)
    assert (np.abs(t - jt)[ground] <= GROUND_TOL * np.maximum(jt[ground], 1.0)).all()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(th.material, f).numpy()[same],
                                      np.asarray(getattr(jh.material, f))[same], err_msg=f)


@pytest.mark.parametrize("kind", ["primary", "bounce1", "random"])
def test_bvh_hit_is_the_scan_bit_for_bit(worlds, kind):
    twd, _ = worlds
    rays = _rays(*_ray_sets(twd)[kind])
    a = tworld.hit(twd, rays, backend="bvh")
    b = tworld.hit(twd, rays, backend="auto")
    assert bool(a.hit.any())
    for name in ("t", "point", "normal", "obj", "hit"):
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name
    for f in FIELDS:
        assert torch.equal(getattr(a.material, f), getattr(b.material, f)), f


def test_use_bvh_rebuilds_a_cached_world():
    """A world cached without the BVH is rebuilt with it when asked, as in
    the JAX package; one built with it serves both."""
    world = random_scene(seed=3)
    plain = world.device("cpu")
    assert plain.bvh is None and plain.bvh_stack == 0
    with_bvh = world.device("cpu", use_bvh=True)
    assert with_bvh is not plain and with_bvh.bvh is not None and with_bvh.bvh_stack > 0
    assert world.device("cpu") is with_bvh
    moved = with_bvh.to("cpu")
    assert all(torch.equal(x, y) for x, y in zip(moved.bvh, with_bvh.bvh))
    assert moved.bvh_stack == with_bvh.bvh_stack


def test_bvh_backend_through_the_wavefront_integrator():
    """``hit_backend='bvh'`` reaches ``hit`` from the wavefront integrator and
    the modular persistent engine: both render the scan's image bit for
    bit at 16x9, spp 2, limit 4."""
    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
    from learn_path_tracing_tpu_torch.integrator.wavefront import render

    res = (16, 9)
    wd = random_scene(seed=SEED).device("cpu", use_bvh=True)
    cp = stage10_camera(res).params("cpu")
    for fn in (render, render_persistent):
        img_bvh, segs_bvh = fn(wd, cp, res, spp=2, limit=4, hit_backend="bvh")[:2]
        img, segs = fn(wd, cp, res, spp=2, limit=4)[:2]
        assert segs_bvh == segs and torch.equal(img_bvh.view(torch.int32), img.view(torch.int32))
