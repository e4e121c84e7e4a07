"""Kernel K1 (the sphere scan) and ``scene.world.hit`` of the port against
the JAX package.

Tolerances, with their reasons:

- The plain twin against an op-by-op float32 numpy transcription of the
  kernel's arithmetic (each operation IEEE-rounded, correctly rounded sqrt,
  first index wins): bit for bit in ``t``, ``idx`` and ``attr``. The CUDA
  kernel performs the same rounded operations, and ``tests/test_torch_gpu.py``
  (a card only) holds it to the twin bit for bit.
- The plain twin against the Pallas kernel in interpret mode (the way
  ``tests/test_sphere.py`` runs it on the CPU): hit/miss, ``idx`` and the
  gathered ``attr`` equal on inputs without ties; ``t`` to a relative 5e-4.
  Not to 1 ulp: XLA on the CPU contracts the kernel's multiply-adds into
  FMAs and its f32 sqrt is not correctly rounded, and near-grazing pairs
  amplify that through the cancellation in ``half_b² - c0`` (measured up to
  1.6e-4 relative).
- The kernel's split of the table over warp teams (``_sliced_scan``, on the
  plain twin) against the serial scan: bit for bit, ties included; the
  lexicographic least of the slices' ``(t, idx)`` is the serial rule's
  winner.
- ``world.hit`` against the JAX package's Pallas path: as above for
  ``t``/``obj``/materials; the point to 1e-3 absolute, which that ``t``
  difference moves it by, and the normal to 1e-2, that over the smallest
  radius (0.2) with a factor 2 of margin.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import learn_path_tracing_tpu.ops.sphere_scan as jss
from learn_path_tracing_tpu.geometry.sphere import intersect_spheres as j_intersect
from learn_path_tracing_tpu.models import random_scene as j_random_scene
from learn_path_tracing_tpu.scene import world as jworld
from learn_path_tracing_tpu_torch.geometry.sphere import intersect_spheres as t_intersect
from learn_path_tracing_tpu_torch.models import random_scene as t_random_scene
from learn_path_tracing_tpu_torch.ops import sphere_scan as tss
from learn_path_tracing_tpu_torch.scene import world as tworld
from learn_path_tracing_tpu_torch.core.types import Rays

torch.set_num_threads(2)

T_MIN = 1e-4
T_RTOL = 5e-4


def random_setup(seed, n=700, s=150):
    r = np.random.default_rng(seed)
    ro = (r.normal(size=(n, 3)) * 2).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    centers = (r.normal(size=(s, 3)) * 3).astype(np.float32)
    radii = r.uniform(0.2, 1.5, size=s).astype(np.float32)
    radii[::17] = 0.0                                   # padding rows
    transparency = (r.uniform(size=s) < 0.3).astype(np.float32)
    attrs = r.normal(size=(s, 16)).astype(np.float32)
    return ro, rd, centers, radii, transparency, attrs


def oracle_f32(ro, rd, centers, radii, transparency, t_min=T_MIN):
    """The kernel's arithmetic transcribed op by op in float32 numpy."""
    f = np.float32
    r2 = np.where(radii > 0, radii * radii, f(-np.inf)).astype(f)
    oc = [ro[:, None, d] - centers[None, :, d] for d in range(3)]
    half_b = -((oc[0] * rd[:, None, 0] + oc[1] * rd[:, None, 1]) + oc[2] * rd[:, None, 2])
    c0 = ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]) - r2[None, :]
    disc = half_b * half_b - c0
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(disc)
        t_near = half_b - sq
        use_far = (t_near < f(t_min)) & (transparency[None, :] > 0) & (radii[None, :] > 0)
        t = np.where(use_far, half_b + sq, t_near)
        t = np.where(t >= f(t_min), t, f(np.inf)).astype(f)
    idx = np.argmin(t, axis=1)          # first index of the minimum
    t_best = t[np.arange(len(t)), idx]
    idx = np.where(np.isfinite(t_best), idx, 0)
    return t_best, idx.astype(np.int32)


def port_scan(ro, rd, centers, radii, transparency, attrs):
    c, r, tr = map(torch.as_tensor, (centers, radii, transparency))
    t, idx, attr = tss.intersect_spheres_scan(
        torch.as_tensor(ro), torch.as_tensor(rd), tss.pack_spheres(c, r, tr),
        torch.as_tensor(attrs))
    return t.numpy(), idx.numpy(), attr.numpy()


def pallas_scan(ro, rd, centers, radii, transparency, attrs):
    t, idx, attr = jss.intersect_spheres_pallas(
        *map(jnp.asarray, (ro, rd, centers, radii, transparency)),
        interpret=True, attrs=jnp.asarray(attrs.T))
    return np.asarray(t), np.asarray(idx), np.asarray(attr).T


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_equals_f32_oracle_bitwise(seed):
    ro, rd, centers, radii, transparency, attrs = random_setup(seed, s=300)
    t, idx, attr = port_scan(ro, rd, centers, radii, transparency, attrs)
    t_ref, idx_ref = oracle_f32(ro, rd, centers, radii, transparency)
    np.testing.assert_array_equal(t.view(np.int32), t_ref.view(np.int32))
    np.testing.assert_array_equal(idx, idx_ref)
    np.testing.assert_array_equal(attr, attrs[idx_ref])


def test_twin_matches_pallas_interpret():
    ro, rd, centers, radii, transparency, attrs = random_setup(2)
    t, idx, attr = port_scan(ro, rd, centers, radii, transparency, attrs)
    jt, jidx, jattr = pallas_scan(ro, rd, centers, radii, transparency, attrs)
    hit = np.isfinite(jt)
    assert 0.3 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=T_RTOL, atol=0)
    np.testing.assert_array_equal(idx, jidx)        # misses keep idx 0 on both
    np.testing.assert_array_equal(attr, jattr)


def _cases():
    """Far-root, tie and padding cases, exact in f32."""
    z = np.zeros
    return {
        # a ray from the center of a glass sphere exits through the far wall
        "far_root_glass": (z((1, 3)), np.array([[0, 0, -1.0]]), z((1, 3)),
                           np.array([2.0]), np.array([1.0]), (2.0, 0)),
        # ...but an opaque sphere is not hit from inside
        "inside_opaque": (z((1, 3)), np.array([[0, 0, -1.0]]), z((1, 3)),
                          np.array([2.0]), np.array([0.0]), (np.inf, 0)),
        # two equal spheres: the first index wins the tie
        "tie_first_wins": (np.array([[0, 0, 5.0]]), np.array([[0, 0, -1.0]]),
                           z((2, 3)), np.array([1.0, 1.0]), z(2), (4.0, 0)),
        # a padding row (radius 0) in front never hits
        "padding_never_hits": (np.array([[0, 0, 5.0]]), np.array([[0, 0, -1.0]]),
                               z((2, 3)), np.array([0.0, 1.0]), z(2), (4.0, 1)),
        # origin on the surface pointing away: no self-hit below t_min
        "t_min_skips_self": (np.array([[0, 0, 1.0]]), np.array([[0, 0, 1.0]]),
                             z((1, 3)), np.array([1.0]), z(1), (np.inf, 0)),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_special_cases(case):
    ro, rd, centers, radii, transparency, (t_want, idx_want) = _cases()[case]
    args = [np.asarray(a, np.float32) for a in (ro, rd, centers, radii, transparency)]
    attrs = np.arange(len(radii) * 16, dtype=np.float32).reshape(-1, 16)
    t, idx, attr = port_scan(*args, attrs)
    jt, jidx, jattr = pallas_scan(*args, attrs)
    assert t[0] == np.float32(t_want) == jt[0]
    assert idx[0] == idx_want == jidx[0]
    np.testing.assert_array_equal(attr, jattr)


def test_expanded_quadratic_matches_jax():
    """The 'xla'-style plain backend against the JAX package's: the same
    formula, but the matrix products round in another order, and the
    expanded form's cancellation amplifies that; agreement as in the JAX
    package's own tests/test_sphere.py::test_pallas_matches_xla."""
    ro, rd, centers, radii, transparency, _ = random_setup(3, n=513, s=130)
    t, idx = t_intersect(*map(torch.as_tensor, (ro, rd, centers, radii, transparency)))
    jt, jidx = map(np.asarray, j_intersect(
        *map(jnp.asarray, (ro, rd, centers, radii, transparency))))
    t, idx = t.numpy(), idx.numpy()
    hit, jhit = np.isfinite(t), np.isfinite(jt)
    assert (hit == jhit).mean() > 0.995
    both = hit & jhit
    assert np.isclose(t[both], jt[both], rtol=1e-3, atol=1e-4).mean() > 0.995
    assert (idx[both] == jidx[both]).mean() > 0.995


def _wavefront(seed, n=1500):
    """Rays over the cover scene: camera-like rays and rays that start on or
    inside spheres (secondary rays), as numpy."""
    r = np.random.default_rng(seed)
    ro = np.concatenate([np.tile([[13.0, 2.0, 3.0]], (n // 2, 1)),
                         r.uniform([-6, 0.0, -6], [6, 1.5, 6], size=(n - n // 2, 3))])
    rd = r.normal(size=(n, 3))
    rd[: n // 2] = -np.array([13.0, 2.0, 3.0]) + r.normal(size=(n // 2, 3)) * 2
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def test_world_hit_matches_jax_pallas_path(monkeypatch):
    # reach the JAX package's Pallas path on the CPU: interpret mode, patched
    # in this test only
    monkeypatch.setattr(jss, "intersect_spheres_pallas",
                        functools.partial(jss.intersect_spheres_pallas, interpret=True))
    jwd = j_random_scene(seed=20230328).device()
    twd = t_random_scene(seed=20230328).device("cpu")
    ro, rd = _wavefront(4)
    n = len(ro)
    jr = jworld.Rays(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                     throughput=jnp.ones((n, 3)), alive=jnp.ones(n, bool))
    tr = Rays(ro=torch.as_tensor(ro), rd=torch.as_tensor(rd),
              throughput=torch.ones((n, 3)), alive=torch.ones(n, dtype=torch.bool))
    jh = jworld.hit(jwd, jr, backend="pallas")
    th = tworld.hit(twd, tr)
    hit = np.asarray(jh.hit)
    assert 0.3 < hit.mean() < 0.99
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.obj.numpy(), np.asarray(jh.obj))
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=T_RTOL)
    np.testing.assert_allclose(th.point.numpy(), np.asarray(jh.point), atol=1e-3)
    np.testing.assert_allclose(th.normal.numpy(), np.asarray(jh.normal), atol=1e-2)
    for f in ("albedo", "roughness", "metallic", "transparency", "absorptivity"):
        np.testing.assert_array_equal(getattr(th.material, f).numpy(),
                                      np.asarray(getattr(jh.material, f)), err_msg=f)
    # back faces invert the ior as 1/max(ior, 1e-9) on both (the Pallas
    # path's rule; metals have ior 0), so ior agrees exactly, inf-free
    np.testing.assert_array_equal(th.material.ior.numpy(), np.asarray(jh.material.ior))
    assert np.isfinite(th.material.ior.numpy()).all()


def test_backend_errors():
    twd = t_random_scene(seed=1).device("cpu")
    ro, rd = _wavefront(5, n=8)
    rays = Rays(ro=torch.as_tensor(ro), rd=torch.as_tensor(rd),
                throughput=torch.ones((8, 3)), alive=torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        tworld.hit(twd, rays, backend="cuda")
    # a world built without its BVH names the build that has it (the JAX
    # package's message)
    with pytest.raises(ValueError, match=r"use_bvh=True"):
        tworld.hit(twd, rays, backend="bvh")
    with pytest.raises(ValueError, match="f32"):
        tss.intersect_spheres_scan(rays.ro.double(), rays.rd, twd.scan_table,
                                   twd.scan_attrs)
    launches = tss.intersect_spheres_scan.launches
    tworld.hit(twd, rays)          # CPU tensors take the twin: no launch
    assert tss.intersect_spheres_scan.launches == launches


def _sliced_scan(ro, rd, table, attrs, slices, chunk=1024):
    """The kernel's scan by warp teams, on the plain twin: each chunk of
    ``chunk`` spheres cut into ``slices`` contiguous index ranges, slice
    ``p`` the union of its ranges over the chunks, each slice scanned on its
    own (a miss is ``(inf, 0)``), and the slices' ``(t, idx)`` reduced to
    the lexicographic least."""
    s = table.shape[0]
    parts = [[] for _ in range(slices)]
    for s0 in range(0, s, chunk):
        sc = min(chunk, s - s0)
        per = -(-sc // slices)
        for p in range(slices):
            parts[p].extend(range(s0 + p * per, s0 + min((p + 1) * per, sc)))
    n = ro.shape[0]
    t_best = torch.full((n,), float("inf"))
    idx_best = torch.zeros((n,), dtype=torch.int32)
    for part in parts:
        if not part:
            continue
        sel = torch.as_tensor(part)
        t, local, _ = tss.intersect_spheres_scan_plain(ro, rd, table[sel], attrs[sel])
        idx = torch.where(torch.isfinite(t), sel[local.long()].to(torch.int32), 0)
        better = (t < t_best) | ((t == t_best) & (idx < idx_best))
        t_best = torch.where(better, t, t_best)
        idx_best = torch.where(better, idx, idx_best)
    return t_best, idx_best, attrs[idx_best.long()]


@pytest.mark.parametrize("slices", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("s", [300, 1152])     # one shared-memory chunk, and two
def test_slice_reduction_is_the_serial_scan(slices, s):
    """The kernel's split of the table over warp teams and its
    lexicographic reduction give the serial scan's ``(t, idx, attr)`` bit
    for bit, exact ties between duplicate spheres in other slices
    included."""
    ro, rd, centers, radii, transparency, attrs = random_setup(10 + s, n=600, s=s)
    dup = np.arange(0, s // 2, 3)
    centers[dup + s // 2] = centers[dup]           # exact duplicates, later indices
    radii[dup + s // 2] = radii[dup]
    transparency[dup + s // 2] = transparency[dup]
    ro, rd, attrs = map(torch.as_tensor, (ro, rd, attrs))
    table = tss.pack_spheres(*map(torch.as_tensor, (centers, radii, transparency)))
    want = tss.intersect_spheres_scan_plain(ro, rd, table, attrs)
    got = _sliced_scan(ro, rd, table, attrs, slices)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    # the ties are real: winners with a duplicate that the ray hits at the same t
    tied = torch.isin(want[1], torch.as_tensor(dup, dtype=torch.int32)) & torch.isfinite(want[0])
    assert int(tied.sum()) > 10


def test_team_slices_per_width():
    """The slices the wrapper gives each pass width of the 10_final frame
    over its 512 spheres on an H100 (132 SMs), the bounds of the choice, and
    how it follows the SM count; the launcher takes only the listed counts."""
    H100_SMS = 132
    assert [tss.team_slices(n, 512, H100_SMS) for n in (57344, 7168, 1024, 256)] == \
        [4, 32, 32, 32]
    assert tss.team_slices(1, 1, H100_SMS) == 1 and tss.team_slices(256, 128, H100_SMS) == 8
    assert tss.team_slices(10 ** 6, 512, H100_SMS) == 1
    assert tss.team_slices(57344, 512, 2 * H100_SMS) == 8
    assert tss.team_slices(57344, 512, 28) == 1
    with pytest.raises(ValueError, match="slices"):
        tss._launch(torch.zeros((1, 3)), torch.ones((1, 3)), torch.zeros((1, 8)),
                    torch.zeros((1, 16)), tss.T_MIN, 3)
