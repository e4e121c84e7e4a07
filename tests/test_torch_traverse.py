"""The port's lockstep walks (``accel.traverse``, ``accel.wide.traverse_wide``)
against the JAX package's, on the same numpy-seeded trees and rays.

Tolerances, with their reasons:

- The port's leaf tests against JAX's, called op by op: bit for bit (the
  same f32 formulas), on far and grazing rays too.
- Port against JAX (either walk): hit masks equal, ``t`` within rtol 1e-5,
  atol 1e-6, ``prim`` equal away from ties (rays whose two nearest
  primitives are within that bound of each other). JAX runs its leaf test
  inside a jitted loop, where XLA's CPU backend contracts multiply-adds:
  that changes the rounding of the sphere quadratic's ``half_b² - c``,
  and so moves ``t`` by up to 1.4e-4 relative on grazing hits from origins
  about 100 radii away (measured on a chain of 256 spheres of radius 0.3
  seen from origins 30 units off). The walks are therefore compared on
  the JAX tests' own inputs
  (``tests/test_bvh.py``'s ``random_spheres``/``random_rays``: origins
  among the primitives), and the far rays on the leaf tests alone.
- The port's wide walk against its binary walk: ``tests/test_wide_bvh.py``'s
  bounds, rtol 1e-6 / atol 1e-7 and ``prim`` equal.
- The wide walk against ``ops.packet_traverse.packet_traverse_plain`` (the
  plain twin of kernels K2/K3, the bounds ``chip_smoke.py`` holds the
  kernels to): triangles within rtol 1e-4 / atol 1e-5 with ``prim`` equal
  on at least 95 % of hits (the packed plane/barycentric coefficients
  against ``triangle_t``, ``tests/test_packet_traverse.py:62-65``); spheres
  within rtol 1e-5 / atol 1e-6 with ``prim`` equal away from ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.accel import traverse as jtr
from learn_path_tracing_tpu.accel import wide as jwide
from learn_path_tracing_tpu.accel.bvh import build_bvh as j_build_bvh
from learn_path_tracing_tpu_torch.accel import traverse as ttr
from learn_path_tracing_tpu_torch.accel import wide as twide
from learn_path_tracing_tpu_torch.accel.bvh import build_bvh
from learn_path_tracing_tpu_torch.geometry.sphere import sphere_t
from learn_path_tracing_tpu_torch.geometry.triangle import triangle_t
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt

RTOL, ATOL = 1e-5, 1e-6


def _rays(rng, n, targets=None, scale=4.0):
    """``tests/test_bvh.py``'s ``random_rays`` (origins ``normal * 4``,
    random directions), or with ``targets`` each ray aimed near a random
    target point (within a unit normal jitter), so that most but not all
    hit."""
    ro = rng.normal(size=(n, 3)).astype(np.float32) * scale
    if targets is None:
        rd = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        rd = targets[rng.integers(0, len(targets), size=n)] + rng.normal(size=(n, 3)) - ro
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


def _spheres(rng, n):
    """``tests/test_bvh.py``'s ``random_spheres``."""
    c = rng.normal(size=(n, 3)).astype(np.float32) * 5
    r = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    tr = (rng.uniform(size=n) < 0.25).astype(np.float32)
    return c, r, tr


def _triangles(rng, n):
    v0 = rng.normal(size=(n, 3)).astype(np.float32) * 4
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32)
    return v0, v1, v2


def _boxes(kind, prims):
    if kind == "sphere":
        c, r, _ = prims
        return c - r[:, None], c + r[:, None], c
    v0, v1, v2 = prims
    return (np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
            (v0 + v1 + v2) / 3)


def _leaf_tests(kind, prims):
    make = {"sphere": (jtr.make_sphere_leaf_test, ttr.make_sphere_leaf_test),
            "tri": (jtr.make_triangle_leaf_test, ttr.make_triangle_leaf_test)}[kind]
    return (make[0](*map(jnp.asarray, prims)),
            make[1](*(torch.as_tensor(p) for p in prims)))


def _all_pairs_t(kind, prims, ro, rd):
    """``t f32[N, P]`` of every (ray, primitive) pair with the port's test."""
    ro_, rd_ = torch.as_tensor(ro)[:, None], torch.as_tensor(rd)[:, None]
    p = [torch.as_tensor(x)[None] for x in prims]
    if kind == "sphere":
        return sphere_t(*p, ro_, rd_).numpy()
    return triangle_t(*p, ro_, rd_).numpy()


def _untied(t_all, t_best):
    """Rays whose nearest hit is not tied: the runner-up is farther than
    the comparison bound."""
    second = np.sort(t_all, axis=1)[:, 1] if t_all.shape[1] > 1 else np.full(len(t_all), np.inf)
    return np.isfinite(t_best) & ~np.isclose(second, t_best, rtol=RTOL, atol=ATOL)


def _walk_both(walk, kind, prims, ro, rd, max_depth, max_leaf, t_init=None):
    plow, phigh, cen = _boxes(kind, prims)
    jb = j_build_bvh(plow, phigh, centroid=cen, max_depth=max_depth, max_leaf=max_leaf)
    tb = build_bvh(plow, phigh, centroid=cen, max_depth=max_depth, max_leaf=max_leaf)
    jlt, tlt = _leaf_tests(kind, prims)
    if walk == "wide":
        jb, tb = jwide.collapse(jb), twide.collapse(tb)
        jfn, tfn = jwide.traverse_wide, twide.traverse_wide
    else:
        jfn, tfn = jtr.traverse, ttr.traverse
    jt, jp = jfn(jb, jnp.asarray(ro), jnp.asarray(rd), jlt,
                 t_init=None if t_init is None else jnp.asarray(t_init))
    tt, tp = tfn(tb, torch.as_tensor(ro), torch.as_tensor(rd), tlt,
                 t_init=None if t_init is None else torch.as_tensor(t_init))
    assert tt.dtype == torch.float32 and tp.dtype == torch.int32
    return np.asarray(jt), np.asarray(jp), tt.numpy(), tp.numpy()


def _assert_agree(jt, jp, tt, tp, untied):
    hit = np.isfinite(jt)
    assert np.array_equal(np.isfinite(tt), hit)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL, atol=ATOL)
    assert np.array_equal(tp[~hit], jp[~hit])
    assert np.array_equal(tp[untied], jp[untied])


@pytest.mark.parametrize("walk", ["binary", "wide"])
@pytest.mark.parametrize("kind,n_prims,n_rays", [("sphere", 200, 400), ("tri", 60, 64)])
def test_walk_matches_jax(walk, kind, n_prims, n_rays):
    rng = np.random.default_rng(11 if kind == "sphere" else 12)
    prims = _spheres(rng, n_prims) if kind == "sphere" else _triangles(rng, n_prims)
    ro, rd = _rays(rng, n_rays, None if kind == "sphere" else _boxes(kind, prims)[2])
    jt, jp, tt, tp = _walk_both(walk, kind, prims, ro, rd, 8, 4)
    assert 0.1 < np.isfinite(tt).mean() < 0.95
    _assert_agree(jt, jp, tt, tp, _untied(_all_pairs_t(kind, prims, ro, rd), tt))


@pytest.mark.parametrize("walk", ["binary", "wide"])
def test_t_init_prunes_and_keeps_prim_minus_one(walk):
    """``t_init`` below a ray's hit suppresses it (``t = t_init``, ``prim =
    -1``); above it, the hit is found as without it."""
    rng = np.random.default_rng(13)
    prims = _spheres(rng, 200)
    ro, rd = _rays(rng, 400)
    plow, phigh, cen = _boxes("sphere", prims)
    tree = build_bvh(plow, phigh, centroid=cen, max_depth=8, max_leaf=4)
    fn, tree = ((twide.traverse_wide, twide.collapse(tree)) if walk == "wide"
                else (ttr.traverse, tree))
    t_free, p_free = (x.numpy() for x in fn(tree, torch.as_tensor(ro), torch.as_tensor(rd),
                                             _leaf_tests("sphere", prims)[1]))
    hit = np.isfinite(t_free)
    t_init = np.where(np.arange(400) % 2 == 0, 0.5 * t_free, 1.5 * t_free).astype(np.float32)
    t_init[~hit] = 7.0
    jt, jp, tt, tp = _walk_both(walk, "sphere", prims, ro, rd, 8, 4, t_init=t_init)
    _assert_agree(jt, jp, tt, tp, np.zeros(400, bool))
    pruned = (np.arange(400) % 2 == 0) & hit
    assert pruned.sum() > 20
    assert np.array_equal(tt[pruned], t_init[pruned]) and (tp[pruned] == -1).all()
    kept = ~pruned & hit
    assert np.array_equal(tt[kept], t_free[kept]) and np.array_equal(tp[kept], p_free[kept])
    assert np.array_equal(tt[~hit], t_init[~hit]) and (tp[~hit] == -1).all()


def test_single_primitive_and_deep_tree():
    """One sphere (a hit at 2 and a miss: ``tests/test_bvh.py``'s values)
    and a chain of 128 spheres split to leaves of one (a deep tree), both
    walks against JAX's."""
    c, r, tr = (torch.tensor([[0.0, 0, -3]]), torch.tensor([1.0]), torch.zeros(1))
    one = build_bvh((c - r[:, None]).numpy(), (c + r[:, None]).numpy())
    lt = ttr.make_sphere_leaf_test(c, r, tr)
    ro, rd = torch.zeros((2, 3)), torch.tensor([[0.0, 0, -1], [0, 1, 0]])
    for t, p in (ttr.traverse(one, ro, rd, lt),
                 twide.traverse_wide(twide.collapse(one), ro, rd, lt)):
        assert abs(float(t[0]) - 2.0) < 1e-5 and int(p[0]) == 0
        assert float(t[1]) == float("inf") and int(p[1]) == -1

    rng = np.random.default_rng(14)
    n = 128
    c = np.stack([np.arange(n) * 0.5, rng.normal(size=n) * 0.1, np.zeros(n)], 1).astype(np.float32)
    r = np.full(n, 0.3, np.float32)
    tr = np.zeros(n, np.float32)
    # origins along the chain, each ray aimed near a sphere within 8 of it
    k = rng.integers(0, n, size=200)
    ro = (rng.normal(size=(200, 3)) * 4 + c[k] * [1, 0, 0]).astype(np.float32)
    aim = c[np.clip(k + rng.integers(-8, 9, size=200), 0, n - 1)] + rng.normal(size=(200, 3))
    rd = ((aim - ro) / np.linalg.norm(aim - ro, axis=-1, keepdims=True)).astype(np.float32)
    deep = build_bvh(c - r[:, None], c + r[:, None], centroid=c, max_depth=24, max_leaf=1)
    assert deep.max_leaf == 1 and deep.n_nodes == 2 * n - 1
    for walk in ("binary", "wide"):
        jt, jp, tt, tp = _walk_both(walk, "sphere", (c, r, tr), ro, rd, 24, 1)
        assert np.isfinite(tt).sum() > 20
        _assert_agree(jt, jp, tt, tp, _untied(_all_pairs_t("sphere", (c, r, tr), ro, rd), tt))


@pytest.mark.parametrize("kind", ["sphere", "tri"])
def test_wide_matches_binary_with_fat_leaves(kind):
    """Leaves of up to 20 primitives, which the collapse splits into runs
    of 8: the wide walk finds the binary walk's hits."""
    rng = np.random.default_rng(15)
    prims = _spheres(rng, 300) if kind == "sphere" else _triangles(rng, 300)
    ro, rd = _rays(rng, 300, _boxes(kind, prims)[2])
    plow, phigh, cen = _boxes(kind, prims)
    flat = build_bvh(plow, phigh, centroid=cen, max_depth=5, max_leaf=20)
    wide = twide.collapse(flat)
    assert flat.max_leaf > 8 and wide.max_leaf == 8
    _, lt = _leaf_tests(kind, prims)
    ro_t, rd_t = torch.as_tensor(ro), torch.as_tensor(rd)
    t_b, p_b, steps_b = ttr.traverse(flat, ro_t, rd_t, lt, stats=True)
    t_w, p_w, steps_w = twide.traverse_wide(wide, ro_t, rd_t, lt, stats=True)
    assert 0 < steps_w < steps_b
    hit = torch.isfinite(t_b)
    assert torch.equal(torch.isfinite(t_w), hit) and int(hit.sum()) > 30
    np.testing.assert_allclose(t_w[hit].numpy(), t_b[hit].numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(p_w[hit], p_b[hit])


@pytest.mark.parametrize("kind", ["sphere", "tri"])
def test_wide_walk_checks_the_kernel_twin(kind):
    """``traverse_wide`` against ``packet_traverse_plain`` over tables packed
    from the same tree: the check ``chip_smoke.py``'s ``[lockstep walks]``
    phase makes of kernels K2 and K3 on the card."""
    rng = np.random.default_rng(16)
    prims = _spheres(rng, 500) if kind == "sphere" else _triangles(rng, 500)
    ro, rd = _rays(rng, 500, _boxes(kind, prims)[2])
    plow, phigh, cen = _boxes(kind, prims)
    wide = twide.collapse(build_bvh(plow, phigh, centroid=cen, max_depth=12, max_leaf=4))
    pack = tpt.pack_sphere_packet_tables if kind == "sphere" else tpt.pack_packet_tables
    tables = [torch.as_tensor(x) for x in pack(wide, *prims)]
    ro_t, rd_t = torch.as_tensor(ro), torch.as_tensor(rd)
    inf = torch.full((500,), float("inf"))
    t_k, p_k, _ = tpt.packet_traverse_plain(*tables, ro_t, rd_t, inf, torch.ones(500, dtype=bool),
                                            leaf_kind=kind)
    t_k = torch.where(p_k >= 0, t_k, float("inf"))
    _, lt = _leaf_tests(kind, prims)
    t_w, p_w = twide.traverse_wide(wide, ro_t, rd_t, lt)
    hit = torch.isfinite(t_w)
    assert torch.equal(torch.isfinite(t_k), hit) and int(hit.sum()) > 50
    if kind == "tri":
        np.testing.assert_allclose(t_k[hit].numpy(), t_w[hit].numpy(), rtol=1e-4, atol=1e-5)
        assert (p_k[hit] == p_w[hit]).float().mean() >= 0.95
    else:
        np.testing.assert_allclose(t_k[hit].numpy(), t_w[hit].numpy(), rtol=RTOL, atol=ATOL)
        untied = _untied(_all_pairs_t(kind, prims, ro, rd), t_w.numpy())
        assert torch.equal(p_k[untied], p_w[untied])


@pytest.mark.parametrize("kind", ["sphere", "tri"])
def test_leaf_tests_are_jax_op_by_op(kind):
    """The leaf tests on every (ray, primitive) pair of 64 primitives,
    against JAX's called outside a jitted loop: bit for bit, with origins
    30 units off (the grazing hits whose ``t`` XLA's contraction moves in
    JAX's walk)."""
    rng = np.random.default_rng(18)
    prims = _spheres(rng, 64) if kind == "sphere" else _triangles(rng, 64)
    ro, rd = _rays(rng, 256, _boxes(kind, prims)[2], scale=30.0)
    jlt, tlt = _leaf_tests(kind, prims)
    pidx = np.tile(np.arange(64, dtype=np.int32), 256)
    valid = rng.uniform(size=pidx.shape) < 0.9
    o, d = np.repeat(ro, 64, axis=0), np.repeat(rd, 64, axis=0)
    jt = np.asarray(jlt(jnp.asarray(pidx), jnp.asarray(valid), jnp.asarray(o), jnp.asarray(d)))
    tt = tlt(torch.as_tensor(pidx), torch.as_tensor(valid), torch.as_tensor(o),
             torch.as_tensor(d)).numpy()
    assert np.isfinite(tt).sum() > 40
    assert np.array_equal(tt, jt)


def test_stack_read_write_match_jax():
    rng = np.random.default_rng(17)
    stack = rng.integers(-50, 50, size=(64, 9)).astype(np.int32)
    col = rng.integers(0, 9, size=64).astype(np.int32)
    value = rng.integers(100, 200, size=64).astype(np.int32)
    mask = rng.uniform(size=64) < 0.5
    s = torch.as_tensor(stack)
    assert np.array_equal(ttr.stack_read(s, torch.as_tensor(col)).numpy(),
                          np.asarray(jtr.stack_read(jnp.asarray(stack), jnp.asarray(col))))
    out = ttr.stack_write(s, torch.as_tensor(col), torch.as_tensor(value), torch.as_tensor(mask))
    ref = jtr.stack_write(jnp.asarray(stack), jnp.asarray(col), jnp.asarray(value),
                          jnp.asarray(mask))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert np.array_equal(s.numpy(), stack)  # the input is not written
