"""Port parity: BVH build, wide collapse, traversal-table packers, treelet
boxes and coherence keys of learn_path_tracing_tpu_torch against the JAX
package, plus the port's triangle, AABB and sphere-UV geometry.

Tolerances: the host-side structures (FlatBVH, WideBVH, the kernel tables
``nodes/entries/runs`` and the treelet boxes) are equal byte for byte: the
same numpy operations in the same order. Coherence sort keys are equal
value for value (the same f32 slab tests). Geometry helpers to 1e-5
relative (XLA on the CPU contracts multiply-adds; PyTorch rounds every
operation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.accel.bvh import build_bvh as j_build_bvh
from learn_path_tracing_tpu.accel.bvh import bvh_stats as j_bvh_stats
from learn_path_tracing_tpu.accel.wide import collapse as j_collapse
from learn_path_tracing_tpu.geometry import aabb as j_aabb
from learn_path_tracing_tpu.geometry import sphere as j_sphere
from learn_path_tracing_tpu.geometry import triangle as j_triangle
from learn_path_tracing_tpu.ops import packet_traverse as jpt
from learn_path_tracing_tpu_torch.accel import build_bvh, bvh_stats, collapse, decode_leaf
from learn_path_tracing_tpu_torch.geometry import (aabb_hit, interpolate_attributes,
                                                   sphere_uv, triangle_barycentrics,
                                                   triangle_t)
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt

torch.set_num_threads(2)

FLAT = ("left", "right", "low", "high", "data", "cut", "prim")
WIDE = ("child_low", "child_high", "child_entry", "prim")


def _mesh(seed, t_count):
    r = np.random.default_rng(seed)
    base = r.normal(size=(t_count, 3)).astype(np.float32) * 3
    v1 = base + r.normal(size=(t_count, 3)).astype(np.float32)
    v2 = base + r.normal(size=(t_count, 3)).astype(np.float32)
    return base, v1, v2


def _spheres(seed, s):
    r = np.random.default_rng(seed)
    c = r.uniform(-10, 10, (s, 3)).astype(np.float32)
    rad = r.uniform(0.1, 1.0, s).astype(np.float32)
    tr = (r.uniform(size=s) < 0.3).astype(np.float32)
    return c, rad, tr


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _both_bvhs(v0, v1, v2, max_depth, max_leaf):
    plow = np.minimum(np.minimum(v0, v1), v2)
    phigh = np.maximum(np.maximum(v0, v1), v2)
    c = (v0 + v1 + v2) / 3
    return (j_build_bvh(plow, phigh, centroid=c, max_depth=max_depth,
                        max_leaf=max_leaf, backend="numpy"),
            build_bvh(plow, phigh, centroid=c, max_depth=max_depth, max_leaf=max_leaf))


@pytest.mark.parametrize("t_count,max_depth,max_leaf", [(1, 8, 4), (300, 12, 4),
                                                        (500, 24, 8), (400, 6, 12)])
def test_bvh_and_collapse_byte_identical(t_count, max_depth, max_leaf):
    v0, v1, v2 = _mesh(t_count, t_count)
    jf, tf = _both_bvhs(v0, v1, v2, max_depth, max_leaf)
    for k in FLAT:
        assert _same_bytes(getattr(jf, k), getattr(tf, k)), k
    assert (jf.max_depth, jf.max_leaf) == (tf.max_depth, tf.max_leaf)
    assert tf.n_nodes == jf.n_nodes == tf.left.shape[0]
    assert j_bvh_stats(jf) == bvh_stats(tf)
    jw, tw = j_collapse(jf), collapse(tf)
    for k in WIDE:
        assert _same_bytes(getattr(jw, k), getattr(tw, k)), k
    assert (jw.depth, jw.max_leaf) == (tw.depth, tw.max_leaf)


@pytest.mark.parametrize("max_leaf", [4, 8, 12])
def test_triangle_tables_byte_identical(max_leaf):
    """Packed tables of K2, a fat-leaf case (runs of 12 spill into a second
    row) included, and the treelet boxes built from them."""
    v0, v1, v2 = _mesh(7 + max_leaf, 400)
    jf, tf = _both_bvhs(v0, v1, v2, 12, max_leaf)
    jt = jpt.pack_packet_tables(j_collapse(jf, max_run=max_leaf), v0, v1, v2)
    tt = tpt.pack_packet_tables(collapse(tf, max_run=max_leaf), v0, v1, v2)
    for name, a, b in zip(("nodes", "entries", "runs"), jt, tt):
        assert _same_bytes(a, b), name
    for a, b in zip(jpt.treelet_boxes(*jt[:2]), tpt.treelet_boxes(*tt[:2])):
        assert _same_bytes(a, b)
    codes = tt[1][:, :8]
    counts = decode_leaf(codes[(codes < 0) & (codes != -(2 ** 30))])[1]
    assert counts.max() == max_leaf


def test_sphere_tables_byte_identical():
    c, r, tr = _spheres(3, 700)
    jf = j_build_bvh(c - r[:, None], c + r[:, None], centroid=c, max_depth=12,
                     max_leaf=8, backend="numpy")
    tf = build_bvh(c - r[:, None], c + r[:, None], centroid=c, max_depth=12, max_leaf=8)
    jt = jpt.pack_sphere_packet_tables(j_collapse(jf), c, r, tr)
    tt = tpt.pack_sphere_packet_tables(collapse(tf), c, r, tr)
    for name, a, b in zip(("nodes", "entries", "runs"), jt, tt):
        assert _same_bytes(a, b), name


def test_stack_cap_bounds_the_tree():
    """``stack_cap`` = 1 + 7 * (wide levels): never above the kernel's
    stack, and never below what the JAX package's depth bound implies."""
    v0, v1, v2 = _mesh(5, 2000)
    _, tf = _both_bvhs(v0, v1, v2, 24, 8)
    wide = collapse(tf)
    cap = tpt.stack_cap(tpt.pack_packet_tables(wide, v0, v1, v2)[1])
    assert 1 + 7 * 2 <= cap <= 1 + 7 * wide.depth <= tpt.MAX_STACK


@pytest.mark.parametrize("eps", [0.0, 1e-4])
def test_coherence_key_matches_jax(eps):
    v0, v1, v2 = _mesh(11, 300)
    jf, _ = _both_bvhs(v0, v1, v2, 12, 8)
    nodes, entries, _ = jpt.pack_packet_tables(j_collapse(jf), v0, v1, v2)
    r = np.random.default_rng(4)
    n = 2000
    ro = (r.normal(size=(n, 3)) * 6).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[:40, 0] = 0.0          # axis-parallel rays: inf / NaN slabs
    treelets = jpt.treelet_boxes(nodes, entries)
    jkey = np.asarray(jpt._coherence_key(jnp.asarray(nodes), jnp.asarray(entries),
                                         jnp.asarray(ro), jnp.asarray(rd), eps=eps,
                                         treelets=treelets))
    tkey = tpt._coherence_key(torch.tensor(np.asarray(nodes)), torch.as_tensor(ro),
                              torch.as_tensor(rd),
                              tuple(torch.tensor(np.asarray(x)) for x in treelets),
                              eps=eps)
    np.testing.assert_array_equal(tkey.numpy(), jkey.astype(np.int64))
    assert len(np.unique(jkey)) > 20


def test_triangle_geometry_matches_jax():
    r = np.random.default_rng(9)
    n = 500
    p1, p2, p3 = (r.normal(size=(n, 3)).astype(np.float32) for _ in range(3))
    ro = (r.normal(size=(n, 3)) * 3).astype(np.float32)
    target = (0.2 * p1 + 0.3 * p2 + 0.5 * p3) + 0.3 * r.normal(size=(n, 3)).astype(np.float32)
    rd = (target - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    jt = np.asarray(j_triangle.triangle_t(*map(jnp.asarray, (p1, p2, p3, ro, rd))))
    tt = triangle_t(*map(torch.as_tensor, (p1, p2, p3, ro, rd))).numpy()
    hit = np.isfinite(jt)
    assert 50 < hit.sum() < n
    # a grazing edge may flip on an ulp; all others agree
    assert (np.isfinite(tt) == hit).mean() >= 0.99
    both = hit & np.isfinite(tt)
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)

    point = (0.2 * p1 + 0.3 * p2 + 0.5 * p3).astype(np.float32)
    jw = j_triangle.triangle_barycentrics(*map(jnp.asarray, (p1, p2, p3, point)))
    tw = triangle_barycentrics(*map(torch.as_tensor, (p1, p2, p3, point)))
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)
    nrm = [r.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    uvs = [r.uniform(size=(n, 2)).astype(np.float32) for _ in range(3)]
    w = [np.array(x) for x in jw]
    ja = j_triangle.interpolate_attributes(*map(jnp.asarray, w + nrm + uvs + [p1, p2, p3]))
    ta = interpolate_attributes(*map(torch.as_tensor, w + nrm + uvs + [p1, p2, p3]))
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


def test_aabb_and_sphere_uv_match_jax():
    r = np.random.default_rng(2)
    n = 1000
    lo = r.normal(size=(n, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 2, (n, 3)).astype(np.float32)
    hi[:50, 1] = lo[:50, 1]                   # flat boxes: the eps keeps them
    ro = (r.normal(size=(n, 3)) * 4).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd[:20, 2] = 0.0
    jh = np.asarray(j_aabb.aabb_hit(*map(jnp.asarray, (lo, hi, ro, rd))))
    th = aabb_hit(*map(torch.as_tensor, (lo, hi, ro, rd))).numpy()
    np.testing.assert_array_equal(th, jh)
    assert 0 < jh.sum() < n

    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    np.testing.assert_allclose(sphere_uv(torch.as_tensor(nrm)).numpy(),
                               np.asarray(j_sphere.sphere_uv(jnp.asarray(nrm))),
                               rtol=1e-5, atol=1e-6)
