"""Port parity: the plain twin of the packet-traversal kernels K2 (triangle
leaves), K3 (sphere leaves), K5a (version 1) and K5b (version 3) against the
JAX package's Pallas kernels of the same version in interpret mode, and
against a brute-force oracle.

Tolerances, with their reasons:

- Against Pallas: ``t`` within 1e-5 relative where both hit (XLA on the CPU
  contracts the kernel's multiply-adds into FMAs; the port rounds every
  operation), and for spheres also within 2e-7 absolute: ``-b ± sqrt(disc)``
  cancels for origins near a surface, leaving an ulp of the O(1) terms on
  a tiny ``t``; hit/miss and ``prim`` equal on at least 99.9 % of rays. Each
  differing ray is printed and must be an exact tie (the TPU kernel picks
  the earliest slot among near-equal keys, the port the smaller prim id)
  or a grazing edge (a barycentric weight within 1e-4 of 0).
- Against the brute force (every run row of the tables tested for every
  ray with the twin's own leaf arithmetic and tie rule): bit for bit. So
  the eps-relaxed slab test culls no hit.
- ``packet_traverse_sorted``: the sort permutation, ``entered_n`` and the
  carried payload equal JAX's exactly (the coherence keys are equal), and
  the hits within the tolerance above.
- Versions 1 and 3 (the twin with v1's slab form ``(lo - ro)*inv``, and
  with the hoisted form, v3 being v2's function) against JAX's v1 and v3
  kernels: the same tolerance. On exactly axis-parallel rays, where the
  two slab forms differ, ``prim`` equal and ``t`` to 1e-5 relative: v1
  hits every ray on both sides, v2 and v3 none.
- The lane-order entry's coherence sort (``sort_rays=True``) against lane
  order, per version: bit for bit.
- The schedule models (numpy, step for step what a kernel does, or what a
  design that was measured on the card and dropped did: the split triangle
  leaf, v1's pushed leaves, ray refetch, a shared ranged stack) against the
  twin: bit for bit in ``(t, prim)``, and in the pops where they are per ray.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_path_tracing_tpu.accel.bvh import build_bvh as j_build_bvh
from learn_path_tracing_tpu.accel.wide import collapse as j_collapse
from learn_path_tracing_tpu.ops import packet_traverse as jpt
from learn_path_tracing_tpu_torch.accel.wide import _PAD, decode_leaf
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt

torch.set_num_threads(2)


def _tri_tables(seed, t_count, max_leaf):
    r = np.random.default_rng(seed)
    v0 = r.normal(size=(t_count, 3)).astype(np.float32) * 3
    v1 = v0 + r.normal(size=(t_count, 3)).astype(np.float32)
    v2 = v0 + r.normal(size=(t_count, 3)).astype(np.float32)
    plow = np.minimum(np.minimum(v0, v1), v2)
    phigh = np.maximum(np.maximum(v0, v1), v2)
    flat = j_build_bvh(plow, phigh, centroid=(v0 + v1 + v2) / 3, max_depth=12,
                       max_leaf=max_leaf, backend="numpy")
    tables = jpt.pack_packet_tables(j_collapse(flat, max_run=max_leaf), v0, v1, v2)
    return (v0, v1, v2), [np.asarray(x) for x in tables]


def _sphere_tables(seed, s):
    r = np.random.default_rng(seed)
    c = r.uniform(-6, 6, (s, 3)).astype(np.float32)
    rad = r.uniform(0.2, 1.2, s).astype(np.float32)
    tr = (r.uniform(size=s) < 0.3).astype(np.float32)
    flat = j_build_bvh(c - rad[:, None], c + rad[:, None], centroid=c, max_depth=12,
                       max_leaf=8, backend="numpy")
    return [np.asarray(x) for x in jpt.pack_sphere_packet_tables(j_collapse(flat), c, rad, tr)]


def _rays(seed, n, scale=5.0, t_init=False, inactive=False, inside=None):
    r = np.random.default_rng(seed)
    ro = (r.normal(size=(n, 3)) * scale).astype(np.float32)
    if inside is not None:                 # some origins inside spheres
        c, rad = inside
        k = r.integers(len(rad), size=n // 4)
        ro[:n // 4] = c[k] + 0.5 * rad[k, None] * r.normal(size=(n // 4, 3)) / 2
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ti = np.full(n, np.inf, np.float32)
    if t_init:
        pick = r.uniform(size=n) < 0.4
        ti[pick] = r.uniform(1, 10, pick.sum())
    active = r.uniform(size=n) < 0.7 if inactive else np.ones(n, bool)
    return ro, rd.astype(np.float32), ti, active


def _port(tables, ro, rd, ti, active, leaf_kind="tri", version=2, sort_rays=False):
    t, p = tpt.packet_traverse(*(torch.tensor(x) for x in tables), torch.as_tensor(ro),
                               torch.as_tensor(rd), torch.as_tensor(ti),
                               torch.as_tensor(active), leaf_kind=leaf_kind, version=version,
                               sort_rays=sort_rays)
    return t.numpy(), p.numpy()


def _jax(tables, ro, rd, ti, active, leaf_kind="tri", version=2):
    t, p = jpt.packet_traverse(*(jnp.asarray(x) for x in tables), jnp.asarray(ro),
                               jnp.asarray(rd), jnp.asarray(ti), jnp.asarray(active),
                               interpret=True, sort_rays=False, leaf_kind=leaf_kind,
                               version=version)
    return np.asarray(t), np.asarray(p)


def _tri_eval(v, ro, rd, prim):
    """f64 (t, smallest barycentric weight) of triangle ``prim`` per ray."""
    p1, p2, p3 = (x[prim].astype(np.float64) for x in v)
    ro, rd = ro.astype(np.float64), rd.astype(np.float64)
    e1, e2 = p2 - p1, p3 - p1
    n = np.cross(e1, e2)
    t = np.sum((p1 - ro) * n, -1) / np.sum(rd * n, -1)
    q = ro + t[:, None] * rd
    area = np.sum(n * n, -1)
    w1 = np.sum(np.cross(p3 - p2, q - p2) * n, -1) / area
    w2 = np.sum(np.cross(p1 - p3, q - p3) * n, -1) / area
    return t, np.minimum(np.minimum(w1, w2), 1 - w1 - w2)


def _agree(tp, pp, tj, pj, explain, atol=0.0):
    """The stated tolerance; ``explain(i)`` says why ray ``i`` may differ."""
    hit_p, hit_j = pp >= 0, pj >= 0
    both = hit_p & hit_j
    np.testing.assert_allclose(tp[both], tj[both], rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(tp[~hit_p & ~hit_j], tj[~hit_p & ~hit_j])
    differ = np.flatnonzero((hit_p != hit_j) | (pp != pj))
    print(f"{len(differ)} of {len(pp)} rays differ in hit/miss or prim")
    assert len(differ) <= 0.001 * len(pp)
    for i in differ:
        assert explain(i), f"ray {i}: port ({tp[i]}, {pp[i]}) vs JAX ({tj[i]}, {pj[i]})"
    return int(hit_p.sum())


def _tri_explain(v, ro, rd, tp, pp, tj, pj):
    def explain(i):
        prims = [p for p in (pp[i], pj[i]) if p >= 0]
        t, w = _tri_eval(v, np.repeat(ro[i:i + 1], len(prims), 0),
                         np.repeat(rd[i:i + 1], len(prims), 0), np.array(prims))
        grazing = bool((np.abs(w) < 1e-4).any())
        tie = len(prims) == 2 and abs(tp[i] - tj[i]) <= 1e-5 * abs(tj[i])
        return grazing or tie
    return explain


@pytest.mark.parametrize("max_leaf,t_init,inactive", [(4, False, False), (8, True, True),
                                                      (12, True, False)])
def test_plain_k2_matches_pallas(max_leaf, t_init, inactive):
    """Triangle leaves: plain seeds, ``t_init`` seeding with inactive lanes,
    and fat leaves (runs of 12 spill into a second row)."""
    v, tables = _tri_tables(max_leaf, 250, max_leaf)
    ro, rd, ti, active = _rays(10 + max_leaf, 1024, t_init=t_init, inactive=inactive)
    tp, pp = _port(tables, ro, rd, ti, active)
    tj, pj = _jax(tables, ro, rd, ti, active)
    hits = _agree(tp, pp, tj, pj, _tri_explain(v, ro, rd, tp, pp, tj, pj))
    assert hits > 100
    # inactive lanes keep t_init and report no prim; unbeaten lanes keep t_init
    np.testing.assert_array_equal(tp[~active], ti[~active])
    assert (pp[~active] == -1).all()
    np.testing.assert_array_equal(tp[pp < 0], ti[pp < 0])


@pytest.mark.parametrize("version", [1, 3])
@pytest.mark.parametrize("max_leaf,t_init,inactive", [(4, False, False), (8, True, True),
                                                      (12, True, False)])
def test_plain_k5_matches_pallas(max_leaf, t_init, inactive, version):
    """The twin of K5a (v1's slab form) and of K5b (the hoisted form)
    against JAX's v1 and v3 kernels, on the cases of the K2 comparison."""
    v, tables = _tri_tables(max_leaf, 250, max_leaf)
    ro, rd, ti, active = _rays(10 + max_leaf, 1024, t_init=t_init, inactive=inactive)
    tp, pp = _port(tables, ro, rd, ti, active, version=version)
    tj, pj = _jax(tables, ro, rd, ti, active, version=version)
    assert _agree(tp, pp, tj, pj, _tri_explain(v, ro, rd, tp, pp, tj, pj)) > 100
    np.testing.assert_array_equal(tp[~active], ti[~active])
    assert (pp[~active] == -1).all()


def test_axis_parallel_rays_hit_only_in_version_1():
    """Rays along +z, aimed at the centroids of 60 triangles that lie in
    the positive x, y quadrant: v1's ``(lo - ro)*inv`` hits them all, while
    the hoisted ``lo*inv - ro*inv`` of v2 and v3 gives ``inf - inf = NaN``
    at the root and misses them all, in JAX's kernels and in the twin."""
    r = np.random.default_rng(60)
    v0 = (r.uniform(1, 5, (60, 3)) * [1, 1, 2]).astype(np.float32)
    v1 = (v0 + r.uniform(0.3, 1.0, (60, 3)) * [1, 0, 0.2]).astype(np.float32)
    v2 = (v0 + r.uniform(0.3, 1.0, (60, 3)) * [0, 1, 0.2]).astype(np.float32)
    lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
    flat = j_build_bvh(lo, hi, centroid=(v0 + v1 + v2) / 3, max_leaf=4, backend="numpy")
    tables = [np.asarray(x) for x in
              jpt.pack_packet_tables(j_collapse(flat, max_run=4), v0, v1, v2)]
    cent = (v0 + v1 + v2) / 3
    ro = np.concatenate([cent[:, :2], np.full((60, 1), -5.0)], 1).astype(np.float32)
    rd = np.tile(np.array([[0, 0, 1]], np.float32), (60, 1))
    ti, active = np.full(60, np.inf, np.float32), np.ones(60, bool)
    for version in (1, 2, 3):
        tp, pp = _port(tables, ro, rd, ti, active, version=version)
        tj, pj = _jax(tables, ro, rd, ti, active, version=version)
        np.testing.assert_array_equal(pp, pj)
        np.testing.assert_allclose(tp, tj, rtol=1e-5)
        assert (pp >= 0).sum() == (60 if version == 1 else 0), version


@pytest.mark.parametrize("version", [1, 2, 3])
def test_sorted_lane_order_entry_is_lane_exact(version):
    """``packet_traverse(sort_rays=True)`` (the coherence sort before the
    kernel and the inverse after) returns lane order bit for bit."""
    _, tables = _tri_tables(2, 250, 8)
    ro, rd, ti, active = _rays(41, 1500, t_init=True, inactive=True)
    t0, p0 = _port(tables, ro, rd, ti, active, version=version)
    t1, p1 = _port(tables, ro, rd, ti, active, version=version, sort_rays=True)
    assert (p0 >= 0).sum() > 100
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(t1.view(np.int32), t0.view(np.int32))


def test_with_stats_in_jax_positions():
    """JAX's positional order (``eps, sort_rays, with_stats``): with stats
    the call adds each ray's node pops (the walk's ``iters``; JAX gives one
    count a packet) to the same ``(t, prim)``, and, as in JAX, refuses
    ``sort_rays``. ``(t, prim)`` are held to JAX's Pallas kernel above."""
    _, tables = _tri_tables(2, 250, 8)
    args = [torch.as_tensor(x) for x in (*tables, *_rays(41, 600, t_init=True, inactive=True))]
    t0, p0 = tpt.packet_traverse(*args)
    t1, p1, iters = tpt.packet_traverse(*args, 1e-4, False, True)
    assert torch.equal(t1, t0) and torch.equal(p1, p0)
    assert torch.equal(iters, tpt.packet_traverse_plain(*args)[2]) and int(iters.max()) > 1
    with pytest.raises(ValueError, match="sort_rays=False"):
        tpt.packet_traverse(*args, 1e-4, True, True)


def test_versions_and_leaf_kinds():
    """Sphere leaves take version 2 only, versions are 1, 2 or 3, and each
    (leaf kind, version) has its own launch count, as each of K2's modes
    (seeded, bf16 slabs, both)."""
    tables = [torch.as_tensor(x) for x in _sphere_tables(6, 50)]
    rays = [torch.as_tensor(x) for x in _rays(3, 16)]
    for version in (1, 3):
        with pytest.raises(ValueError, match="version 2"):
            tpt.packet_traverse(*tables, *rays, leaf_kind="sphere", version=version)
    with pytest.raises(ValueError, match="packet version"):
        tpt.packet_traverse(*tables, *rays, leaf_kind="sphere", version=4)
    assert set(tpt.KERNELS.values()) == {"k2", "k3", "k5a", "k5b"}
    assert set(tpt.MODES.values()) == {"k2r", "k2h", "k2rh"}
    assert set(tpt.traverse.launches) == set(tpt.KERNELS.values()) | set(tpt.MODES.values())


def test_plain_k3_matches_pallas():
    """Sphere leaves, with transparent spheres (the far root from inside),
    ``t_init`` seeding and inactive lanes."""
    tables = _sphere_tables(3, 300)
    rows = tables[2]
    c = np.stack([rows[:, k * 8:(k + 1) * 8] for k in range(3)], -1).reshape(-1, 3)
    r2 = rows[:, 24:32].reshape(-1)
    keep = np.isfinite(r2)
    ro, rd, ti, active = _rays(21, 1024, scale=6.0, t_init=True, inactive=True,
                               inside=(c[keep], np.sqrt(r2[keep])))
    tp, pp = _port(tables, ro, rd, ti, active, "sphere")
    tj, pj = _jax(tables, ro, rd, ti, active, "sphere")

    def explain(i):   # spheres only tie exactly
        return pp[i] >= 0 and pj[i] >= 0 and tp[i] == tj[i]

    assert _agree(tp, pp, tj, pj, explain, atol=2e-7) > 200


def _brute(tables, ro, rd, ti, active, leaf_kind):
    """Every run row against every ray, with the twin's leaf test."""
    nodes, entries, runs = (torch.tensor(x) for x in tables)
    codes = entries[:, :8].reshape(-1)
    codes = codes[(codes < 0) & (codes != int(_PAD))].numpy()
    start, count = decode_leaf(codes)
    rows, slots = [], []
    for s, c in zip(start, count):
        rows.append(s)
        slots.append(min(c, 8))
        if c > 8:
            rows.append(s + 1)
            slots.append(c - 8)
    ro_t, rd_t = torch.as_tensor(ro), torch.as_tensor(rd)
    t_best = torch.as_tensor(ti).clone()
    p_best = torch.full((len(ro),), -1, dtype=torch.int32)
    eps = torch.tensor(1e-4)
    for row, ns in zip(rows, slots):
        t_c, p_c = tpt._leaf_candidates(runs[row].expand(len(ro), 128),
                                        torch.full((len(ro),), ns), ro_t, rd_t, eps,
                                        leaf_kind)
        better = (t_c < t_best) | ((t_c == t_best) & (p_c >= 0) & (p_c < p_best))
        better &= torch.as_tensor(active)
        t_best = torch.where(better, t_c, t_best)
        p_best = torch.where(better, p_c, p_best)
    return t_best.numpy(), p_best.numpy()


@pytest.mark.parametrize("leaf_kind", ["tri", "sphere"])
def test_plain_matches_brute_force(leaf_kind):
    if leaf_kind == "tri":
        _, tables = _tri_tables(5, 200, 12)
    else:
        tables = _sphere_tables(6, 200)
    ro, rd, ti, active = _rays(7, 1500, t_init=True, inactive=True)
    tp, pp = _port(tables, ro, rd, ti, active, leaf_kind)
    tb, pb = _brute(tables, ro, rd, ti, active, leaf_kind)
    assert (pb >= 0).sum() > 100
    np.testing.assert_array_equal(pp, pb)
    np.testing.assert_array_equal(tp.view(np.int32), tb.view(np.int32))


def test_sorted_matches_jax():
    """``packet_traverse_sorted``: the same permutation, ``entered_n`` and
    carried payload as JAX; hits within the stated tolerance."""
    v, tables = _tri_tables(2, 250, 8)
    ro, rd, _, active = _rays(31, 1024, inactive=True)
    treelets = jpt.treelet_boxes(*tables[:2])
    tag = np.arange(1024, dtype=np.uint32) * 3
    jt_s, jp_s, jro, _, jn, jorder, (jtag,) = jpt.packet_traverse_sorted(
        *(jnp.asarray(x) for x in tables), jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(active), interpret=True, treelets=treelets, payload=(jnp.asarray(tag),))
    out = tpt.packet_traverse_sorted(
        *(torch.as_tensor(x) for x in tables), torch.as_tensor(ro), torch.as_tensor(rd),
        torch.as_tensor(active),
        treelets=tuple(torch.as_tensor(np.asarray(x)) for x in treelets),
        payload=(torch.as_tensor(tag.astype(np.int64)),))
    tt_s, tp_s, tro, _, tn, torder, (ttag,) = out
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(ttag.numpy(), np.asarray(jtag).astype(np.int64))
    np.testing.assert_array_equal(tro.numpy(), np.asarray(jro))
    order = torder.numpy()
    tp, pp, tj, pj = tt_s.numpy(), tp_s.numpy(), np.asarray(jt_s), np.asarray(jp_s)
    _agree(tp, pp, tj, pj, _tri_explain(v, ro[order], rd[order], tp, pp, tj, pj))
    # every hit lies in the entered prefix; inactive rays sort last and miss
    assert (np.flatnonzero(pp >= 0) < int(tn)).all()
    assert not (pp[~active[order]] >= 0).any()


def test_stack_overflow_and_backstop_raise():
    _, tables = _tri_tables(1, 200, 4)
    ro, rd, ti, active = _rays(1, 64)
    args = [torch.as_tensor(x) for x in (*tables, ro, rd, ti, active)]
    with pytest.raises(RuntimeError, match="stack overflow"):
        tpt.packet_traverse(*args, stack=2)
    # a node whose child is itself: the walk never ends
    nodes = np.zeros((1, 128), np.float32)
    nodes[0, :24] = -100.0
    nodes[0, 24:48] = 100.0
    entries = np.full((1, 128), _PAD, np.int32)
    entries[0, 0] = 0
    runs = np.zeros((1, 128), np.float32)
    loop = [torch.as_tensor(x) for x in (nodes, entries, runs)] + args[3:]
    with pytest.raises(RuntimeError, match="backstop"):
        tpt.packet_traverse(*loop, stack=8)


# ------------------------------------------- models of the kernels' schedules --
#
# Slow numpy models of what the CUDA kernels do, step for step, on small
# inputs; each is held to ``packet_traverse_plain`` bit for bit in
# ``(t, prim)``. The slab test is written out in float32 numpy (one rounding
# per operation, NaN-propagating min/max); the leaf arithmetic is the twin's
# ``_slot_candidates``, since the models check the schedules, not the roots.

_EPS = np.float32(1e-4)


def _tied_tables(leaf_kind, seed, count, max_leaf):
    """Tables in which every third primitive of the first half is repeated
    in the second half, so that rays meet exact ties in ``t`` between two
    prim ids (in different leaves)."""
    r = np.random.default_rng(seed)
    dup = np.arange(0, count // 2, 3)
    if leaf_kind == "tri":
        v0 = r.normal(size=(count, 3)).astype(np.float32) * 3
        v1 = v0 + r.normal(size=(count, 3)).astype(np.float32)
        v2 = v0 + r.normal(size=(count, 3)).astype(np.float32)
        for v in (v0, v1, v2):
            v[dup + count // 2] = v[dup]
        lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
        flat = j_build_bvh(lo, hi, centroid=(v0 + v1 + v2) / 3, max_depth=12,
                           max_leaf=max_leaf, backend="numpy")
        tables = jpt.pack_packet_tables(j_collapse(flat, max_run=max_leaf), v0, v1, v2)
    else:
        c = r.uniform(-6, 6, (count, 3)).astype(np.float32)
        rad = r.uniform(0.3, 1.4, count).astype(np.float32)
        tr = (r.uniform(size=count) < 0.3).astype(np.float32)
        c[dup + count // 2], rad[dup + count // 2] = c[dup], rad[dup]
        flat = j_build_bvh(c - rad[:, None], c + rad[:, None], centroid=c, max_depth=12,
                           max_leaf=max_leaf, backend="numpy")
        tables = jpt.pack_sphere_packet_tables(j_collapse(flat, max_run=max_leaf), c, rad, tr)
    return [np.asarray(x) for x in tables]


class _Walk:
    """State and steps shared by the schedule models: the rays' best hits,
    the slab test (``slab``: the hoisted form or v1's direct one) of one ray
    against a node's 8 children and the leaf test of some rays against one
    leaf run, folded by the tie rule."""

    def __init__(self, tables, ro, rd, ti, active, leaf_kind, slab="hoisted"):
        self.nodes, self.entries, self.runs = tables
        self.t_runs = torch.tensor(self.runs)
        self.ro, self.rd, self.active, self.leaf_kind = ro, rd, active, leaf_kind
        self.slab_form = slab
        with np.errstate(all="ignore"):
            self.inv = np.float32(1.0) / rd
            self.roinv = ro * self.inv
        self.t = ti.copy()
        self.p = np.full(len(ro), -1, np.int32)
        self.leaf_tests = []          # (ray, node, child) of every leaf test

    def slab(self, code, r):
        """``(entered bool[8], key f32[8])`` of ray ``r`` at node ``code``."""
        row = self.nodes[code]
        t0 = np.full(8, -np.inf, np.float32)
        t1 = np.full(8, np.inf, np.float32)
        with np.errstate(all="ignore"):
            for k in range(3):
                lo, hi = row[k * 8:(k + 1) * 8], row[(3 + k) * 8:(4 + k) * 8]
                if self.slab_form == "direct":
                    ta = (lo - self.ro[r, k]) * self.inv[r, k]
                    tc = (hi - self.ro[r, k]) * self.inv[r, k]
                else:
                    ta = lo * self.inv[r, k] - self.roinv[r, k]
                    tc = hi * self.inv[r, k] - self.roinv[r, k]
                t0 = np.maximum(t0, np.minimum(ta, tc))
                t1 = np.minimum(t1, np.maximum(ta, tc))
            hit = ((t1 > t0 - _EPS) & (t1 > 0) & (t0 < self.t[r] + _EPS)
                   & (self.entries[code, :8] != _PAD))
        return hit, np.maximum(t0, np.float32(0)) + np.float32(0)

    def slots(self, r, code):
        """Per-slot candidates ``[(t, prim)]`` (hits only) of ray ``r`` over
        the one or two rows of leaf run ``code``."""
        v = -(int(code) + 1)
        row, count = v // 64, v % 64
        out = []
        for extra in range(2):
            if count > 8 * extra:
                t, pid, ok = tpt._slot_candidates(
                    self.t_runs[row + extra][None], torch.tensor([count - 8 * extra]),
                    torch.as_tensor(self.ro[r])[None], torch.as_tensor(self.rd[r])[None],
                    torch.tensor(1e-4), self.leaf_kind)
                out += [(np.float32(a), int(b)) for a, b, c in
                        zip(t[0].numpy(), pid[0].numpy(), ok[0].numpy()) if c]
        return out

    def split_slots(self, r, code):
        """The split triangle leaf (measured on the card and dropped: exact,
        but slower than the unsplit test) in float32 numpy, one rounding an
        operation: per half row, ``t`` of four slots from the plane
        coefficients; only a slot with ``t > eps`` and ``t <= `` the ray's
        best ``t`` goes on to its barycentric weights, and a hit is folded
        at once (so a later slot meets the new best)."""
        v = -(int(code) + 1)
        row, count = v // 64, v % 64
        o, d = self.ro[r], self.rd[r]

        def dot(a, x, y, z):
            return (a[0] * x + a[1] * y) + a[2] * z

        for extra in range(2):
            nslots = min(count - 8 * extra, 8)
            run = self.runs[row + extra] if nslots > 0 else None
            for h in range(2):
                if 4 * h >= nslots:
                    break
                n0, n1, n2, dd = (run[k * 8 + 4 * h:k * 8 + 4 * h + 4] for k in range(4))
                with np.errstate(all="ignore"):
                    t = (dd - dot(o, n0, n1, n2)) / dot(d, n0, n1, n2)
                for q in range(4):
                    j = 4 * h + q
                    if not (j < nslots and t[q] > _EPS and t[q] <= self.t[r]):
                        continue
                    g = [run[(4 + k) * 8 + j] for k in range(8)]
                    with np.errstate(all="ignore"):
                        w1 = (dot(o, *g[0:3]) + t[q] * dot(d, *g[0:3])) + g[3]
                        w2 = (dot(o, *g[4:7]) + t[q] * dot(d, *g[4:7])) + g[7]
                        w3 = (np.float32(1) - w1) - w2
                    if w1 > 0 and w2 > 0 and w3 > 0:
                        self.fold(r, (t[q], int(run[96 + j])))

    def fold(self, r, cand):
        t, p = cand
        if t < self.t[r] or (t == self.t[r] and p < self.p[r]):
            self.t[r], self.p[r] = t, p

    def test_leaf(self, r, node, child):
        self.leaf_tests.append((r, node, child))
        for cand in self.slots(r, self.entries[node, child]):
            self.fold(r, cand)

    def check_leaf_tests(self):
        """Every leaf test was of a box the ray's own slab test admits
        (whatever its best hit was then)."""
        saved, self.t = self.t, np.full_like(self.t, np.inf)
        for r, node, child in self.leaf_tests:
            assert self.slab(node, r)[0][child], (r, node, child)
        self.t = saved


def _ranged_walk(walk, stack, lanes, warps, detach, drain, seed=0):
    """A ranged packet walk on packets of ``warps`` warps of ``lanes`` rays:
    a shared stack whose entries carry the range of warps that entered and
    each warp's lane mask; node children that at most ``detach`` warps
    entered go onto those warps' private stacks, with the warp's own key and
    mask. A private stack is walked by its warp alone: after every shared
    pop (``drain='eager'``), when it could overflow and at the end
    (``'deferred'``), or at random (``'random'``). Leaves are tested at
    their parent's pop, nearest first, by the lanes that entered them.
    K5b is ``detach=warps``: below the root every warp walks alone (sharing
    more of the walk was measured on the card and only cost time); the
    smaller thresholds show that the result does not depend on how much of
    the walk a packet shares. Returns the pops of each ray's packet plus
    its warp's own."""
    rng = np.random.default_rng(seed)
    n = len(walk.ro)
    pcap = stack if drain == "eager" else 3 * stack + 8
    pops = np.zeros(n, np.int32)

    def node_step(rays, code, mine):
        """The warp's entered lanes ``cmask bool[8, lanes]`` and least keys
        ``ckey f32[8]`` per child, leaf children tested."""
        ent = walk.entries[code, :8]
        cmask = np.zeros((8, len(rays)), bool)
        ckey = np.full(8, np.inf, np.float32)
        for li in np.flatnonzero(mine):
            hit, key = walk.slab(code, rays[li])
            cmask[:, li] = hit
            ckey = np.where(hit, np.minimum(ckey, key), ckey)
        leaves = [c for c in range(8) if cmask[c].any() and ent[c] < 0]
        for c in sorted(leaves, key=lambda c: (ckey[c], c)):
            for li in np.flatnonzero(cmask[c]):
                if ckey[c] < walk.t[rays[li]] + _EPS:
                    walk.test_leaf(rays[li], code, c)
        return cmask, ckey

    def push(st, children):
        """Nearest (ties: the lowest slot) on top."""
        st.extend(e for _, _, e in sorted(children, key=lambda x: (x[0], x[1]), reverse=True))

    for base in range(0, n, lanes * warps):
        idx = np.arange(base, min(base + lanes * warps, n))
        rays_of = [idx[w * lanes:(w + 1) * lanes] for w in range(warps)]
        own_pops = [0] * warps

        def drain_private(w):
            st, rays = private[w], rays_of[w]
            while st:
                own_pops[w] += 1
                code, key, mask = st.pop()
                mine = mask & (key < walk.t[rays] + _EPS)
                if not mine.any():
                    continue
                cmask, ckey = node_step(rays, code, mine)
                ent = walk.entries[code, :8]
                push(st, [(ckey[c], c, (int(ent[c]), ckey[c], cmask[c]))
                          for c in range(8) if cmask[c].any() and ent[c] >= 0])
                assert len(st) <= pcap

        shared = [(0, np.float32(0), 0, warps, [walk.active[r] for r in rays_of])]
        private = [[] for _ in range(warps)]
        shared_pops = 0
        while shared:
            shared_pops += 1
            code, key, lo, hi, masks = shared.pop()
            table = []
            for w, rays in enumerate(rays_of):
                mine = masks[w] & (key < walk.t[rays] + _EPS) & (lo <= w < hi)
                table.append(node_step(rays, code, mine) if mine.any() else
                             (np.zeros((8, len(rays)), bool), np.full(8, np.inf, np.float32)))
            ent = walk.entries[code, :8]
            to_shared, to_private = [], [[] for _ in range(warps)]
            for c in range(8):
                ws = [w for w in range(warps) if table[w][0][c].any()]
                if not ws or ent[c] < 0:
                    continue
                if len(ws) <= detach:
                    for w in ws:
                        to_private[w].append((table[w][1][c], c,
                                              (int(ent[c]), table[w][1][c], table[w][0][c])))
                else:
                    kb = min(table[w][1][c] for w in ws)
                    to_shared.append((kb, c, (int(ent[c]), kb, ws[0], ws[-1] + 1,
                                              [table[w][0][c] for w in range(warps)])))
            push(shared, to_shared)
            assert len(shared) <= stack
            for w in range(warps):
                push(private[w], to_private[w])
                assert len(private[w]) <= pcap
                now = {"eager": True, "deferred": len(private[w]) + 8 + stack > pcap,
                       "random": rng.random() < 0.5}[drain]
                if private[w] and now:
                    drain_private(w)
        for w in range(warps):
            drain_private(w)
            pops[rays_of[w]] = shared_pops + own_pops[w]
    return pops


def _model_case(leaf_kind, max_leaf, n=96, seed=0, slab="hoisted", axis=0):
    """Tables with tied primitives, rays aimed into them (some with a
    ``t_init`` in front of their hit, some inactive), the twin's result
    (with slab form ``slab``) and the tables' stack bound. The first
    ``axis`` rays run exactly along +z from below the figure."""
    count = 160
    tables = _tied_tables(leaf_kind, 30 + seed + max_leaf, count, max_leaf)
    r = np.random.default_rng(50 + seed)
    ro = (r.normal(size=(n, 3)) * 6).astype(np.float32)
    rd = (r.normal(size=(n, 3)) * 1.5 - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro[:axis] = np.concatenate([r.uniform(0.2, 3, (axis, 2)), np.full((axis, 1), -20.0)], 1)
    rd[:axis] = [0, 0, 1]
    ti = np.where(r.uniform(size=n) < 0.3, r.uniform(1, 8, n), np.inf).astype(np.float32)
    active = r.uniform(size=n) < 0.8
    ti[:axis], active[:axis] = np.inf, True
    twin = tpt.packet_traverse_plain(*(torch.tensor(x) for x in tables), torch.tensor(ro),
                                     torch.tensor(rd), torch.tensor(ti), torch.tensor(active),
                                     leaf_kind=leaf_kind, slab=slab)
    t, p, it = (x.numpy() for x in twin)
    # the case has hits, hits on repeated primitives (exact ties, the lower
    # prim id winning), rays that keep their t_init and inactive rays
    tied = np.arange(0, count // 2, 3)
    assert (p >= 0).sum() > n // 4 and np.isin(p, tied).sum() > 2
    assert not np.isin(p, tied + count // 2).any()
    assert ((p < 0) & np.isfinite(ti) & active).any() and not active.all()
    return tables, (ro, rd, ti, active), (t, p, it), tpt.stack_cap(tables[1])


@pytest.mark.parametrize("drain", ["eager", "deferred", "random"])
@pytest.mark.parametrize("detach", [1, 2, 8])
@pytest.mark.parametrize("lanes,warps,max_leaf", [(4, 4, 4), (2, 8, 12), (8, 2, 8)])
def test_ranged_walk_schedule_is_the_twin(lanes, warps, max_leaf, detach, drain):
    """The ranged packet walk (K5b's per-warp stacks below the root, and the
    shared stack with warp ranges above whatever is detached) gives the
    twin's ``(t, prim)`` bit for bit whenever the private work runs and
    however many warps an entry may have to be detached; no lane tests a
    leaf its own slab test did not enter; the stacks stay within the
    tables' bound."""
    tables, rays, (t, p, _), stack = _model_case("tri", max_leaf)
    walk = _Walk(tables, *rays, "tri")
    pops = _ranged_walk(walk, stack, lanes, warps, detach, drain, seed=lanes + detach)
    np.testing.assert_array_equal(walk.p, p)
    np.testing.assert_array_equal(walk.t.view(np.int32), t.view(np.int32))
    walk.check_leaf_tests()
    assert (pops[rays[3]] > 0).all()


def _butterfly(cands):
    """The least ``(t, prim)`` of up to 8 lanes' candidates by xor-shuffle
    steps 1, 2, 4, as a group of lanes would reduce them; None if no lane
    has one."""
    lanes = (cands + [(np.float32(np.inf), np.iinfo(np.int32).max)] * 8)[:8]
    for m in (1, 2, 4):
        lanes = [min(lanes[j], lanes[j ^ m]) for j in range(8)]
    assert len(set(lanes)) == 1
    return lanes[0] if cands else None


def _ray_pop(walk, r, st, fold):
    """One pop of K2/K3's schedule for ray ``r`` with stack ``st``: drop a
    stale entry, slab the 8 children, then the kernel's selection loops: the
    entered leaves by repeatedly taking the least key (the first such slot),
    each skipped if its key is no longer below the best hit; the entered
    nodes pushed by repeatedly taking the greatest key (the last such slot),
    so that the nearest, lowest slot ends on top. ``fold``: a leaf's slots
    folded into the best hit one by one (``'serial'``, the kernels': K3 four
    slots to a load, K2 two), reduced first across lanes (``'butterfly'``),
    or by the split triangle test (``'split'``): the tie rule makes them
    equal."""
    code, key = st.pop()
    if not key < walk.t[r] + _EPS:
        return
    hit, keys = walk.slab(code, r)
    ent = walk.entries[code, :8]
    leaves = [c for c in range(8) if hit[c] and ent[c] < 0]
    inner = [c for c in range(8) if hit[c] and ent[c] >= 0]
    while leaves:
        bc = leaves[0]
        for c in leaves:
            if keys[c] < keys[bc]:
                bc = c
        leaves.remove(bc)
        if not keys[bc] < walk.t[r] + _EPS:
            continue
        walk.leaf_tests.append((r, code, bc))
        if fold == "split":
            walk.split_slots(r, ent[bc])
            continue
        cands = walk.slots(r, ent[bc])
        if fold == "butterfly":
            best = _butterfly(cands[:8])
            cands = ([best] if best else []) + cands[8:]
        for cand in cands:
            walk.fold(r, cand)
    while inner:
        bc = inner[0]
        for c in inner:
            if keys[c] >= keys[bc]:
                bc = c
        inner.remove(bc)
        st.append((int(ent[bc]), keys[bc]))


def _ray_walk(walk, stack, fold):
    """K2/K3's schedule, one ray at a time (``_ray_pop`` until the stack is
    empty). Returns each ray's pops."""
    pops = np.zeros(len(walk.ro), np.int32)
    for r in np.flatnonzero(walk.active):
        st = [(0, np.float32(0))]
        while st:
            pops[r] += 1
            _ray_pop(walk, r, st, fold)
            assert len(st) <= stack
    return pops


@pytest.mark.parametrize("leaf_kind,max_leaf,fold", [
    (k, m, f) for f in ("serial", "butterfly")
    for k, m in (("tri", 4), ("tri", 12), ("sphere", 8), ("sphere", 12))]
    + [("tri", 4, "split"), ("tri", 12, "split")])
def test_ray_walk_schedule_is_the_twin(leaf_kind, max_leaf, fold):
    """K2/K3's schedule (the selection loops in place of the twin's stable
    sort) gives the twin's ``(t, prim)`` and pops bit for bit, on tables
    with exact ties, fat leaves, ``t_init`` and inactive rays."""
    tables, rays, (t, p, it), stack = _model_case(leaf_kind, max_leaf, seed=3)
    walk = _Walk(tables, *rays, leaf_kind)
    pops = _ray_walk(walk, stack, fold)
    np.testing.assert_array_equal(walk.p, p)
    np.testing.assert_array_equal(walk.t.view(np.int32), t.view(np.int32))
    np.testing.assert_array_equal(pops, it)
    walk.check_leaf_tests()


def _edge_leaf_tables(prims):
    """Tables of one root whose only child is a leaf run over unit right
    triangles in planes ``z = d``: ``prims`` lists ``(prim id, d)`` per slot
    (``d = None``: a degenerate triangle, all coefficients 0). On the ray
    ``(x, y, 0) + t (0, 0, 1)`` a slot's ``t`` is ``d`` and its weights are
    ``x``, ``y`` and ``1 - x - y``."""
    nodes = np.zeros((1, 128), np.float32)
    nodes[0, 0:24:8], nodes[0, 24:48:8] = -100.0, 100.0
    entries = np.full((1, 128), _PAD, np.int32)
    entries[0, 0] = -(0 * 64 + len(prims) + 1)
    runs = np.zeros((-(-len(prims) // 8), 128), np.float32)
    runs[:, 24:32] = np.inf                      # empty slots: plane at infinity
    for s, (pid, d) in enumerate(prims):
        row, j = runs[s // 8], s % 8
        row[96 + j] = pid
        row[24 + j] = 0.0
        if d is not None:
            row[16 + j], row[24 + j], row[32 + j], row[72 + j] = 1.0, d, 1.0, 1.0
    return [nodes, entries, runs]


@pytest.mark.parametrize("order", ["as listed", "reversed"])
def test_split_leaf_edge_slots_are_the_twin(order):
    """The split triangle leaf on the slots where its first pass decides: an
    equal ``t`` with a smaller prim id (it must go on and win), a degenerate
    triangle (``t`` NaN), ``t`` exactly ``eps`` and ``t`` equal to ``t_init``
    (no hit), nearer slots after farther ones, a spill row, and rays on an
    edge (a weight of +0 or -0: no hit)."""
    eps = float(_EPS)
    prims = [(9, 5.0), (7, 3.0), (3, 3.0), (11, None), (5, eps), (8, 4.0), (2, 6.0), (6, 3.0),
             (1, 3.5), (4, 3.0), (0, 7.0)]
    tables = _edge_leaf_tables(prims[::-1] if order == "reversed" else prims)
    xy = np.array([[0.25, 0.25], [0.0, 0.3], [-0.0, 0.3], [0.3, 0.0], [0.3, -0.0], [0.5, 0.5],
                   [0.25, 0.25], [0.25, 0.25], [0.25, 0.25], [2.0, 2.0]], np.float32)
    ro = np.concatenate([xy, np.zeros((len(xy), 1), np.float32)], 1)
    rd = np.tile(np.array([[0, 0, 1]], np.float32), (len(xy), 1))
    ti = np.full(len(xy), np.inf, np.float32)
    ti[6], ti[7], ti[8] = 3.0, 3.25, eps          # equal to the hit, behind it, at eps
    active = np.ones(len(xy), bool)
    t, p, it = (x.numpy() for x in tpt.packet_traverse_plain(
        *(torch.tensor(x) for x in tables), torch.tensor(ro), torch.tensor(rd),
        torch.tensor(ti), torch.tensor(active), slab="direct"))
    # the twin: the tie goes to prim 3; edges, t_init == t and t_init == eps keep no prim
    np.testing.assert_array_equal(p, [3, -1, -1, -1, -1, -1, -1, 3, -1, -1])
    np.testing.assert_array_equal(t[[0, 7]], np.float32([3.0, 3.0]))
    walk = _Walk(tables, ro, rd, ti, active, "tri", slab="direct")
    pops = _ray_walk(walk, 8, "split")
    np.testing.assert_array_equal(walk.p, p)
    np.testing.assert_array_equal(walk.t.view(np.int32), t.view(np.int32))
    np.testing.assert_array_equal(pops, it)


def _warp_walk(walk, stack, lanes, push_leaves):
    """K5a's and K5b's schedule: each warp of ``lanes`` rays walks a stack of
    its own whose entries are (code, least key of the lanes that entered,
    their mask). A node pop slab-tests its 8 children for the lanes of the
    mask whose best hit still admits the entry; the entered children are
    ranked by (key, slot) and pushed, the nearest on top. Leaf children are
    tested at their parent's pop, nearest first, by the lanes that entered
    them (K5a and K5b), or pushed with the nodes and tested at their own pop
    (``push_leaves``: v1's schedule, measured and dropped). Returns each
    ray's warp's pops."""
    n = len(walk.ro)
    pops = np.zeros(n, np.int32)
    for base in range(0, n, lanes):
        rays = np.arange(base, min(base + lanes, n))
        st = [(0, np.float32(0), walk.active[rays].copy())] if walk.active[rays].any() else []
        while st:
            pops[rays] += 1
            code, key, mask = st.pop()
            mine = mask & (key < walk.t[rays] + _EPS)
            if not mine.any():
                continue
            if code < 0:
                for li in np.flatnonzero(mine):
                    for cand in walk.slots(rays[li], code):
                        walk.fold(rays[li], cand)
                continue
            ent = walk.entries[code, :8]
            cmask = np.zeros((8, len(rays)), bool)
            ckey = np.full(8, np.inf, np.float32)
            for li in np.flatnonzero(mine):
                hit, k = walk.slab(code, rays[li])
                cmask[:, li] = hit
                ckey = np.where(hit, np.minimum(ckey, k), ckey)
            entered = [c for c in range(8) if cmask[c].any()]
            if not push_leaves:
                for c in sorted((c for c in entered if ent[c] < 0), key=lambda c: (ckey[c], c)):
                    for li in np.flatnonzero(cmask[c]):
                        if ckey[c] < walk.t[rays[li]] + _EPS:
                            walk.test_leaf(rays[li], code, c)
            pushed = [c for c in entered if push_leaves or ent[c] >= 0]
            for c in sorted(pushed, key=lambda c: (ckey[c], c), reverse=True):
                if ent[c] < 0:
                    walk.leaf_tests += [(rays[li], code, c) for li in np.flatnonzero(cmask[c])]
                st.append((int(ent[c]), ckey[c], cmask[c]))
            assert len(st) <= stack
    return pops


@pytest.mark.parametrize("push_leaves", [False, True])
@pytest.mark.parametrize("lanes,max_leaf", [(4, 4), (32, 12), (8, 8)])
def test_direct_warp_walk_schedule_is_the_twin(lanes, max_leaf, push_leaves):
    """The warp walk with v1's slab form ``(lo - ro)*inv`` (K5a), leaves
    inline or pushed, gives the twin's ``(t, prim)`` with ``slab='direct'``
    bit for bit, hits axis-parallel rays that the hoisted form misses, tests
    no leaf a lane's own slab test did not enter and stays within the
    tables' ``stack_cap``."""
    axis = 24
    tables, rays, (t, p, _), stack = _model_case("tri", max_leaf, seed=5, slab="direct",
                                                 axis=axis)
    hoisted = tpt.packet_traverse_plain(*(torch.tensor(x) for x in tables),
                                        *(torch.tensor(x) for x in rays))[1].numpy()
    assert (p[:axis] >= 0).sum() > 2 and (hoisted[:axis] < 0).all()
    walk = _Walk(tables, *rays, "tri", slab="direct")
    pops = _warp_walk(walk, stack, lanes, push_leaves)
    np.testing.assert_array_equal(walk.p, p)
    np.testing.assert_array_equal(walk.t.view(np.int32), t.view(np.int32))
    walk.check_leaf_tests()
    assert (pops[rays[3]] > 0).all()


def _refetch_walk(walk, stack, lanes, warps, below, seed):
    """The per-ray walk by persistent warps that refetch (measured on the
    card and dropped): ``warps`` warps of ``lanes`` lanes share a counter of
    the next ray; whenever fewer than ``below`` lanes of a warp are still
    walking, its idle lanes store their finished ray and take the next rays
    from the counter. The warps step in a random order, so the rays reach
    the lanes in a random order. Each ray walks alone (``_ray_pop``) with
    its lane's stack. Returns each ray's pops and how often it was
    stored."""
    rng = np.random.default_rng(seed)
    n = len(walk.ro)
    pops, stored = np.zeros(n, np.int32), np.zeros(n, np.int32)
    counter = 0
    ray = np.full((warps, lanes), -1)
    stacks = [[[] for _ in range(lanes)] for _ in range(warps)]
    exhausted, done = [False] * warps, [False] * warps
    while not all(done):
        w = rng.choice([w for w in range(warps) if not done[w]])
        walking = [bool(st) for st in stacks[w]]
        if sum(walking) < below:
            idle = [li for li in range(lanes) if not walking[li]]
            for li in idle:
                if ray[w, li] >= 0:
                    stored[ray[w, li]] += 1
                    ray[w, li] = -1
            if not exhausted[w]:
                base, counter = counter, counter + len(idle)
                exhausted[w] = base + len(idle) >= n
                for k, li in enumerate(idle):
                    if base + k < n:
                        ray[w, li] = base + k
                        if walk.active[base + k]:
                            stacks[w][li].append((0, np.float32(0)))
            if exhausted[w] and not any(stacks[w]):
                done[w] = True
                for li in range(lanes):
                    if ray[w, li] >= 0:
                        stored[ray[w, li]] += 1
                continue
        for li in range(lanes):
            if stacks[w][li]:
                pops[ray[w, li]] += 1
                _ray_pop(walk, ray[w, li], stacks[w][li], "serial")
                assert len(stacks[w][li]) <= stack
    return pops, stored


@pytest.mark.parametrize("leaf_kind,max_leaf", [("tri", 12), ("sphere", 8)])
@pytest.mark.parametrize("lanes,warps,below", [(4, 3, 1), (8, 2, 5), (4, 5, 4), (32, 1, 20)])
def test_refetch_schedule_is_the_twin(lanes, warps, below, leaf_kind, max_leaf):
    """Whatever the fetch order and the threshold, every ray is fetched and
    stored once and its ``(t, prim, pops)`` are the twin's bit for bit."""
    tables, rays, (t, p, it), stack = _model_case(leaf_kind, max_leaf, seed=2)
    walk = _Walk(tables, *rays, leaf_kind)
    pops, stored = _refetch_walk(walk, stack, lanes, warps, below, seed=lanes + below)
    assert (stored == 1).all()
    np.testing.assert_array_equal(walk.p, p)
    np.testing.assert_array_equal(walk.t.view(np.int32), t.view(np.int32))
    np.testing.assert_array_equal(pops, it)
