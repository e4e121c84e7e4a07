"""Card-only tests of the port (marker ``gpu``): they skip where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(from the root of the checkout: the bench tests import ``bench_torch``).

Tolerances: the sphere-scan kernel (K1, at the frame's pass widths and
every slice count, ties included), the packet-traversal kernels (K2
triangle leaves, its seeded and bf16 modes K2r, K2h and K2rh, K3 sphere
leaves; ``hit(backend='bvh')`` through K3 equals K1's hits), the bounce megakernel (K4, all lanes and a late sparse lane
list), the row gathers (K6a, K6b: fill rows and bf16 compared as bits) and
the legacy BSDF (K7; an l11 frame through it equals the plain body's)
equal their plain twins bit for bit (the same IEEE-rounded operations in the same
order, and an order-free tie rule); a GPU render, persistent (modular or
mega) or hybrid, equals a rerun bit for bit (fixed-point accumulation), and
under each pool knob the auto render; a
GPU render agrees with the CPU render within
``utils.checks.render_agreement``'s bounds (the transcendental functions of
the two devices differ by ulps).

Whole paths (the stages, the viewer's engines, the packet versions and the
environment knobs on the stand-in world of ``models.standin``) launch each
kernel once per call of the layer it replaces: the traversal kernels once
per traversal call, K6a and K6b as the shading calls imply
(``chip_smoke.expected_gathers``), K7 once per legacy BSDF call.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from learn_path_tracing_tpu_torch.accel import build_bvh, collapse
from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_legacy, scatter_legacy_plain
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.integrator.persistent import (bounce_pass_plain, card_schedule,
                                                                mega_pass, render_persistent)
from learn_path_tracing_tpu_torch.io.obj import MeshData
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.models.standin import (STANDIN_SEED, build_quiet, sphere_world,
                                                          standin_asset_tree, standin_assets,
                                                          standin_camera, standin_mesh,
                                                          standin_world)
from learn_path_tracing_tpu_torch.ops import bounce_megakernel as tmk
from learn_path_tracing_tpu_torch.ops import kernel_counters
from learn_path_tracing_tpu_torch.ops import legacy_scatter as tls
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.ops import row_gather as trg
from learn_path_tracing_tpu_torch.ops import sphere_scan as tss
from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
from learn_path_tracing_tpu_torch.utils.checks import render_agreement
from learn_path_tracing_tpu_torch.utils.profiling import recording

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _setup(seed, n, s, device):
    r = np.random.default_rng(seed)
    ro = (r.normal(size=(n, 3)) * 2).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    centers = (r.normal(size=(s, 3)) * 3).astype(np.float32)
    radii = r.uniform(0.05, 1.0, size=s).astype(np.float32)
    radii[::13] = 0.0                                   # padding rows
    transparency = (r.uniform(size=s) < 0.3).astype(np.float32)
    attrs = r.normal(size=(s, 16)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    table = tss.pack_spheres(t(centers), t(radii), t(transparency))
    return t(ro), t(rd.astype(np.float32)), table, t(attrs)


# ray counts off the 256-thread block; sphere counts inside one shared-memory
# chunk and across two (1024 spheres per chunk)
@pytest.mark.parametrize("n,s", [(1, 1), (1000, 512), (5000, 1500)])
def test_kernel_matches_twin_bitwise(cuda, n, s):
    args = _setup(n + s, n, s, cuda)
    before = tss.intersect_spheres_scan.launches
    t, idx, attr = tss.intersect_spheres_scan(*args)
    assert tss.intersect_spheres_scan.launches == before + 1
    t2, idx2, attr2 = tss.intersect_spheres_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
    assert torch.equal(idx, idx2) and torch.equal(attr, attr2)


def _tied(seed, n, s, device):
    """``_setup`` with every third sphere of the first half duplicated in the
    second half, so that rays meet exact ties across slices."""
    ro, rd, table, attrs = _setup(seed, n, s, device)
    dup = torch.arange(0, s // 2, 3, device=device)
    table[dup + s // 2] = table[dup]
    return ro, rd, table, attrs


def _same_scan(got, want):
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))


# the frame's pass widths (57,344 full, drains 7,168 / 1,024 / 256) and
# counts off the 32-ray groups; sphere counts of one shared-memory chunk,
# of two (1,152), and ones the slice counts do not divide (300, 1,000)
@pytest.mark.parametrize("n", [1, 255, 257, 7168, 57344])
@pytest.mark.parametrize("s", [128, 300, 512, 1000, 1152])
def test_scan_kernel_at_pass_widths_matches_twin_bitwise(cuda, n, s):
    args = _tied(n * 7 + s, n, s, cuda)
    got = tss.intersect_spheres_scan(*args)
    assert _same_scan(got, tss.intersect_spheres_scan_plain(*args))


@pytest.mark.parametrize("slices", tss.SLICE_CHOICES)
@pytest.mark.parametrize("s", [300, 1152])
def test_scan_kernel_every_slice_count_matches_twin_bitwise(cuda, slices, s):
    args = _tied(slices + s, 1000, s, cuda)
    got = tss._launch(*args, tss.T_MIN, slices)
    assert _same_scan(got, tss.intersect_spheres_scan_plain(*args))


def test_hit_bvh_on_the_card_is_the_scan(cuda):
    """``hit(backend='bvh')`` walks the sphere BVH through K3 on the card and
    gives K1's hits bit for bit (primary rays of the cover scene)."""
    from learn_path_tracing_tpu_torch.camera.camera import generate_rays_for_pixels
    from learn_path_tracing_tpu_torch.scene.world import hit

    res = (96, 54)
    wd = random_scene(seed=20230328).device(cuda, use_bvh=True)
    pixel = torch.arange(res[0] * res[1], device=cuda)
    rays = generate_rays_for_pixels(stage10_camera(res).params(cuda), res, pixel, 0, 0)
    before = tpt.traverse.launches["k3"]
    a, b = hit(wd, rays, backend="bvh"), hit(wd, rays, backend="auto")
    assert tpt.traverse.launches["k3"] == before + 1
    torch.cuda.synchronize()
    assert bool(a.hit.any()) and torch.equal(a.obj, b.obj)
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
    assert torch.equal(a.normal.view(torch.int32), b.normal.view(torch.int32))


def test_kernel_rejects_non_contiguous(cuda):
    ro, rd, table, attrs = _setup(0, 64, 32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tss.intersect_spheres_scan(ro, rd.t().contiguous().t(), table, attrs)


def test_gpu_render_is_deterministic_and_matches_cpu(cuda):
    res = (48, 27)
    world = random_scene(seed=20230328)
    cam = stage10_camera(res)
    runs = [render_persistent(world.device(cuda), cam.params(cuda), res, spp=4, limit=8)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    cpu_img, cpu_segs = render_persistent(world.device("cpu"), cam.params("cpu"), res,
                                          spp=4, limit=8)
    rep = render_agreement(runs[0][0].cpu().numpy(), cpu_img.numpy(), runs[0][1], cpu_segs)
    assert rep["ok"], rep


def _packet_tables(leaf_kind, seed, count, max_leaf):
    r = np.random.default_rng(seed)
    if leaf_kind == "tri":
        v0 = (r.normal(size=(count, 3)) * 3).astype(np.float32)
        v1 = v0 + r.normal(size=(count, 3)).astype(np.float32)
        v2 = v0 + r.normal(size=(count, 3)).astype(np.float32)
        lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
        wide = collapse(build_bvh(lo, hi, centroid=(v0 + v1 + v2) / 3, max_depth=16,
                                  max_leaf=max_leaf), max_run=max_leaf)
        return tpt.pack_packet_tables(wide, v0, v1, v2)
    c = r.uniform(-6, 6, (count, 3)).astype(np.float32)
    rad = r.uniform(0.1, 0.8, count).astype(np.float32)
    tr = (r.uniform(size=count) < 0.3).astype(np.float32)
    wide = collapse(build_bvh(c - rad[:, None], c + rad[:, None], centroid=c, max_depth=12,
                              max_leaf=max_leaf), max_run=max_leaf)
    return tpt.pack_sphere_packet_tables(wide, c, rad, tr)


def _packet_rays(n, device):
    r = np.random.default_rng(n)
    ro = (r.normal(size=(n, 3)) * 5).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t_init = np.where(r.uniform(size=n) < 0.3, r.uniform(1, 10, n), np.inf).astype(np.float32)
    active = r.uniform(size=n) < 0.8
    return [torch.as_tensor(x, device=device) for x in (ro, rd, t_init, active)]


# ray counts off K2's and K3's 128-thread blocks and the 32-ray packets of
# K5a and K5b (1, 7, 9, 255, 257, 2,048); fat leaves (runs of 12 and 16: two
# rows, the second part or all filled) of both leaf kinds, and thin ones (4).
# Versions 1 and 3 (K5a, K5b) report their packet's pops, so their iters are
# not compared.
@pytest.mark.parametrize("leaf_kind,count,max_leaf,n,version", [
    ("tri", 1, 4, 1, 2), ("tri", 3000, 8, 5000, 2), ("tri", 2000, 12, 3001, 2),
    ("sphere", 5000, 8, 5000, 2), ("sphere", 700, 12, 777, 2),
    ("tri", 1, 4, 1, 1), ("tri", 3000, 8, 5000, 1), ("tri", 2000, 12, 3001, 1),
    ("tri", 1, 4, 1, 3), ("tri", 3000, 8, 5000, 3), ("tri", 2000, 12, 3001, 3),
    ("sphere", 1, 8, 1, 2), ("sphere", 900, 8, 7, 2), ("sphere", 900, 12, 9, 2),
    ("sphere", 900, 12, 255, 2), ("sphere", 900, 8, 257, 2), ("sphere", 3000, 12, 2048, 2),
    ("tri", 900, 12, 7, 2), ("tri", 900, 12, 9, 2), ("tri", 900, 8, 255, 2),
    ("tri", 900, 12, 257, 2), ("tri", 3000, 12, 2048, 2),
    ("tri", 900, 12, 7, 3), ("tri", 900, 12, 9, 3), ("tri", 900, 8, 255, 3),
    ("tri", 900, 12, 257, 3), ("tri", 3000, 12, 2048, 3),
    ("tri", 900, 12, 7, 1), ("tri", 900, 12, 9, 1), ("tri", 900, 8, 255, 1),
    ("tri", 900, 12, 257, 1), ("tri", 3000, 12, 2048, 1),
    ("tri", 900, 4, 255, 2), ("tri", 3000, 16, 2048, 2), ("tri", 3000, 16, 2048, 1)])
def test_packet_kernel_matches_twin_bitwise(cuda, leaf_kind, count, max_leaf, n, version):
    tables = [torch.as_tensor(x, device=cuda)
              for x in _packet_tables(leaf_kind, count + n, count, max_leaf)]
    args = _packet_rays(n, cuda)
    kernel = tpt.KERNELS[(leaf_kind, version)]
    before = dict(tpt.traverse.launches)
    t, p, it = tpt.traverse(*tables, *args, leaf_kind=leaf_kind, version=version)
    assert tpt.traverse.launches[kernel] == before[kernel] + 1
    t2, p2, it2 = tpt.packet_traverse_plain(*tables, *args, leaf_kind=leaf_kind,
                                            slab=tpt.SLABS[version])
    torch.cuda.synchronize()
    assert torch.equal(t.view(torch.int32), t2.view(torch.int32))
    assert torch.equal(p, p2)
    assert version != 2 or torch.equal(it, it2)
    assert n < 10 or bool((p >= 0).any())


def _cluster_tables():
    """600 small triangles around the origin: the top two BVH levels full,
    so blocks of coherent rays are seeded (``tests/test_torch_k2_modes.py``'s
    'full tree')."""
    r = np.random.default_rng(0)
    v0 = r.normal(size=(600, 3)).astype(np.float32) * 3
    v1 = v0 + r.normal(size=(600, 3)).astype(np.float32) * 0.3
    v2 = v0 + r.normal(size=(600, 3)).astype(np.float32) * 0.3
    lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
    wide = collapse(build_bvh(lo, hi, centroid=(v0 + v1 + v2) / 3, max_depth=12, max_leaf=4,
                              backend="numpy"), max_run=4)
    return tpt.pack_packet_tables(wide, v0, v1, v2)


def _beam_rays(n, device):
    """Two narrow beams into the cluster, each entering at most 3 treelets."""
    r = np.random.default_rng(n + 1)
    half = n // 2
    ro = np.float32([[5.0, 40.0, 3.0]] * half + [[4.0, 40.0, 5.0]] * (n - half))
    rd = np.float32([0.0, -40.0, 0.0]) + r.normal(size=(n, 3)).astype(np.float32) * np.where(
        np.arange(n)[:, None] < half, 0.01, 0.05).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    active = r.uniform(size=n) < 0.9
    return [torch.as_tensor(x, device=device) for x in (ro, rd.astype(np.float32), active)]


# box values at the edges of K2h's bf16 arithmetic: signed zeros, f32 and
# bf16 subnormals, the smallest normal, values about -/+bf(3e38) and the
# largest finite bf16, and the infinities
_EDGE_BOUNDS = np.float32([0.0, -0.0, 1e-39, -1e-39, 1e-45, -1e-45, 1.1754944e-38, 3e38,
                           -3e38, 3.3895314e38, -3.3895314e38, np.inf, -np.inf])


def _edge_case(tables, n, device):
    """The bf16 risks: a node table in which a tenth of the box values are
    widened to ``_EDGE_BOUNDS`` (each lo the least, each hi the greatest of
    its value and an edge value, so every box still bounds its triangles),
    and rays that are axis-parallel (1/rd = +/-inf), with -0 and +0
    direction components, from origins with zero components (ro/rd = 0*inf
    = NaN) or in the beams; ``t_init`` (for a call of ``traverse``) mixes
    +inf, -inf and finite values."""
    r = np.random.default_rng(n + 7)
    nodes = tables[0].cpu().numpy().copy()
    box = nodes[:, :48]
    edge = r.choice(_EDGE_BOUNDS, size=box.shape)
    widened = np.concatenate([np.minimum(box[:, :24], edge[:, :24]),
                              np.maximum(box[:, 24:], edge[:, 24:])], axis=1)
    nodes[:, :48] = np.where(r.uniform(size=box.shape) < 0.1, widened, box)
    ro, rd, active = (x.cpu().numpy() for x in _beam_rays(n, "cpu"))
    axis = r.integers(3, size=n)
    k = np.arange(n)
    rd_a = np.zeros((n, 3), np.float32)
    rd_a[k, axis] = np.where(r.uniform(size=n) < 0.5, -1.0, 1.0)
    rd_a[k, (axis + 1) % 3] = np.where(r.uniform(size=n) < 0.5, -0.0, 0.0)
    ro_a = (r.normal(size=(n, 3)) * 3).astype(np.float32)
    ro_a[k, (axis + 2) % 3] = np.where(r.uniform(size=n) < 0.5, 0.0, ro_a[k, (axis + 2) % 3])
    pick = (k % 3)[:, None]
    ro = np.where(pick == 0, ro, ro_a).astype(np.float32)
    rd = np.where(pick == 0, rd, np.where(pick == 1, rd_a, -rd_a)).astype(np.float32)
    t_init = np.where(k % 5 == 0, -np.inf, np.where(k % 5 == 1, r.uniform(0, 30, n),
                                                    np.inf)).astype(np.float32)
    out = [torch.as_tensor(nodes, device=device), *tables[1:]]
    return out, [torch.as_tensor(x, device=device) for x in (ro, rd, active)], t_init


@pytest.mark.parametrize("rays", ["beams", "edges"])
@pytest.mark.parametrize("restart,bf16", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("n", [1, 1023, 5000])
def test_k2_modes_match_twin_bitwise(cuda, monkeypatch, restart, bf16, n, rays):
    """K2r (seeded from each ray's own treelets, ``packet_traverse_sorted(
    restart=True)``'s ``RaySeeds``), K2h (bf16 node slabs, packed bf16x2)
    and K2rh: bit for bit their plain twin in ``(t, prim, iters)``, each
    counted under its own name; on the beams K2r is also bit for bit the
    root walk in ``(t, prim)``. ``edges``: the bf16 risks of
    ``_edge_case``; there a ray from ``ro = 0`` along a zero direction
    component has NaN slab terms (``0 * inf``), which reject every box of
    the root walk, while its seeds skip the top two levels and test a leaf
    treelet at once, so K2r may hit what the root walk misses."""
    tables = [torch.as_tensor(x, device=cuda) for x in _cluster_tables()]
    ro, rd, active = _beam_rays(n, cuda)
    t_init = None
    if rays == "edges":
        tables, (ro, rd, active), t_init = _edge_case(tables, n, cuda)
    if bf16:
        tables[0] = tpt.nodes_to_bf16(tables[0]).to(cuda)
    kernel = tpt.kernel_of("tri", 2, restart, bf16)
    seen = {}
    walk = tpt.traverse

    def capture(*args, seeds=None, **kw):
        seen["args"], seen["seeds"] = args, seeds
        return walk(*args, seeds=seeds, **kw)

    capture.launches, capture.lanes = walk.launches, walk.lanes
    monkeypatch.setattr(tpt, "traverse", capture)
    out = tpt.packet_traverse_sorted(*tables, ro, rd, active, restart=restart)
    monkeypatch.undo()
    args, seeds = list(seen["args"]), seen["seeds"]
    if t_init is not None:
        args[5] = torch.as_tensor(t_init, device=cuda)
    launches = dict(tpt.traverse.launches)
    t, p, it = tpt.traverse(*args, seeds=seeds)
    assert tpt.traverse.launches[kernel] == launches[kernel] + 1
    t2, p2, it2 = tpt.packet_traverse_plain(*[x.cpu() for x in args],
                                            seeds=None if seeds is None else seeds.to("cpu"))
    assert torch.equal(t.cpu().view(torch.int32), t2.view(torch.int32))
    assert torch.equal(p.cpu(), p2) and torch.equal(it.cpu(), it2)
    if restart and not bf16 and rays == "beams":
        root = tpt.packet_traverse_sorted(*tables, ro, rd, active)
        assert torch.equal(out[0], root[0]) and torch.equal(out[1], root[1])
    if restart and n == 5000:
        assert bool(((seeds.counts() <= 8) & args[6]).any())


@pytest.mark.parametrize("knobs", [{"pool_mult": 1}, {"pool_div": 2},
                                   {"drain_unroll": 4, "drain_ratio": 2}])
def test_pool_knobs_on_the_card_are_the_auto_frame(cuda, knobs):
    """The modular engine under each schedule knob on the card: the auto
    frame bit for bit, with its segments; K1 once per pass (its launches
    through ``kernel_counters``, which count a CUDA graph's replays)."""
    wd = random_scene(seed=20230328).device(cuda)
    cp = stage10_camera((64, 36)).params(cuda)
    ref, ref_segs = render_persistent(wd, cp, (64, 36), spp=4, limit=8)
    img, segs, st = render_persistent(wd, cp, (64, 36), spp=4, limit=8, stats=True, **knobs)
    assert segs == ref_segs and torch.equal(img.view(torch.int32), ref.view(torch.int32))
    assert st["kernels"]["k1"]["launches"] == st["passes_full"] + sum(st["drain_passes"])


def test_auto_pool_on_the_card_is_the_card_rule(cuda):
    """On the card the modular engine's auto pool is the card's rule: the
    stats report ``pool_rule == 'card'`` and ``card_schedule``'s pool and
    drain widths. The frame is the frame under a pool override near the JAX
    rule's pool (``pool_div=16``) bit for bit, with its segments; K1 once
    per pass under each."""
    wd = random_scene(seed=20230328).device(cuda)
    res = (64, 36)
    cp = stage10_camera(res).params(cuda)
    frames = {}
    for name, knobs in (("card", {}), ("override", {"pool_div": 16})):
        frames[name] = render_persistent(wd, cp, res, spp=4, limit=8, stats=True, **knobs)
        st = frames[name][2]
        assert st["pool_rule"] == name
        assert st["kernels"]["k1"]["launches"] == st["passes_full"] + sum(st["drain_passes"])
    (img, segs, st), (ref, ref_segs, ref_st) = frames["card"], frames["override"]
    want = card_schedule(res[0] * res[1], 4)
    assert (st["pool"], st["drain_widths"]) == (want.pool, want.drain_widths) == (
        4 * res[0] * res[1], (1280, 256))
    assert ref_st["pool"] == 144
    assert segs == ref_segs and torch.equal(img.view(torch.int32), ref.view(torch.int32))


def test_packet_kernels_on_axis_parallel_rays(cuda):
    """Rays along +z into a mesh in the positive x, y quadrant: K5a (v1's
    slab form) hits them, K2 and K5b (the hoisted form) miss them, each
    equal to its twin."""
    r = np.random.default_rng(60)
    v0 = (r.uniform(1, 5, (60, 3)) * [1, 1, 2]).astype(np.float32)
    v1 = v0 + r.uniform(0.3, 1.0, (60, 3)).astype(np.float32) * [1, 0, 0.2]
    v2 = v0 + r.uniform(0.3, 1.0, (60, 3)).astype(np.float32) * [0, 1, 0.2]
    lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
    wide = collapse(build_bvh(lo, hi, centroid=(v0 + v1 + v2) / 3, max_leaf=4), max_run=4)
    tables = [torch.as_tensor(x, device=cuda) for x in tpt.pack_packet_tables(wide, v0, v1, v2)]
    cent = (v0 + v1 + v2) / 3
    ro = np.concatenate([cent[:, :2], np.full((60, 1), -5.0)], 1).astype(np.float32)
    rd = np.tile(np.array([[0, 0, 1]], np.float32), (60, 1))
    args = [torch.as_tensor(x, device=cuda) for x in
            (ro, rd, np.full(60, np.inf, np.float32), np.ones(60, bool))]
    hits = {}
    for version in (1, 2, 3):
        t, p, _ = tpt.traverse(*tables, *args, version=version)
        t2, p2, _ = tpt.packet_traverse_plain(*tables, *args, slab=tpt.SLABS[version])
        assert torch.equal(t.view(torch.int32), t2.view(torch.int32)) and torch.equal(p, p2)
        hits[version] = int((p >= 0).sum())
    assert hits[1] == 60 and hits[2] == hits[3] == 0


@pytest.mark.parametrize("version", [1, 2, 3])
def test_packet_kernel_raises_on_stack_overflow(cuda, version):
    tables = [torch.as_tensor(x, device=cuda) for x in _packet_tables("tri", 5, 3000, 4)]
    ro = torch.zeros((64, 3), device=cuda)
    rd = torch.nn.functional.normalize(torch.ones((64, 3), device=cuda), dim=-1)
    t_init = torch.full((64,), float("inf"), device=cuda)
    active = torch.ones((64,), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="stack overflow"):
        tpt.traverse(*tables, ro, rd, t_init, active, stack=2, version=version)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_packet_kernel_raises_on_backstop(cuda, version):
    """A node whose child is itself: the walk ends at the pop backstop."""
    nodes = np.zeros((1, 128), np.float32)
    nodes[0, :24], nodes[0, 24:48] = -100.0, 100.0
    entries = np.full((1, 128), -(1 << 30), np.int32)
    entries[0, 0] = 0
    tables = [torch.as_tensor(x, device=cuda) for x in (nodes, entries,
                                                        np.zeros((1, 128), np.float32))]
    with pytest.raises(RuntimeError, match="backstop"):
        tpt.traverse(*tables, *_packet_rays(64, cuda), stack=8, version=version)


@pytest.mark.parametrize("version", [1, 3])
def test_packet_walk_sizes_its_stack_by_stack_cap(cuda, version):
    """K5a and K5b keep their stacks in shared memory sized by ``stack``, so
    a bound above K2's ``MAX_STACK`` runs (and gives the twin's hits), also
    where the stacks need more than the default 48 KB a block; K2 refuses
    it."""
    tables = [torch.as_tensor(x, device=cuda) for x in _packet_tables("tri", 11, 2000, 8)]
    args = _packet_rays(3001, cuda)
    t2, p2, _ = tpt.packet_traverse_plain(*tables, *args, slab=tpt.SLABS[version])
    for stack in (tpt.MAX_STACK + 44, 1000):
        t, p, _ = tpt.traverse(*tables, *args, stack=stack, version=version)
        torch.cuda.synchronize()
        assert torch.equal(t.view(torch.int32), t2.view(torch.int32)) and torch.equal(p, p2)
    with pytest.raises(ValueError, match="holds"):
        tpt.traverse(*tables, *args, stack=tpt.MAX_STACK + 44, version=2)


def _hybrid_world():
    """A quad mesh under two spheres (one transparent) with a missing
    texture's fill and an environment, built: the hybrid tests' world."""
    world = LegacyWorld()
    world.add_mesh(MeshData(
        positions=np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
        normals=np.array([[0, 1, 0]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32), face_n=np.zeros((2, 3), np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32), face_tex=np.zeros(2, np.int32)))
    world.add_sphere((0, 1, 0), 0.8)
    world.add_sphere((1.5, 0.6, 0.5), 0.6, transparency=1)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    return world


def _hybrid_camera(res):
    cam = Camera(res)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    return cam


def test_legacy_world_wavefront_takes_no_graph(cuda):
    """The wavefront integrator on a legacy (mesh) world keeps its eager
    loop on the card: its traversal reads K2's error word on every call,
    so no CUDA graph is captured or replayed."""
    from learn_path_tracing_tpu_torch.integrator.wavefront import render

    res = (48, 27)
    _, segs, st = render(_hybrid_world().device(cuda), _hybrid_camera(res).params(cuda), res,
                         4, limit=8, bsdf="legacy", scene="legacy", stats=True)
    assert st["graph"] == {"captures": 0, "replays": 0}
    assert st["passes"] > 0 and segs > 0 and st["kernels"]["k2"]["launches"] > 0


def test_gpu_hybrid_is_deterministic_and_matches_cpu(cuda):
    world = _hybrid_world()
    res = (48, 27)
    cam = _hybrid_camera(res)
    runs = [render_hybrid(world.device(cuda), cam.params(cuda), res, spp=4, limit=8)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    cpu_img, cpu_segs = render_hybrid(world.device("cpu"), cam.params("cpu"), res, spp=4,
                                      limit=8)
    rep = render_agreement(runs[0][0].cpu().numpy(), cpu_img.numpy(), runs[0][1], cpu_segs)
    assert rep["ok"], rep


# a pass from the primary state and one after six passes, at a size off the
# 256-thread block (48x27 = 1,296 lanes)
@pytest.mark.parametrize("passes", [0, 6])
def test_bounce_megakernel_matches_twin_bitwise(cuda, passes):
    res, spp = (48, 27), 4
    wd = random_scene(seed=20230328).device(cuda)
    cp = stage10_camera(res).params(cuda)
    scalf = tmk.pack_camera(cp, res)
    stf, sti = tmk.initial_state(cp, res, spp, 0)
    for _ in range(passes):
        stf, sti, _ = bounce_pass_plain(stf, sti, wd, scalf, 0, res, spp, limit=8)
    accs = [torch.zeros((res[0] * res[1], 3), dtype=torch.int64, device=cuda) for _ in range(2)]
    before = tmk.bounce_pass.launches
    k_stf, k_sti = stf.clone(), sti.clone()
    lanes = tmk.LaneList.of_state(k_stf, k_sti)
    mega_pass(k_stf, k_sti, wd, scalf, 0, res, spp, lanes, limit=8, acc=accs[0])
    assert tmk.bounce_pass.launches == before + 1
    p_stf, p_sti, p_live = bounce_pass_plain(stf, sti, wd, scalf, 0, res, spp, limit=8,
                                             acc=accs[1])
    torch.cuda.synchronize()
    assert torch.equal(k_stf.view(torch.int32), p_stf.view(torch.int32))
    assert torch.equal(k_sti, p_sti) and lanes.advance() == int(p_live)
    assert torch.equal(accs[0], accs[1])


def test_bounce_megakernel_late_sparse_list_matches_twin_bitwise(cuda):
    """K4 from a late state (under a tenth of the lanes alive) over its
    sparse lane list, in place, for two passes: every row, the deposits and
    the live counts equal the plain all-lanes pass's, and the next list
    holds the lanes alive after the pass first, then those that died in
    it."""
    res, spp, limit = (48, 27), 4, 8
    n = res[0] * res[1]
    wd = random_scene(seed=20230328).device(cuda)
    cp = stage10_camera(res).params(cuda)
    scalf = tmk.pack_camera(cp, res)
    stf, sti = tmk.initial_state(cp, res, spp, 0)
    live = n
    while live >= n // 10:
        stf, sti, live_t = bounce_pass_plain(stf, sti, wd, scalf, 0, res, spp, limit=limit)
        live = int(live_t)
    assert live > 0
    lanes = tmk.LaneList.of_state(stf, sti)
    k_stf, k_sti = stf.clone(), sti.clone()
    for _ in range(2):
        accs = [torch.zeros((n, 3), dtype=torch.int64, device=cuda) for _ in range(2)]
        alive_in = set(lanes.lanes[:lanes.alive].tolist())
        before = tmk.bounce_pass.launches
        mega_pass(k_stf, k_sti, wd, scalf, 0, res, spp, lanes, limit=limit, acc=accs[0])
        assert tmk.bounce_pass.launches == before + 1
        stf, sti, p_live = bounce_pass_plain(stf, sti, wd, scalf, 0, res, spp, limit=limit,
                                             acc=accs[1])
        torch.cuda.synchronize()
        assert torch.equal(k_stf.view(torch.int32), stf.view(torch.int32))
        assert torch.equal(k_sti, sti) and torch.equal(accs[0], accs[1])
        live = lanes.advance()
        assert live == int(p_live)
        listed = lanes.lanes[:lanes.count].tolist()
        assert set(listed) == alive_in and len(listed) == len(alive_in)
        alive_after = stf[tmk.ALIVE] > 0.5
        assert bool(alive_after[lanes.lanes[:live].long()].all())
        assert not bool(alive_after[lanes.lanes[live:lanes.count].long()].any())


def test_gpu_mega_is_deterministic_and_matches_cpu(cuda):
    res = (48, 27)
    world = random_scene(seed=20230328)
    cam = stage10_camera(res)
    before = tmk.bounce_pass.launches
    runs = [render_persistent(world.device(cuda), cam.params(cuda), res, spp=4, limit=8,
                              engine="mega", stats=True) for _ in range(2)]
    assert tmk.bounce_pass.launches - before == 2 * runs[0][2]["passes"]
    assert runs[0][1] == runs[1][1] and torch.equal(runs[0][0], runs[1][0])
    cpu_img, cpu_segs = render_persistent(world.device("cpu"), cam.params("cpu"), res,
                                          spp=4, limit=8, engine="mega")
    rep = render_agreement(runs[0][0].cpu().numpy(), cpu_img.numpy(), runs[0][1], cpu_segs)
    assert rep["ok"], rep


# widths (in elements) through every K6a vector count and K6b's one- and
# two-step rows: f32 4..32 (16..128 B), 36 (144 B), 252 (1,008 B, the
# environment pair row), bf16 8 and 256 (the material pair row), i32 4
# (the strip atlas's info row)
@pytest.mark.parametrize("dtype,width", [
    (torch.float32, 4), (torch.float32, 12), (torch.float32, 20), (torch.float32, 28),
    (torch.float32, 32), (torch.float32, 36), (torch.float32, 252),
    (torch.bfloat16, 8), (torch.bfloat16, 256), (torch.int32, 4), (torch.int32, 64)])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
def test_row_gather_kernels_match_plain_bitwise(cuda, dtype, width, index):
    """K6a/K6b against ``gather_plain`` bit for bit, on in-range, wrapping
    and out-of-range indices (fill rows), at counts off the warp groups."""
    r = np.random.default_rng(width)
    rows = 1000
    if dtype == torch.int32:
        tab = torch.tensor(r.integers(-2**31, 2**31, (rows, width)).astype(np.int32))
    else:
        tab = torch.tensor(r.normal(size=(rows, width)).astype(np.float32)).to(dtype)
    tab = tab.to(cuda)
    for n in (1, 7, 1001, 20000):
        idx = r.integers(-rows, rows, n)
        idx[::5] = r.integers(rows, 3 * rows, len(idx[::5]))
        idx[1::9] = -rows - 1 - r.integers(0, 100, len(idx[1::9]))
        idx = torch.tensor(idx).to(index).to(cuda)
        kernel = trg.kernel_for(tab)
        before = trg.gather.launches[kernel]
        got = trg.gather(tab, idx)
        assert trg.gather.launches[kernel] == before + 1
        ref = trg.gather_plain(tab, idx)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), ref.view(bits))
    assert trg.gather(tab, idx[:0]).shape == (0, width)


def test_row_gather_kernel_rejects_misaligned(cuda):
    tab = torch.zeros((9, 16), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        trg.gather(tab.view(-1)[1:129].view(8, 16), torch.zeros(4, dtype=torch.int64,
                                                                  device=cuda))


# ------------------------------------ the bench, l11, l12 and the utilities --

@pytest.mark.parametrize("engine", ["persistent", "mega"])
def test_bench_cell_launches_one_kernel_per_pass(cuda, engine):
    """``bench_torch.run_cell`` at 64x36 on the card: the engine's kernel (K1
    for the modular engine, K4 for the mega engine) launches once per hit
    call or pass of every render the cell made, warm-up included (through
    ``kernel_counters``, which count a CUDA graph's replays), and the two
    engines give the same segments and image bit for bit."""
    import bench_torch

    rows = {}
    for name in ("persistent", "mega"):
        before = _launches()
        rows[name] = bench_torch.run_cell(engine=name, resolution=(64, 36), spp=4, limit=8,
                                          device=cuda)
        launches = tuple(_launches()[k] - before[k] for k in ("k1", "k4"))
        calls = sum(rows[name]["calls"])
        assert launches == ((calls, 0) if name == "persistent" else (0, calls))
    row = rows[engine]
    assert row["card"] != "cpu" and len(row["frames"]) == 3 and row["value"] > 0
    assert rows["persistent"]["segments"] == rows["mega"]["segments"]
    assert torch.equal(rows["persistent"]["image"].view(torch.int32),
                       rows["mega"]["image"].view(torch.int32))


def _passes(fn):
    """``(fn(), passes, k1, k3)``: the wavefront bounce passes ``fn()`` ran,
    eager or replayed from a CUDA graph (its ``lpt.wavefront.pass`` spans),
    and its K1 and K3 launches (``kernel_counters``, which count a replay's)."""
    from learn_path_tracing_tpu_torch.integrator import wavefront as twf

    with recording(True, "test", kernel_counters) as table:
        out = fn()
    k1, k3 = (table.kernels.get(k, {"launches": 0})["launches"] for k in ("k1", "k3"))
    return out, table.spans.get(twf.PASS_SPAN, [0])[0], k1, k3


def test_l11_bvh_equals_auto_bitwise(cuda, tmp_path):
    from learn_path_tracing_tpu_torch.stages import l11_bvh

    args = ["--width", "64", "--height", "36", "--spp", "4", "--limit", "8"]
    reps = {}
    for backend in ("auto", "bvh"):
        (_, reps[backend]), passes, k1, k3 = _passes(lambda: l11_bvh.main(
            args + ["--hit-backend", backend, "--out", str(tmp_path / f"{backend}.png")]))
        assert passes > 0 and (k1, k3) == ((passes, 0) if backend == "auto" else (0, passes))
    assert reps["auto"]["segments"] == reps["bvh"]["segments"]
    assert torch.equal(reps["auto"]["linear"].view(torch.int32),
                       reps["bvh"]["linear"].view(torch.int32))


def test_l12_walks_the_sphere_bvh_only(cuda, tmp_path, monkeypatch):
    from learn_path_tracing_tpu_torch.stages import l12_free_view

    monkeypatch.chdir(tmp_path)
    (frame, rep), passes, k1, k3 = _passes(lambda: l12_free_view.main(
        ["--width", "64", "--height", "36", "--spp", "4", "--limit", "8",
         "--script", "w,.,."]))
    assert rep["spp"] == [4, 8, 12]
    assert k1 == 0
    assert k3 == passes > 0
    assert torch.isfinite(frame).all()


def test_device_smoke_test_on_the_card(cuda):
    from learn_path_tracing_tpu_torch.utils.checks import device_smoke_test

    assert device_smoke_test()


def test_checked_trace_around_a_card_render(cuda):
    """A cover-scene render on the card makes no NaN that a later op masks
    (K1 runs outside the dispatcher); a masked NaN on the card raises."""
    from learn_path_tracing_tpu_torch.utils.checks import checked_trace

    world, cam = random_scene(seed=20230328), stage10_camera((32, 18))
    img, segs = checked_trace(render_persistent, world.device(cuda), cam.params(cuda), (32, 18),
                              spp=4, limit=8)
    ref, ref_segs = render_persistent(world.device(cuda), cam.params(cuda), (32, 18), spp=4,
                                      limit=8)
    assert segs == ref_segs and torch.equal(img, ref)
    x = torch.ones(8, device=cuda)
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        checked_trace(lambda v: torch.nan_to_num(torch.sqrt(v - 2.0)), x)


def test_nccl_world_size_one_sharded_hybrid_equals_render_hybrid(cuda):
    """``render_hybrid_multichip`` over an NCCL group of one rank on the
    card: bit for bit ``render_hybrid``'s frame, the same segments, and the
    traversal kernel (K2) launched once per traversal call."""
    import torch.distributed as dist

    from learn_path_tracing_tpu_torch.parallel import launch, mesh
    from learn_path_tracing_tpu_torch.parallel.dryrun import RES, legacy_mini_world

    world, cam = legacy_mini_world()
    wd, cp = world.device(cuda), cam.params(cuda)
    ref, ref_segs = render_hybrid(wd, cp, RES, spp=8, limit=8)
    launch.init_group(0, 1, cuda, port=launch.free_port())
    try:
        m = mesh.make_mesh(1, 1)
        tpt.traverse.launches.update(dict.fromkeys(tpt.traverse.launches, 0))
        img, segs = mesh.render_hybrid_multichip(wd, cp, RES, 8, m, limit=8)
        assert tpt.traverse.launches["k2"] > 0
    finally:
        dist.destroy_process_group()
    assert segs == ref_segs and torch.equal(img, ref)


def test_viewer_loop_serves_a_frame_on_the_card(cuda):
    import urllib.request
    from http.server import ThreadingHTTPServer

    from learn_path_tracing_tpu_torch.viewer import serve

    args = serve.parse_args(["--scene-size", "1", "--width", "64", "--height", "36",
                             "--spp", "2", "--limit", "4"])
    pr, cam, _ = serve.setup(args)
    assert pr.device.type == "cuda"
    state = serve.ViewerState()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve._make_handler(state))
    got = []

    def on_frame(frames):
        r = urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/frame.png",
                                   timeout=10)
        got.append((r.status, r.headers["X-Gen"], r.read()[:4]))

    tss.intersect_spheres_scan.launches = 0
    assert serve.serve(pr, cam, srv, state, max_frames=1, on_frame=on_frame) == 1
    assert got == [(200, "1", b"\x89PNG")] and tss.intersect_spheres_scan.launches > 0


@pytest.mark.parametrize("walk", ["traverse", "traverse_wide"])
def test_lockstep_walk_on_the_card_matches_cpu(cuda, walk):
    """``accel.traverse.traverse`` / ``accel.wide.traverse_wide`` with the
    triangle leaf test on ``cuda`` tensors against the same call on the
    CPU, on a small triangle soup: hit masks equal, ``t`` within rtol 1e-5
    / atol 1e-6 (the devices' f32 roundings may differ by an ulp), ``prim``
    equal where the two nearest triangles are not tied within that bound.
    The walks are plain PyTorch on either device: no kernel counts."""
    from learn_path_tracing_tpu_torch.accel.traverse import make_triangle_leaf_test, traverse
    from learn_path_tracing_tpu_torch.accel.wide import traverse_wide
    from learn_path_tracing_tpu_torch.geometry.triangle import triangle_t

    r = np.random.default_rng(31)
    v = [r.normal(size=(400, 3)).astype(np.float32) * 4]
    v += [v[0] + r.normal(size=(400, 3)).astype(np.float32) for _ in range(2)]
    ro = (r.normal(size=(3000, 3)) * 4).astype(np.float32)
    rd = (v[0][r.integers(0, 400, 3000)] + r.normal(size=(3000, 3)) - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    flat = build_bvh(np.minimum(np.minimum(*v[:2]), v[2]), np.maximum(np.maximum(*v[:2]), v[2]),
                     centroid=(v[0] + v[1] + v[2]) / 3, max_depth=12, max_leaf=4)
    fn, tree = (traverse, flat) if walk == "traverse" else (traverse_wide, collapse(flat))
    before = dict(tpt.traverse.launches)
    out = {}
    for dev in ("cpu", cuda):
        vt = [torch.as_tensor(x, device=dev) for x in v]
        t, p = fn(tree, torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev),
                  make_triangle_leaf_test(*vt))
        out[dev] = (t.cpu(), p.cpu())
    assert tpt.traverse.launches == before
    (t_c, p_c), (t_g, p_g) = out["cpu"], out[cuda]
    hit = torch.isfinite(t_c)
    assert torch.equal(torch.isfinite(t_g), hit) and int(hit.sum()) > 300
    assert torch.allclose(t_g[hit], t_c[hit], rtol=1e-5, atol=1e-6)
    t_all = triangle_t(*(torch.as_tensor(x)[None] for x in v), torch.as_tensor(ro)[:, None],
                       torch.as_tensor(rd)[:, None])
    second = torch.sort(t_all, dim=1).values[:, 1]
    untied = hit & ~torch.isclose(second, t_c, rtol=1e-5, atol=1e-6)
    assert torch.equal(p_g[untied], p_c[untied]) and torch.equal(p_g[~hit], p_c[~hit])


# ------------------------------------ whole paths: launches and frames --

def _launches():
    """Every kernel's launch count, by kernel, a CUDA graph's replays
    included (``kernel_counters``)."""
    return {k: c["launches"] for k, c in kernel_counters().items()}


def _counted(fn):
    """``(fn(), launches, shading)``: the kernels ``fn()`` launched, those
    launched at all, and its shading calls (``chip_smoke.shading_calls``)."""
    before = _launches()
    with chip_smoke.shading_calls() as shading:
        out = fn()
    return out, {k: n - before[k] for k, n in _launches().items() if n != before[k]}, shading


def _only(launches, **want):
    """The launches are ``want`` on the named kernels and none on any other."""
    assert launches == {k: n for k, n in want.items() if n}, (launches, want)


@pytest.fixture(scope="module")
def standin_file(tmp_path_factory):
    """The stand-in world at level 3, built, and saved as ``.world.npy``
    beside its texture set and EXR: ``(world, path)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    d = tmp_path_factory.mktemp("standin")
    world = standin_world(str(d), level=3, tex_size=64, env_size=(128, 64))
    build_quiet(world)
    path = str(d / "standin.world.npy")
    world.save(path)
    return world, path


def _load(path, device):
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map

    with warnings.catch_warnings():
        warnings.simplefilter("error")          # its PBR set and EXR must load
        return LegacyWorld().load(path, path_map=make_asset_path_map(os.path.dirname(path)),
                                  device=device)


def test_gpu_bf16_standin_hybrid_matches_cpu(cuda, tmp_path, monkeypatch):
    """The stand-in mesh built under ``LPT_PACKET_BF16=1`` through
    ``render_hybrid``: K2h is the traversal kernel on the card, and the
    card's frame agrees with the CPU's (K2h's twin) by
    ``render_agreement``."""
    world = standin_world(str(tmp_path), level=3, tex_size=256, env_size=(256, 128))
    monkeypatch.setenv("LPT_PACKET_BF16", "1")
    build_quiet(world)
    monkeypatch.delenv("LPT_PACKET_BF16")
    res = (64, 36)
    cam = standin_camera(res)
    (img, segs), launches, _ = _counted(
        lambda: render_hybrid(world.device(cuda), cam.params(cuda), res, spp=4, limit=8))
    assert launches.get("k2h", 0) > 0 and not {"k2", "k2r", "k2rh"} & launches.keys()
    cpu_img, cpu_segs = render_hybrid(world.device("cpu"), cam.params("cpu"), res, spp=4,
                                      limit=8)
    rep = render_agreement(img.cpu().numpy(), cpu_img.numpy(), segs, cpu_segs)
    assert rep["ok"], rep


@pytest.mark.parametrize("version", [1, 3])
def test_l14_versions_on_the_card_are_version_2s_frame(cuda, standin_file, tmp_path, version):
    """Stage l14 on the saved stand-in (64x36, 8 spp, depth 8) under packet
    version 2 and ``version``: every asset loads; the version's kernel (K2,
    K5a, K5b) launches once per traversal call (slabs plus pool passes),
    K6a and K6b as the shading calls imply, K7 once per legacy BSDF call,
    nothing else; the segments and linear image are version 2's bit for
    bit."""
    from learn_path_tracing_tpu_torch.stages import l14_mesh

    world, path = standin_file
    reps = {}
    for v in (2, version):
        (_, rep), launches, shading = _counted(lambda: l14_mesh.main([
            "--world", path, "--width", "64", "--height", "36", "--spp", "8", "--limit", "8",
            "--device", cuda, "--packet-version", str(v), "--out", str(tmp_path / f"{v}.png")]))
        assert not rep["load_warnings"] and not rep["env_gradient"]
        _only(launches, **{tpt.KERNELS["tri", v]: rep["n_chunks"] + rep["passes"]},
              k7=shading["scatter"], **chip_smoke.expected_gathers(world.device("cpu"), shading))
        reps[v] = rep
    assert shading["scatter"] > 0 and reps[version]["segments"] == reps[2]["segments"]
    assert torch.equal(reps[version]["linear"].view(torch.int32),
                       reps[2]["linear"].view(torch.int32))


@pytest.mark.parametrize("version", [1, 2, 3])
def test_viewer_wavefront_on_the_card_agrees_with_hybrid(cuda, standin_file, version):
    """The viewer's wavefront engine (``hit_legacy`` per bounce pass) on the
    stand-in (64x36, 4 spp, depth 10) under each packet version: the
    version's kernel is the only traversal kernel, K6a and K6b launch as the
    shading calls imply and K7 once per legacy BSDF call, as under the
    hybrid engine; the frame agrees with the hybrid engine's by
    ``render_agreement``."""
    from learn_path_tracing_tpu_torch.viewer.progressive import ProgressiveRenderer

    world, _ = standin_file
    res = (64, 36)

    def frame(engine, v):
        wd = world.device(cuda, packet_version=v)
        pr = ProgressiveRenderer(wd, standin_camera(res), res, spp_per_frame=4, limit=10,
                                 camera_model="jitter", engine=engine)
        _, launches, shading = _counted(lambda: pr.render(moved=True))
        walks = {k: launches.pop(k) for k in list(launches) if k in tpt.traverse.launches}
        _only(launches, k7=shading["scatter"], **chip_smoke.expected_gathers(wd, shading))
        img = (pr.acc / pr.spp).reshape(res[0], res[1], 3).cpu().numpy()
        return img, pr.last_stats["segments"], walks

    ref, ref_segs, _ = frame("hybrid", 2)
    img, segs, walks = frame("wavefront", version)
    assert list(walks) == [tpt.KERNELS["tri", version]]
    rep = render_agreement(img, ref, segs, ref_segs)
    assert rep["ok"], rep


def test_l13_on_the_card_matches_cpu(cuda, tmp_path):
    """Stage l13 (a textured sphere under the environment, the wavefront
    integrator) on the stand-in's texture set and EXR under the reference's
    names, at 64x36, 4 spp, depth 10: every asset loads; K6a and K6b launch
    as the shading calls imply (K6b at least once) and K7 once per legacy
    BSDF call; the card's frame agrees with the CPU's by
    ``render_agreement``."""
    from learn_path_tracing_tpu_torch.stages import l13_texture

    standin_assets(str(tmp_path), STANDIN_SEED, 64, (128, 64))
    tex = tmp_path / "textures"
    tex.mkdir()
    for name in ("albedo", "roughness", "metallic", "normal"):
        (tex / f"sandyground1_{name}.png").symlink_to(tmp_path / f"standin_{name}.png")
    (tex / "cayley_interior_2k.exr").symlink_to(tmp_path / "standin_env.exr")
    argv = ["--assets", str(tmp_path), "--width", "64", "--height", "36", "--spp", "4",
            "--limit", "10"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # the PBR set and the EXR must load
        (_, rep), launches, shading = _counted(lambda: l13_texture.main(
            argv + ["--device", cuda, "--out", str(tmp_path / "card.png")]))
        _, cpu = l13_texture.main(argv + ["--device", "cpu", "--out", str(tmp_path / "cpu.png")])
    want = {**chip_smoke.expected_gathers(rep["world"], shading), "k7": shading["scatter"]}
    assert not rep["env_gradient"] and want["k6b"] > 0
    assert {k: launches.get(k, 0) for k in want} == want
    agree = render_agreement(rep["linear"].cpu().numpy(), cpu["linear"].numpy(),
                             rep["segments"], cpu["segments"])
    assert agree["ok"], agree


def test_legacy_persistent_pool_on_the_card(cuda, standin_file, monkeypatch):
    """The stand-in through the modular persistent engine
    (``scene='legacy'``, as ``l14 --engine persistent`` runs it) at 160x190,
    2 spp, depth 4: the JAX package's legacy auto pool of ``n`` lanes, K2
    once per pass, K6a and K6b as the shading calls imply, K7 once per
    legacy BSDF call, nothing else; under the sphere rule's narrower pool
    the same launches per pass and the same frame bit for bit."""
    import learn_path_tracing_tpu_torch.integrator.persistent as tpers

    world, _ = standin_file
    wd = world.device(cuda)
    res = (160, 190)
    cp = standin_camera(res).params(cuda)
    rule, runs = tpers.schedule, {}
    for name in ("legacy", "spheres"):
        if name == "spheres":
            monkeypatch.setattr(tpers, "schedule",
                                lambda n, spp, *a: rule(n, spp, *a[:4], "spheres"))
        (img, segs, st), launches, shading = _counted(lambda: render_persistent(
            wd, cp, res, spp=2, limit=4, seed=0, bsdf="legacy", camera_model="jitter",
            scene="legacy", stats=True))
        _only(launches, k2=st["passes_full"] + sum(st["drain_passes"]), k7=shading["scatter"],
              **chip_smoke.expected_gathers(wd, shading))
        runs[name] = (img, segs, st["pool"])
    (img, segs, pool), (img0, segs0, pool0) = runs["legacy"], runs["spheres"]
    assert pool == res[0] * res[1] != pool0
    assert segs == segs0 and torch.equal(img.view(torch.int32), img0.view(torch.int32))


@pytest.mark.parametrize("knob", ["restart", "bf16", "restart+bf16"])
def test_mesh_knobs_on_the_card_launch_their_kernels(cuda, standin_file, monkeypatch, knob):
    """The stand-in's hybrid frame (64x64, 2 spp, depth 6, a 4,096-lane
    pool) under the JAX package's environment knobs: under
    ``LPT_TREELET_RESTART=1`` K2r on the pool passes of 4,096 rays and K2
    on the rest, the frame bit for bit the default frame; under
    ``LPT_PACKET_BF16=1`` (read when the world is loaded) K2h, and with the
    restart K2rh in K2r's place; each at least once, together once per
    traversal call, and no other traversal kernel."""
    _, path = standin_file
    res = (64, 64)
    cp = standin_camera(res).params(cuda)
    kw = dict(spp=2, limit=6, seed=2, camera_model="jitter", pool_w=4096, stats=True)
    for var in ("LPT_TREELET_RESTART", "LPT_PACKET_BF16"):
        monkeypatch.delenv(var, raising=False)
    ref, ref_segs, _ = render_hybrid(_load(path, cuda), cp, res, **kw)
    restart, bf16 = "restart" in knob, "bf16" in knob
    if restart:
        monkeypatch.setenv("LPT_TREELET_RESTART", "1")
    if bf16:
        monkeypatch.setenv("LPT_PACKET_BF16", "1")
    wd = _load(path, cuda)
    (img, segs, st), launches, _ = _counted(lambda: render_hybrid(wd, cp, res, **kw))
    walks = {k: n for k, n in launches.items() if k in tpt.traverse.launches}
    ran = {tpt.kernel_of(bf16=bf16)} | ({tpt.kernel_of(seeded=True, bf16=bf16)} if restart
                                        else set())
    assert walks.keys() == ran and sum(walks.values()) == st["n_chunks"] + st["passes"]
    if knob == "restart":
        assert segs == ref_segs and torch.equal(img.view(torch.int32), ref.view(torch.int32))


def test_l15_on_the_card_and_its_reloaded_world(cuda, tmp_path):
    """Stage l15 on the stand-in written as the reference's asset tree (OBJ,
    MTL, PBR set, EXR) at 64x36, 4 spp, one pass: every asset loads; K2
    once per traversal call, K6a and K6b as the shading calls imply, K7
    once per legacy BSDF call, nothing else; the saved ``.world.npy``
    reloaded with its own trees (``rebuild_bvh=False``) renders within
    ``render_agreement`` of the rebuilt world."""
    from learn_path_tracing_tpu_torch.stages import l15_module
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map

    root = str(tmp_path / "assets")
    standin_asset_tree(root, level=3, tex_size=64, env_size=(128, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # every asset must load
        (_, rep), launches, shading = _counted(lambda: l15_module.main([
            "--assets", root, "--passes", "1", "--width", "64", "--height", "36", "--spp", "4",
            "--limit", "8", "--device", cuda, "--out", str(tmp_path / "l15.png")]))
    path_map = make_asset_path_map(root)
    own = LegacyWorld().load(rep["world"], path_map=path_map, rebuild_bvh=False, device=cuda)
    _only(launches, k2=rep["n_chunks"] + rep["passes"], k7=shading["scatter"],
          **chip_smoke.expected_gathers(own, shading))
    assert shading["scatter"] > 0 and bool(torch.isfinite(rep["linear"]).all())
    rebuilt = LegacyWorld().load(rep["world"], path_map=path_map, device=cuda)
    res = (64, 36)
    cp = standin_camera(res).params(cuda)
    (a, sa), (b, sb) = (render_hybrid(wd, cp, res, spp=4, limit=8) for wd in (own, rebuilt))
    agree = render_agreement(a.cpu().numpy(), b.cpu().numpy(), sa, sb)
    assert agree["ok"], agree


def test_sphere_world_hybrid_launches_k3_and_k7_per_call(cuda):
    """A hybrid render of 8,192 spheres (``models.standin.sphere_world``,
    past the scan's ceiling) at 64x36, 4 spp, depth 8: K3 once per
    traversal call (slabs plus pool passes) and no other traversal kernel or
    K1, K7 once per legacy BSDF call (pool passes plus batches)."""
    wd = build_quiet(sphere_world(), device=cuda)
    res = (64, 36)
    cam = Camera(res, fov=60)
    cam.set_position((0.0, 8.0, -10.0))
    cam.look_at((0.0, 8.0, 40.0))
    (img, _, st), launches, shading = _counted(
        lambda: render_hybrid(wd, cam.params(cuda), res, spp=4, limit=8, stats=True))
    walks = {k: n for k, n in launches.items() if k in tpt.traverse.launches or k == "k1"}
    assert walks == {"k3": st["n_chunks"] + st["passes"]}
    assert launches["k7"] == shading["scatter"] > 0 and bool(torch.isfinite(img).all())


def test_stage10_cli_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``python -m learn_path_tracing_tpu_torch render --stage 10`` in this
    process at 64x36, 4 spp, depth 8 (``stages.common.run_path_traced``):
    K1 once a pass (the modular engine's passes, replayed from CUDA graphs,
    which call the world's hit query only at their capture), and no other
    kernel on the card; the linear image agrees with the same command's on
    the CPU by ``render_agreement``."""
    from learn_path_tracing_tpu_torch import __main__ as cli
    from learn_path_tracing_tpu_torch.stages import s10_final

    reps, real = [], s10_final.run_path_traced

    def kept(*args, **kw):          # the stage's report, which the CLI drops
        out = real(*args, **kw)
        reps.append(out[1])
        return out

    monkeypatch.setattr(s10_final, "run_path_traced", kept)
    argv = ["render", "--stage", "10", "--width", "64", "--height", "36", "--spp", "4",
            "--limit", "8"]
    rc, launches, _ = _counted(
        lambda: cli.main(argv + ["--device", cuda, "--out", str(tmp_path / "card.png")]))
    assert rc == 0 and launches == {"k1": reps[0]["passes"]} and reps[0]["passes"] > 0
    assert cli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "cpu.png")]) == 0
    card, cpu = reps
    agree = render_agreement(card["linear"].cpu().numpy(), cpu["linear"].numpy(),
                             card["segments"], cpu["segments"])
    assert agree["ok"], agree


def test_cli_smoke_exits_0_on_the_card(cuda):
    """``python -m learn_path_tracing_tpu_torch smoke`` as its own process."""
    proc = subprocess.run([sys.executable, "-m", "learn_path_tracing_tpu_torch", "smoke"],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_bvh_builder_on_the_card_host_is_numpys(cuda):
    """The stand-in mesh's BVH (23,424 triangles, depth 24, leaves of 8)
    from the C++ builder as the card machine's host compiles it, byte for
    byte the numpy builder's."""
    mesh = standin_mesh(5, STANDIN_SEED)
    tri = mesh.positions[mesh.face_p]
    args = (tri.min(axis=1), tri.max(axis=1))
    kw = dict(centroid=tri.mean(axis=1), max_depth=24, max_leaf=8)
    a, b = (build_bvh(*args, backend=backend, **kw) for backend in ("numpy", "native"))
    for f in ("left", "right", "low", "high", "data", "cut", "prim"):
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.prim.shape[0] == tri.shape[0] and a.max_leaf == b.max_leaf


# ------------------------------------------------------------------ K7 --

@pytest.mark.parametrize("n", [1, 255, 230400])
@pytest.mark.parametrize("strided", [False, True])
def test_legacy_scatter_kernel_matches_twin_bitwise(cuda, n, strided):
    """K7 (``scatter_legacy`` on the card) against its plain twin over
    ``chip_smoke.legacy_lanes``: metallic 0, 1 and fractional, transparent
    and opaque, roughness 0, back-face (inverted) ior, grazing incidence,
    an absorptivity of 0.5; the material contiguous or as the strided
    views a row gather leaves. One launch over every lane."""
    rays, hits, base = chip_smoke.legacy_lanes(n, n + strided, cuda, strided=strided)
    # (a view of one row is contiguous)
    assert hits.material.albedo.is_contiguous() != strided or n == 1
    before = (tls.scatter.launches, tls.scatter.lanes)
    got = scatter_legacy(rays, hits, base)
    assert (tls.scatter.launches, tls.scatter.lanes) == (before[0] + 1, before[1] + n)
    want = scatter_legacy_plain(rays, hits, base)
    torch.cuda.synchronize()
    assert chip_smoke.scatter_lanes_differ(got, want) == {}
    assert got.alive is rays.alive


def test_l11_lanes_k1_and_k3_match_twins_bitwise(cuda):
    """K1 and K3 on l11's lanes (``chip_smoke.l11_lane_sets``: its world,
    the primary rays of orbit frame 0 at 640x360 and the bounce pass after
    them): K1 bit for bit ``intersect_spheres_scan_plain``, and
    ``hit(backend='bvh')`` (K3) bit for bit the hit record of
    ``packet_traverse_plain`` over the same tables."""
    from learn_path_tracing_tpu_torch.scene.world import hit

    wd, sets = chip_smoke.l11_lane_sets(cuda)
    for rays, want, _ in sets.values():
        args = (rays.ro.contiguous(), rays.rd.contiguous(), wd.scan_table, wd.scan_attrs)
        assert _same_scan(tss.intersect_spheres_scan(*args),
                          tss.intersect_spheres_scan_plain(*args))
        got = hit(wd, rays, backend="bvh")
        for f in ("t", "obj", "hit", "point", "normal"):
            x, y = getattr(got, f), getattr(want, f)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), f


def test_legacy_scatter_kernel_rejects_mixed_devices(cuda):
    rays, hits, base = chip_smoke.legacy_lanes(64, 3, cuda)
    with pytest.raises(ValueError, match="base on cpu"):
        tls.scatter(rays, hits, base.cpu())


def test_l11_frame_with_k7_is_the_plain_frame_bitwise(cuda, monkeypatch):
    """An l11 frame (its world and orbit frame 0's camera at 64x36, 4 spp,
    depth 10, K3) is bit for bit the same through K7 as through the plain
    body, and K7 launches once a pass over every lane."""
    from learn_path_tracing_tpu_torch.bsdf import bsdf as tbsdf
    from learn_path_tracing_tpu_torch.integrator import wavefront as twf
    from learn_path_tracing_tpu_torch.stages.l11_bvh import legacy_random_scene, orbit_camera

    res = (64, 36)
    wd = legacy_random_scene().device(cuda, use_bvh=True)
    cp = orbit_camera(res, 0).params(cuda)
    kw = dict(limit=10, seed=2**31 + 11, bsdf="legacy", hit_backend="bvh", stats=True)
    img, segs, st = twf.render(wd, cp, res, 4, **kw)
    assert st["kernels"]["k7"] == {"launches": st["passes"],
                                   "lanes": st["passes"] * res[0] * res[1]}
    monkeypatch.setitem(tbsdf.SCATTERERS, "legacy", scatter_legacy_plain)
    img_p, segs_p, st_p = twf.render(wd, cp, res, 4, **kw)
    assert "k7" not in st_p["kernels"] and segs == segs_p
    assert torch.equal(img.view(torch.int32), img_p.view(torch.int32))


def test_hybrid_frame_with_k7_is_the_plain_frame_bitwise(cuda, monkeypatch):
    """A hybrid frame (mesh and spheres at 48x27, 8 spp, depth 8) with a
    256-lane batch and a 512-lane pool, so that batches are cap-padded and
    merge into a compacting pool: K7 launches once per legacy BSDF call
    (pool passes plus batches), and the frame is bit for bit the same
    through the plain body."""
    from learn_path_tracing_tpu_torch.bsdf import bsdf as tbsdf

    res = (48, 27)
    wd, cp = _hybrid_world().device(cuda), _hybrid_camera(res).params(cuda)
    kw = dict(spp=8, limit=8, seed=2**31 + 5, cap=256, pool_w=512, stats=True)
    before = tls.scatter.launches
    with chip_smoke.shading_calls() as shading:
        img, segs, st = render_hybrid(wd, cp, res, **kw)
    assert tls.scatter.launches - before == shading["scatter"] > st["passes"] > 0
    monkeypatch.setitem(tbsdf.SCATTERERS, "legacy", scatter_legacy_plain)
    before = tls.scatter.launches
    img_p, segs_p, _ = render_hybrid(wd, cp, res, **kw)
    assert tls.scatter.launches == before and segs == segs_p
    assert torch.equal(img.view(torch.int32), img_p.view(torch.int32))


def test_torch_sum_of_three_adds_x_plus_z_then_y(cuda):
    """K7's ``cos_theta`` adds its three products as (x + z) + y, the order
    in which ``torch.sum(..., dim=-1)`` over three f32 values adds on the
    card (the plain body's reduction). Should a PyTorch release change that
    order, this test names the cause of K7's departure from its twin."""
    g = torch.Generator(device=cuda).manual_seed(11)
    v = torch.randn((1 << 22, 3), device=cuda, generator=g) * torch.logspace(
        -3, 3, 3, device=cuda)[torch.randint(0, 3, (1 << 22, 3), device=cuda, generator=g)]
    x, y, z = v.unbind(-1)
    got = torch.sum(v, dim=-1)
    assert torch.equal(got.view(torch.int32), ((x + z) + y).view(torch.int32))
    assert not torch.equal(got.view(torch.int32), ((x + y) + z).view(torch.int32))
