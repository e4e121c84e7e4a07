"""Card-only tests of the port (marker ``gpu``): they skip where
``torch.cuda.is_available()`` is false. This file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(from the root of the checkout: the bench tests import ``bench_torch``).

Tolerances: the sphere-scan kernel (K1, at the frame's pass widths and
every slice count, ties included), the packet-traversal kernels (K2
triangle leaves, K3 sphere leaves; ``hit(backend='bvh')`` through K3 equals
K1's hits), the bounce megakernel (K4, all lanes and a late sparse lane
list) and the row gathers (K6a, K6b: fill rows and bf16 compared as bits)
equal their plain twins bit for bit (the same IEEE-rounded operations in the same
order, and an order-free tie rule); a GPU render, persistent (modular or
mega) or hybrid, equals a rerun bit for bit (fixed-point accumulation); a
GPU render agrees with the CPU render within
``utils.checks.render_agreement``'s bounds (the transcendental functions of
the two devices differ by ulps).
"""

import warnings

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu_torch.accel import build_bvh, collapse
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.integrator.persistent import (bounce_pass_plain, mega_pass,
                                                                render_persistent)
from learn_path_tracing_tpu_torch.io.obj import MeshData
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.ops import bounce_megakernel as tmk
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.ops import row_gather as trg
from learn_path_tracing_tpu_torch.ops import sphere_scan as tss
from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

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


def test_gpu_hybrid_is_deterministic_and_matches_cpu(cuda):
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
    res = (48, 27)
    cam = Camera(res)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
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
    call or pass of every render the cell made, warm-up included, and the
    two engines give the same segments and image bit for bit."""
    import bench_torch

    rows = {}
    for name in ("persistent", "mega"):
        tss.intersect_spheres_scan.launches = 0
        tmk.bounce_pass.launches = 0
        rows[name] = bench_torch.run_cell(engine=name, resolution=(64, 36), spp=4, limit=8,
                                          device=cuda)
        launches = (tss.intersect_spheres_scan.launches, tmk.bounce_pass.launches)
        calls = sum(rows[name]["calls"])
        assert launches == ((calls, 0) if name == "persistent" else (0, calls))
    row = rows[engine]
    assert row["card"] != "cpu" and len(row["frames"]) == 3 and row["value"] > 0
    assert rows["persistent"]["segments"] == rows["mega"]["segments"]
    assert torch.equal(rows["persistent"]["image"].view(torch.int32),
                       rows["mega"]["image"].view(torch.int32))


@pytest.fixture
def hit_calls(monkeypatch):
    """Counts ``scene.world.hit`` calls (one per wavefront bounce pass)."""
    from learn_path_tracing_tpu_torch.scene import world as tworld

    calls = [0]
    real = tworld.hit

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tworld, "hit", counted)
    return calls


def test_l11_bvh_equals_auto_bitwise(cuda, hit_calls, tmp_path):
    from learn_path_tracing_tpu_torch.stages import l11_bvh

    args = ["--width", "64", "--height", "36", "--spp", "4", "--limit", "8"]
    reps = {}
    for backend in ("auto", "bvh"):
        hit_calls[0] = 0
        tss.intersect_spheres_scan.launches = 0
        tpt.traverse.launches.update(dict.fromkeys(tpt.traverse.launches, 0))
        _, reps[backend] = l11_bvh.main(args + ["--hit-backend", backend,
                                                "--out", str(tmp_path / f"{backend}.png")])
        k1, k3 = tss.intersect_spheres_scan.launches, tpt.traverse.launches["k3"]
        assert (k1, k3) == ((hit_calls[0], 0) if backend == "auto" else (0, hit_calls[0]))
    assert reps["auto"]["segments"] == reps["bvh"]["segments"]
    assert torch.equal(reps["auto"]["linear"].view(torch.int32),
                       reps["bvh"]["linear"].view(torch.int32))


def test_l12_walks_the_sphere_bvh_only(cuda, hit_calls, tmp_path, monkeypatch):
    from learn_path_tracing_tpu_torch.stages import l12_free_view

    monkeypatch.chdir(tmp_path)
    tss.intersect_spheres_scan.launches = 0
    tpt.traverse.launches.update(dict.fromkeys(tpt.traverse.launches, 0))
    frame, rep = l12_free_view.main(["--width", "64", "--height", "36", "--spp", "4",
                                     "--limit", "8", "--script", "w,.,."])
    assert rep["spp"] == [4, 8, 12]
    assert tss.intersect_spheres_scan.launches == 0
    assert tpt.traverse.launches["k3"] == hit_calls[0] > 0
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
