"""Stage l11's deployment through the wavefront integrator: the frame against
the benchmark's plain reference, the BVH walk against the sphere scan, and
the render's stats (passes, host reads, K3's counts) and spans.

The CPU cases render the stage's world (485 spheres, its SAH sphere BVH) at
32x18, 4 spp, depth 10 from orbit frame 0's camera, where ``hit_backend=
'bvh'`` runs K3's plain twin, and the eager loop runs (no CUDA graph). The
card cases (marker ``gpu``) hold the CUDA-graph frame to the eager loop's
bit for bit, with its kernel counts, K3's deferred error word, and count the
render's synchronising CUDA operations and K3's launches. This file imports
neither JAX nor the JAX package.
"""

import dataclasses

import functools
import json
import warnings

import pytest
import torch

from benchmark.harness import compare, registry
from benchmark.reference import integrate
from learn_path_tracing_tpu_torch import ops
from learn_path_tracing_tpu_torch.integrator import wavefront as wf
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.scene import world as world_mod
from learn_path_tracing_tpu_torch.stages.l11_bvh import legacy_random_scene, orbit_camera
from learn_path_tracing_tpu_torch.utils import profiling

torch.set_num_threads(2)

RES = (32, 18)
SPP, LIMIT, SEED = 4, 10, 20261018
NEW_SPANS = ("lpt.wavefront.pass", "lpt.wavefront.hit", "lpt.wavefront.escape",
             "lpt.bsdf.scatter", "lpt.camera.primary")


@pytest.fixture(scope="module")
def world():
    return legacy_random_scene().device("cpu", use_bvh=True)


@pytest.fixture(scope="module")
def cam():
    return orbit_camera(RES, 0).params("cpu")


def _render(world, cam, entry="render", **kw):
    """The stage's call through ``entry``: ``(image f32[W,H,3], segments[, stats])``."""
    args = dict(dict(limit=LIMIT, seed=SEED, bsdf="legacy", hit_backend="bvh"), **kw)
    if entry == "render":
        return wf.render(world, cam, RES, SPP, **args)
    if entry == "render_chunked":
        return wf.render_chunked(world, cam, RES, SPP, chunk_spp=3, **args)
    acc = torch.zeros((RES[0] * RES[1], 3))
    out = wf.render_accumulate(world, cam, acc, 0, RES, SPP, **args)
    return ((out[0] / SPP).reshape(*RES, 3), *out[1:])


@pytest.fixture(scope="module")
def frame(world, cam):
    return _render(world, cam)


def _bits(img):
    return img.contiguous().view(torch.int32)


def test_bvh_frame_is_the_plain_reference(frame):
    """Bit for bit (no tolerance): the reference traces each path with the
    program's operations in the program's order (the scan finds the BVH
    walk's sphere, the legacy BSDF and the sky are frozen copies, the
    pixel sums are float32 in sample order), so on the same device it
    rounds as the program's plain path does. The walk and the scan part
    only on rays with a direction component of exactly 0 and on grazing
    near-misses of the ground, about one path in 10**7 (``world.hit``);
    none is among this frame's 2,304 paths."""
    cfg = registry.config("l11_legacy_spheres")
    cfg["resolution"] = list(RES)
    scene = registry.module("scenes", cfg["scene"]).generate(cfg)
    pix = compare.pixels({"compare": {"pixels": "all"}}, cfg, 0, "cpu")
    acc, segs = registry.module("reference", cfg["reference"]).render(scene, cfg, SEED, SPP,
                                                                        pix)
    img, segments = frame
    assert segments == int(segs.sum())
    assert torch.equal(_bits(img.reshape(-1, 3)), _bits(integrate.image(acc, SPP)))


def test_bvh_frame_is_the_scan_frame(world, cam, frame):
    img, segments = _render(world, cam, hit_backend="auto")
    assert segments == frame[1]
    assert torch.equal(_bits(img), _bits(frame[0]))


@pytest.mark.parametrize("entry", ["render", "render_chunked", "render_accumulate"])
def test_stats_leave_the_frame_as_it_was(world, cam, frame, entry):
    with_stats = _render(world, cam, entry, stats=True)
    without = _render(world, cam, entry)
    assert len(with_stats) == 3 and len(without) == 2
    assert with_stats[1] == without[1] == frame[1]
    assert torch.equal(_bits(with_stats[0]), _bits(without[0]))
    assert torch.equal(_bits(without[0]), _bits(frame[0]))


@pytest.mark.parametrize("entry", ["render", "render_chunked", "render_accumulate"])
def test_the_cpu_takes_no_graph(world, cam, frame, entry):
    """Off the card the eager loop runs: no CUDA graph is captured or
    replayed, and the frame is the one it was."""
    img, segments, st = _render(world, cam, entry, stats=True)
    assert st["graph"] == {"captures": 0, "replays": 0}
    assert wf.pass_graphs(world, cam, RES, RES[0] * RES[1], "legacy", "thinlens", "spheres",
                          "bvh") is None
    assert segments == frame[1] and torch.equal(_bits(img), _bits(frame[0]))


def test_the_plain_twin_takes_the_callers_error_word(world):
    """``traverse`` with the caller's error word (what the CUDA graphs pass
    K3) returns what it returns without it, and leaves the word 0 on sound
    tables."""
    rays = wf.generate_rays_for_pixels(orbit_camera(RES, 0).params("cpu"), RES,
                                       torch.arange(RES[0] * RES[1]), SEED, 0)
    n = rays.count
    args = (*world.bvh, rays.ro, rays.rd, torch.full((n,), float("inf")),
            torch.ones((n,), dtype=torch.bool))
    kw = dict(eps=1e-4, leaf_kind="sphere", stack=world.bvh_stack)
    err = torch.zeros((1,), dtype=torch.int32)
    with_word = tpt.traverse(*args, err=err, **kw)
    without = tpt.traverse(*args, **kw)
    assert int(err[0]) == 0 and int((with_word[1] >= 0).sum()) > 0
    for a, b in zip(with_word, without):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="err must be torch.int32"):
        tpt.traverse(*args, err=torch.zeros((2,), dtype=torch.int32), **kw)


def test_check_flags_names_each_error():
    tpt.check_flags(0)
    for flags, what in ((1, "stack overflow"), (2, "iteration backstop reached"),
                        (3, "stack overflow and iteration backstop reached")):
        with pytest.raises(RuntimeError, match=f"packet traversal kernel: {what} "):
            tpt.check_flags(flags)


def test_a_graphs_counts_add_and_undo(monkeypatch):
    """``ops.count_replay`` adds a capture's ``count_delta`` to each kind of
    counter (a replay's launches), and ``ops.uncounted`` leaves the
    counters as they were before its block (a warm-up's and a capture's)."""
    monkeypatch.setattr(ops, "_GRAPHED", {})
    for counter in (tpt.traverse.launches, tpt.traverse.lanes, tpt.ACTIVE_LANES):
        monkeypatch.setitem(counter, "k3", counter["k3"])
    for k in ("k6a", "k6b"):
        for counter in (ops.row_gather.gather.launches, ops.row_gather.gather.bytes):
            monkeypatch.setitem(counter, k, counter[k])
    for obj, name in ((ops.sphere_scan.intersect_spheres_scan, "launches"),
                      (ops.bounce_megakernel.bounce_pass, "launches"),
                      (ops.legacy_scatter.scatter, "launches"),
                      (ops.legacy_scatter.scatter, "lanes")):
        monkeypatch.setattr(obj, name, getattr(obj, name))
    before = ops.kernel_counters()
    delta = {"k1": {"launches": 2}, "k4": {"launches": 1},
             "k7": {"launches": 3, "lanes": 30},
             "k3": {"launches": 1, "lanes": 10, "active_lanes": 7},
             "k2": {"launches": 4, "lanes": 40}, "k6b": {"launches": 5, "bytes": 50}}
    ops.count_replay(delta)
    ops.count_replay(delta)
    assert profiling.count_delta(before, ops.kernel_counters()) == {
        k: {c: 2 * n for c, n in counts.items()} for k, counts in delta.items()}
    replayed = ops.kernel_counters()
    with ops.uncounted():
        tpt.traverse.launches["k3"] += 1
        tpt.traverse.lanes["k3"] += 10
        tpt.ACTIVE_LANES["k3"] += 7
        ops.legacy_scatter.scatter.launches += 1
        ops.legacy_scatter.scatter.lanes += 10
        assert profiling.count_delta(replayed, ops.kernel_counters()) == {
            "k3": delta["k3"], "k7": {"launches": 1, "lanes": 10}}
    assert ops.kernel_counters() == replayed


@pytest.fixture
def counted(monkeypatch):
    """Count the world's hit queries and the integrator's host reads, and
    count K3's plain twin in ``traverse``'s counters as a K3 launch counts
    (``packet_traverse.count_launch``) with the active lanes its caller
    passes."""
    calls = {"hit": 0, "host_read": 0}
    hit, host_read = world_mod.hit, wf.host_read

    def counting_hit(*a, **kw):
        calls["hit"] += 1
        return hit(*a, **kw)

    def counting_read(*a):
        calls["host_read"] += 1
        return host_read(*a)

    def k3_twin(nodes, entries, runs, ro, rd, t_init, active, active_lanes=None, **kw):
        out = tpt.traverse(nodes, entries, runs, ro, rd, t_init, active, **kw)
        tpt.count_launch(tpt.kernel_of(kw["leaf_kind"]), ro.shape[0], active_lanes)
        return out

    monkeypatch.setattr(world_mod, "hit", counting_hit)
    monkeypatch.setattr(wf, "host_read", counting_read)
    monkeypatch.setattr(world_mod, "traverse", k3_twin)
    for counter in (tpt.traverse.launches, tpt.traverse.lanes, tpt.ACTIVE_LANES):
        monkeypatch.setitem(counter, "k3", counter["k3"] + 1000)    # earlier calls
    return calls


@pytest.mark.parametrize("early_exit", [True, False])
def test_stats_count_passes_reads_and_k3(world, cam, counted, early_exit):
    img, segments, st = _render(world, cam, stats=True, early_exit=early_exit)
    assert st["passes"] == counted["hit"] == st["spans"]["lpt.wavefront.pass"][0]
    assert st["host_reads"] == counted["host_read"] == st["spans"]["lpt.sync"][0]
    if not early_exit:
        assert st["passes"] == SPP * LIMIT and st["host_reads"] == SPP
    else:   # a live check before each pass, one that ends the loop early, the count
        assert SPP + st["passes"] <= st["host_reads"] <= 2 * SPP + st["passes"]
    lanes = st["passes"] * RES[0] * RES[1]
    assert st["kernels"] == {"k3": {"launches": st["passes"], "lanes": lanes,
                                    "active_lanes": lanes}}


def test_spans_are_present_and_nest(world, cam, tmp_path):
    """Under the profiler the spans are ``user_annotation`` events: the
    hit query, the escape term and the BSDF inside a pass, the passes and
    the primaries inside the root, and no primaries inside a pass."""
    with profiling.trace(str(tmp_path)):
        _, _, st = _render(world, cam, stats=True)
    with open(tmp_path / "trace.json") as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("cat") == "user_annotation" and ev["name"].startswith("lpt.")]
    spans = {}
    for ev in events:
        spans.setdefault(ev["name"], []).append((ev["ts"], ev["ts"] + ev["dur"]))
    assert set(NEW_SPANS) | {wf.ROOT_SPAN, "lpt.sync"} == set(spans)
    assert {k: len(v) for k, v in spans.items()} == {k: c for k, (c, _) in st["spans"].items()}

    def inside(span, outer):
        return any(s <= span[0] and span[1] <= e for s, e in spans[outer])

    for name in ("lpt.wavefront.hit", "lpt.wavefront.escape", "lpt.bsdf.scatter"):
        assert all(inside(s, "lpt.wavefront.pass") for s in spans[name]), name
    for name in ("lpt.wavefront.pass", "lpt.camera.primary"):
        assert all(inside(s, wf.ROOT_SPAN) for s in spans[name]), name
    assert not any(inside(s, "lpt.wavefront.pass") for s in spans["lpt.camera.primary"])


# ----------------------------------------------------------------- the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 runs only on the card")
    return "cuda"


@pytest.fixture
def card_world(cuda):
    return legacy_random_scene().device(cuda, use_bvh=True)


def _eager(monkeypatch):
    """Render through the eager loop (``bounce_pass`` a pass, every op
    launched from the host) for the rest of the test."""
    monkeypatch.setattr(wf, "pass_graphs", lambda *args: None)


@pytest.mark.gpu
@pytest.mark.parametrize("hit_backend", ["bvh", "auto"])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 7])
def test_the_graph_frame_is_the_eager_frame_on_the_card(card_world, cuda, monkeypatch,
                                                        hit_backend, early_exit, seed):
    """The CUDA graphs' frame, at the call that captures them and at the
    one that replays them, is the eager loop's bit for bit, with the same
    passes and kernel counts (K3 or K1, and K7), and a replay for each pass
    and each sample's primaries."""
    monkeypatch.setattr(wf, "_GRAPHS", (None, None))
    cp = orbit_camera(RES, 0).params(cuda)
    kw = dict(limit=LIMIT, seed=seed, bsdf="legacy", hit_backend=hit_backend,
              early_exit=early_exit, stats=True)
    graphed = [wf.render(card_world, cp, RES, SPP, **kw) for _ in range(2)]
    with monkeypatch.context() as m:
        _eager(m)
        img, segments, st = wf.render(card_world, cp, RES, SPP, **kw)
    assert st["graph"] == {"captures": 0, "replays": 0}
    walk = "k3" if hit_backend == "bvh" else "k1"
    assert set(st["kernels"]) == {walk, "k7"} and st["kernels"]["k7"]["launches"] == st["passes"]
    for call, (g_img, g_segments, g_st) in enumerate(graphed):
        assert g_segments == segments and g_st["passes"] == st["passes"]
        assert g_st["kernels"] == st["kernels"]
        assert g_st["graph"] == {"captures": 2 if call == 0 else 0,
                                 "replays": SPP + st["passes"]}
        assert torch.equal(g_img.view(torch.int32), img.view(torch.int32))


@pytest.mark.gpu
def test_a_k3_fault_raises_once_a_frame_on_the_card(card_world, cuda, monkeypatch):
    """A stack cap too small for the tables: the graphs' render raises the
    eager loop's ``RuntimeError`` from its one read of K3's error word at
    the end of the frame; the same world renders again after it."""
    bad = dataclasses.replace(card_world, bvh_stack=2)
    cp = orbit_camera(RES, 0).params(cuda)
    kw = dict(limit=LIMIT, seed=SEED, bsdf="legacy", hit_backend="bvh")
    with pytest.raises(RuntimeError, match="packet traversal kernel: stack overflow") as graphed:
        wf.render(bad, cp, RES, SPP, **kw)
    with monkeypatch.context() as m:
        _eager(m)
        with pytest.raises(RuntimeError) as eager:
            wf.render(bad, cp, RES, SPP, **kw)
    assert str(graphed.value) == str(eager.value)
    img, _ = wf.render(card_world, cp, RES, SPP, **kw)
    assert bool(torch.isfinite(img).all())


@pytest.mark.gpu
def test_host_reads_are_the_syncs_and_k3_counts_its_lanes_on_the_card(cuda):
    """One frame of the cell's call at a test's size on the card, its CUDA
    graphs replayed: every synchronising CUDA operation is a ``host_read``,
    the live check before each pass among them and one read a frame of the
    segments and K3's error word; K3 launches once a pass over every lane,
    all of them active, as does K7 (the legacy BSDF)."""
    wd = legacy_random_scene().device(cuda, use_bvh=True)
    render = functools.partial(wf.render, wd, orbit_camera(RES, 0).params(cuda), RES, SPP,
                               limit=LIMIT, seed=SEED, bsdf="legacy", hit_backend="bvh",
                               stats=True)
    render()                                    # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")      # its first call warns itself: not counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, _, st = render()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    assert st["host_reads"] == len(syncs)
    assert st["graph"] == {"captures": 0, "replays": SPP + st["passes"]}
    assert st["passes"] + 1 <= st["host_reads"] <= st["passes"] + SPP + 1
    lanes = st["passes"] * RES[0] * RES[1]
    assert st["kernels"] == {"k3": {"launches": st["passes"], "lanes": lanes,
                                    "active_lanes": lanes},
                             "k7": {"launches": st["passes"], "lanes": lanes}}
