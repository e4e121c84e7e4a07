"""The modular engine's CUDA graphs (``integrator.persistent.ModularGraphs``)
and the capture helper both integrators share (``integrator.graphs``).

The CPU cases check which renders take the graphs (a sphere world on a
CUDA device, outside a dispatch mode), that the helper's warm-up and
captures count nothing and its replays count their captures' launches, and
run ``ModularGraphs`` itself on the CPU with each capture replaced by a
rerun of its body (``rerun_capture``): the buffers, the seed and the
range's bases as data, the counts read a pass, the compaction between the
levels and ``drain_unroll`` give the eager loop's frame bit for bit, with
its schedule and reads. The card cases (marker ``gpu``) hold the captured
graphs' frame to the eager loop's bit for bit, with the same schedule and
kernel counts. This file imports neither JAX nor the JAX package.
"""

import contextlib
import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from learn_path_tracing_tpu_torch import ops
from learn_path_tracing_tpu_torch.integrator import graphs
from learn_path_tracing_tpu_torch.integrator import persistent as tpers
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.ops import legacy_scatter as tls
from learn_path_tracing_tpu_torch.ops import sphere_scan as tss
from learn_path_tracing_tpu_torch.utils import profiling

torch.set_num_threads(2)

SEEDS = (20261019, 2 ** 31 + 7)
LIMIT = 8
# (resolution, spp, render_persistent's knobs, card rule): the card rule at
# 64x36, 8 spp is a pool of 18,432 lanes, one item a lane, and the drain
# levels 2,304, 512 and 256 (at 32x18, 4 spp: 2,304 lanes, levels 512 and
# 256); 33x17 at 4 spp is ungrouped (4 does not divide 561), the JAX rule's
# pool of 561 lanes and no drain
CASES = {
    "card_rule": ((64, 36), 8, {}, True),
    "card_rule_unroll3": ((64, 36), 8, {"drain_unroll": 3}, True),
    "ungrouped": ((33, 17), 4, {}, False),
    "card_rule_bvh": ((32, 18), 4, {"hit_backend": "bvh"}, True),
}


def _bits(img):
    return img.contiguous().view(torch.int32)


def _scene(res, device, hit_backend="auto"):
    world = random_scene(seed=20230328).device(device, use_bvh=hit_backend == "bvh")
    return world, stage10_camera(res).params(device)


def _render(world, cam, res, spp, seed, **kw):
    return tpers.render_persistent(world, cam, res, spp, limit=LIMIT, seed=seed, stats=True,
                                   **kw)


def _passes(st):
    return st["passes_full"] + sum(st["drain_passes"])


class _Rerun:
    """A captured body's stand-in on the CPU: a replay reruns it, its spans
    unrecorded as a replay's inner spans are."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        with profiling.unrecorded():
            self.body()


def _rerun_capture(device, bodies):
    """``graphs.capture`` on the CPU: the warm-up, then a ``graphs.Graph`` a
    body whose replay reruns it."""
    with profiling.unrecorded(), ops.uncounted():
        for body in bodies:
            body()
    graphs.GRAPH_COUNTS["captures"] += len(bodies)
    return [graphs.Graph(_Rerun(body), {}, device) for body in bodies]


@pytest.fixture
def rerun_capture(monkeypatch):
    """``ModularGraphs`` on the CPU: a sphere world on any device takes the
    graphs, each captured by ``_rerun_capture``; a fresh slot of kept
    graphs."""
    monkeypatch.setattr(graphs, "takes_graphs", lambda scene, device, n: scene == "spheres")
    monkeypatch.setattr(graphs, "capture", _rerun_capture)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tpers, "_GRAPHS", (None, None))


def _eager(monkeypatch):
    """Render through the eager loop for the rest of the test."""
    monkeypatch.setattr(tpers, "modular_graphs", lambda *args: None)


# ------------------------------------------------------------------ the CPU --

@pytest.mark.parametrize("hit_backend", ["auto", "bvh"])
def test_the_cpu_takes_no_graph(hit_backend):
    """Off the card the eager loop runs: no CUDA graph is captured or
    replayed, and the hit query opens its span in every pass."""
    res, spp = (32, 18), 4
    world, cam = _scene(res, "cpu", hit_backend)
    img, segments, st = _render(world, cam, res, spp, SEEDS[0], hit_backend=hit_backend)
    assert st["graph"] == {"captures": 0, "replays": 0}
    assert st["spans"]["lpt.persistent.hit"][0] == _passes(st) == st["spans"][
        tpers.PASS_SPAN][0]
    sched = tpers.schedule(res[0] * res[1], spp)
    assert tpers.modular_graphs(world, cam, res, res[0] * res[1], spp, LIMIT, sched, "modern",
                                "thinlens", "spheres", hit_backend) is None


@pytest.mark.parametrize("scene, device, n, takes", [
    ("spheres", "cuda", 1, True), ("legacy", "cuda", 1, False), ("spheres", "cpu", 1, False),
    ("spheres", "cuda", 0, False)])
def test_which_renders_take_graphs(scene, device, n, takes):
    """A sphere world of at least one lane on a CUDA device takes the
    graphs; the legacy world, whose traversal reads its error word on every
    call, and the CPU do not (nothing is allocated: the answer is the
    device's type)."""
    assert graphs.takes_graphs(scene, torch.device(device), n) is takes


def test_the_legacy_world_takes_no_graph():
    """``modular_graphs`` answers None for the legacy world on a CUDA
    device before it looks at anything else."""
    cam = types.SimpleNamespace(device=torch.device("cuda"))
    sched = tpers.schedule(576, 4, scene="legacy")
    assert tpers.modular_graphs(None, cam, (32, 18), 576, 4, LIMIT, sched, "legacy", "jitter",
                                "legacy", "auto") is None


def test_a_dispatch_mode_takes_no_graph():
    """Under a ``TorchDispatchMode`` (``utils.checks.checked_trace``'s NaN
    trap reads every op's output, which a capture forbids) the render runs
    eagerly."""
    class Passthrough(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    cuda = torch.device("cuda")
    assert graphs.takes_graphs("spheres", cuda, 1)
    with Passthrough():
        assert not graphs.takes_graphs("spheres", cuda, 1)


class _FakeCUDAGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_graphs_counts_add_and_undo(monkeypatch):
    """``graphs.capture`` runs each body once and captures each (the
    bodies sharing one memory pool), with no launch counted and no span
    recorded; each ``Graph`` keeps its capture's launches, and each replay
    adds them to ``ops.kernel_counters`` and one to ``GRAPH_COUNTS``."""
    monkeypatch.setattr(ops, "_GRAPHED", {})
    monkeypatch.setattr(graphs, "GRAPH_COUNTS", {"captures": 0, "replays": 0})
    for obj, name in ((tss.intersect_spheres_scan, "launches"), (tls.scatter, "launches"),
                      (tls.scatter, "lanes")):
        monkeypatch.setattr(obj, name, getattr(obj, name))
    pools = []

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, capture_error_mode=None):
        pools.append((pool, capture_error_mode))
        yield

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    runs = []

    def scan():
        with profiling.span("lpt.test.scan"):
            runs.append("scan")
            tss.intersect_spheres_scan.launches += 2

    def scatter():
        runs.append("scatter")
        tls.scatter.launches += 1
        tls.scatter.lanes += 30

    before = ops.kernel_counters()
    with profiling.recording(True, "lpt.render.test", ops.kernel_counters) as table:
        scan_g, scatter_g = graphs.capture("cuda", [scan, scatter])
    assert runs == ["scan", "scatter", "scan", "scatter"]
    assert set(table.spans) == {"lpt.render.test"} and table.kernels == {}
    assert ops.kernel_counters() == before
    assert len(pools) == 2 and pools[0] == pools[1] and pools[0][1] == "thread_local"
    assert (scan_g.counts, scatter_g.counts) == (
        {"k1": {"launches": 2}}, {"k7": {"launches": 1, "lanes": 30}})
    assert graphs.GRAPH_COUNTS == {"captures": 2, "replays": 0}
    scan_g.replay()
    scan_g.replay()
    scatter_g.replay()
    assert profiling.count_delta(before, ops.kernel_counters()) == {
        "k1": {"launches": 4}, "k7": {"launches": 1, "lanes": 30}}
    assert (scan_g.graph.replays, scatter_g.graph.replays) == (2, 1)
    assert graphs.GRAPH_COUNTS == {"captures": 2, "replays": 3}
    assert graphs.graph_stats({"captures": 1, "replays": 1}) == {"captures": 1, "replays": 2}


def _card_rule(monkeypatch, card):
    """The card's pool rule on the CPU where the case asks for it."""
    if card:
        monkeypatch.setattr(tpers, "pool_rule", lambda *a: "card")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_graph_loop_is_the_eager_loop(rerun_capture, monkeypatch, case, seed):
    """``ModularGraphs`` on the CPU, at the call that captures and at one
    that replays: the eager loop's image bit for bit, its segments, its
    schedule and its reads (one more under 'bvh', K3's error word); a replay
    a pass and one for the start; the hit query's span only at the
    capture."""
    res, spp, knobs, card = CASES[case]
    _card_rule(monkeypatch, card)
    world, cam = _scene(res, "cpu", knobs.get("hit_backend", "auto"))
    graphed = [_render(world, cam, res, spp, seed, **knobs) for _ in range(2)]
    with monkeypatch.context() as m:
        _eager(m)
        img, segments, st = _render(world, cam, res, spp, seed, **knobs)
    assert st["graph"] == {"captures": 0, "replays": 0}
    if card:
        assert len(st["drain_widths"]) >= 2 and st["pool"] == spp * res[0] * res[1]
    levels = 1 + len(st["drain_widths"])
    for call, (g_img, g_segments, g_st) in enumerate(graphed):
        assert g_segments == segments and torch.equal(_bits(g_img), _bits(img))
        for key in ("pool", "pool_rule", "passes_full", "drain_widths", "drain_passes"):
            assert g_st[key] == st[key], key
        assert g_st["host_reads"] == st["host_reads"] + (knobs.get("hit_backend") == "bvh")
        assert g_st["graph"] == {"captures": 1 + levels if call == 0 else 0,
                                 "replays": 1 + _passes(st)}
        assert g_st["spans"][tpers.PASS_SPAN][0] == _passes(st)
        assert "lpt.persistent.hit" not in g_st["spans"]


def test_two_seeds_give_two_frames(rerun_capture, monkeypatch):
    """The seed is data in the graphs' buffers, not a value their capture
    kept: two seeds through one set of graphs give two frames, each the
    eager loop's."""
    res, spp, knobs, card = CASES["card_rule"]
    _card_rule(monkeypatch, card)
    world, cam = _scene(res, "cpu")
    graphed = [_render(world, cam, res, spp, seed) for seed in SEEDS]
    assert graphed[1][2]["graph"]["captures"] == 0
    assert not torch.equal(_bits(graphed[0][0]), _bits(graphed[1][0]))
    _eager(monkeypatch)
    for seed, (g_img, g_segments, _) in zip(SEEDS, graphed):
        img, segments, _ = _render(world, cam, res, spp, seed)
        assert g_segments == segments and torch.equal(_bits(g_img), _bits(img))


def test_the_ranges_of_a_mesh_share_one_capture(rerun_capture, monkeypatch):
    """``parallel.mesh`` runs ``_persistent_core`` over each rank's pixel
    and sample range: the bases are data, so two pixel tiles × two sample
    ranges replay one capture and add up to the whole frame's accumulator
    bit for bit, with its segments."""
    res = (32, 18)
    n = res[0] * res[1]
    world, cam = _scene(res, "cpu")
    args = (LIMIT, SEEDS[1], "modern", "thinlens", "spheres", "auto")
    with monkeypatch.context() as m:
        _eager(m)
        acc, segments, _ = tpers._persistent_core(world, cam, res, n, 0, 0, 4, *args)
    parts, part_segments, captures = torch.zeros_like(acc), 0, []
    for tile in range(2):
        for half in range(2):
            a, sg, st = tpers._persistent_core(world, cam, res, n // 2, tile * n // 2, half * 2,
                                               2, *args)
            parts[tile * n // 2:(tile + 1) * n // 2] += a
            part_segments += sg
            captures.append(st["graph"]["captures"])
    assert captures[0] > 0 and captures[1:] == [0, 0, 0]
    assert part_segments == segments and torch.equal(parts, acc)


# ----------------------------------------------------------------- the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs capture only on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_graph_frame_is_the_eager_frame_on_the_card(cuda, monkeypatch, case, seed):
    """The CUDA graphs' frame, at the call that captures them and at the
    one that replays them, is the eager loop's bit for bit, with its
    segments, its schedule (the card rule on a grouped render) and its
    kernel counts, a replay a pass and one for the start."""
    res, spp, knobs, card = CASES[case]
    monkeypatch.setattr(tpers, "_GRAPHS", (None, None))
    world, cam = _scene(res, cuda, knobs.get("hit_backend", "auto"))
    graphed = [_render(world, cam, res, spp, seed, **knobs) for _ in range(2)]
    with monkeypatch.context() as m:
        _eager(m)
        img, segments, st = _render(world, cam, res, spp, seed, **knobs)
    assert st["graph"] == {"captures": 0, "replays": 0}
    assert st["pool_rule"] == ("card" if card else "jax")
    if card:
        assert len(st["drain_widths"]) >= 2
    walk = "k3" if knobs.get("hit_backend") == "bvh" else "k1"
    assert st["kernels"][walk]["launches"] == _passes(st)
    levels = 1 + len(st["drain_widths"])
    for call, (g_img, g_segments, g_st) in enumerate(graphed):
        assert g_segments == segments and torch.equal(_bits(g_img), _bits(img))
        for key in ("pool", "pool_rule", "passes_full", "drain_widths", "drain_passes",
                    "kernels"):
            assert g_st[key] == st[key], key
        assert g_st["graph"] == {"captures": 1 + levels if call == 0 else 0,
                                 "replays": 1 + _passes(st)}


@pytest.mark.gpu
def test_two_seeds_give_two_frames_on_the_card(cuda):
    """One set of graphs, two seeds: two frames (a seed baked into the
    capture would give one)."""
    res, spp, _, _ = CASES["card_rule"]
    world, cam = _scene(res, cuda)
    (a, _, st_a), (b, _, st_b) = (_render(world, cam, res, spp, seed) for seed in SEEDS)
    assert st_b["graph"]["captures"] == 0 and st_b["graph"]["replays"] > 0
    assert not torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_a_checked_trace_runs_the_eager_loop_on_the_card(cuda):
    """Under ``utils.checks.checked_trace`` (a dispatch mode that reads
    every op's output) the render takes no graph and gives the graphs'
    frame."""
    from learn_path_tracing_tpu_torch.utils.checks import checked_trace

    res, spp = (32, 18), 4
    world, cam = _scene(res, cuda)
    img, segments, st = checked_trace(_render, world, cam, res, spp, SEEDS[0])
    assert st["graph"] == {"captures": 0, "replays": 0}
    g_img, g_segments, g_st = _render(world, cam, res, spp, SEEDS[0])
    assert g_st["graph"]["replays"] > 0
    assert g_segments == segments and torch.equal(_bits(g_img), _bits(img))
