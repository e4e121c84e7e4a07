"""The port's tracing (``utils.profiling``): spans, host reads and the kernel
counts, and what the renders add to their stats with them.

The CPU cases hold ``span``'s self times to a fake clock, show that no sink
means no ``record_function`` and no allocation, find the program's spans in
a Chrome trace, and check each engine's ``spans``, ``kernels`` and
``host_reads`` against its schedule, the image unchanged. The card case
(marker ``gpu``) counts the synchronising CUDA operations of a render call
under ``torch.cuda.set_sync_debug_mode("warn")``: every one of them is a
``host_read``. This file imports neither JAX nor the JAX package.
"""

import functools
import json
import types
import warnings

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent
from learn_path_tracing_tpu_torch.io.obj import MeshData
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.models.standin import standin_camera, standin_world
from learn_path_tracing_tpu_torch.ops import kernel_counters
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.ops import row_gather as trg
from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
from learn_path_tracing_tpu_torch.utils import profiling

torch.set_num_threads(2)

RES = (28, 20)
ENGINES = ("hybrid", "modular", "mega")


class FakeClock:
    """``perf_counter`` that moves only when told to."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(perf_counter=c.perf_counter))
    return c


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_span_self_time_leaves_out_nested_spans(clock, depth):
    """A chain of ``depth`` nested spans inside the root, each spending
    ``k + 1`` seconds of its own before its child and ``10·(k + 1)``
    after: each span's self time is its own 11·(k + 1) s, not its
    children's."""
    def nest(k):
        if k == depth:
            return
        with profiling.span(f"lpt.test.s{k}"):
            clock.now += k + 1
            nest(k + 1)
            clock.now += 10 * (k + 1)

    with profiling.recording(True, "lpt.render.test", kernel_counters) as table:
        clock.now += 0.5
        for _ in range(2):
            nest(0)
    table_stats = table.stats()
    spans = table_stats["spans"]
    assert set(spans) == {"lpt.render.test"} | {f"lpt.test.s{k}" for k in range(depth)}
    assert spans["lpt.render.test"] == [1, 0.5]
    for k in range(depth):
        assert spans[f"lpt.test.s{k}"] == [2, 2 * 11.0 * (k + 1)]
    assert sum(s for _, s in spans.values()) == clock.now
    assert table_stats["host_reads"] == 0 and table_stats["kernels"] == {}


def test_host_read_counts_and_waits_in_the_sync_span(clock):
    def slow_read(x):
        clock.now += 2.0
        return x.tolist()

    with profiling.recording(True, "lpt.render.test", kernel_counters) as table:
        with profiling.span("lpt.test.pass"):
            clock.now += 1.0
            assert profiling.host_read(slow_read, torch.tensor([3, 4])) == [3, 4]
            assert profiling.host_read(int, torch.tensor(7)) == 7
    st = table.stats()
    assert st["host_reads"] == 2
    assert st["spans"]["lpt.sync"] == [2, 2.0]
    assert st["spans"]["lpt.test.pass"] == [1, 1.0]


@pytest.mark.parametrize("call", ["span", "host_read", "spanned"])
def test_no_sink_records_nothing(monkeypatch, call):
    """With no table open and the profiler off, ``span`` is the shared no-op
    (nothing allocated), ``host_read`` is the read, and neither enters a
    ``record_function``."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no sink open")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    if call == "span":
        first, second = profiling.span("lpt.test.a"), profiling.span("lpt.test.b")
        assert first is second is profiling._NULL
        with first:
            pass
    elif call == "host_read":
        assert profiling.host_read(int, torch.tensor(5)) == 5
    else:
        double = profiling.spanned("lpt.test.double")(lambda x: 2 * x)
        assert double(21) == 42
    assert profiling._TABLE.get() is None


def test_kernel_counts_are_the_call_deltas(monkeypatch):
    """``kernels``: the launches, lanes and bytes counted during the call
    (the kernels run only on the card; here the counters are moved by
    hand), and only the kernels that launched."""
    for counter in (tpt.traverse.launches, tpt.traverse.lanes, trg.gather.launches,
                    trg.gather.bytes):
        for k in counter:
            monkeypatch.setitem(counter, k, counter[k] + 1000)   # earlier calls
    with profiling.recording(True, "lpt.render.test", kernel_counters) as table:
        tpt.traverse.launches["k2"] += 2
        tpt.traverse.lanes["k2"] += 300
        trg.gather.launches["k6b"] += 1
        trg.gather.bytes["k6b"] += 40 * 256
    assert table.stats()["kernels"] == {"k2": {"launches": 2, "lanes": 300},
                                        "k6b": {"launches": 1, "bytes": 10240}}


@pytest.mark.parametrize("stats", [False, True])
def test_spans_are_user_annotations_in_the_chrome_trace(tmp_path, stats):
    """Under ``profiling.trace`` the program's spans are ``user_annotation``
    events of the Chrome trace, with or without a stats table; with one,
    the table counts the same spans."""
    wd = random_scene(seed=20230328).device("cpu")
    cp = stage10_camera((16, 12)).params("cpu")
    with profiling.trace(str(tmp_path)):
        out = render_persistent(wd, cp, (16, 12), spp=2, limit=3, seed=1, engine="mega",
                                stats=stats)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [ev["name"] for ev in events
             if ev.get("cat") == "user_annotation" and ev["name"].startswith("lpt.")]
    assert {"lpt.render.mega", "lpt.sync"} <= set(names)
    if stats:
        assert {k: names.count(k) for k in set(names)} == {
            k: count for k, (count, _) in out[2]["spans"].items()}


# ------------------------------------------------------------ the engines --

def _mini_world():
    """A quad floor and a sphere under the sky-gradient environment."""
    world = LegacyWorld()
    world.add_mesh(MeshData(
        positions=np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32),
        normals=np.array([[0, 1, 0]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.zeros((2, 3), np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.zeros(2, np.int32)))
    world.add_sphere((0, 1, 0), 0.8, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return world.build()


@pytest.fixture(scope="module")
def scenes():
    cam = Camera(RES)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    return {"legacy": (_mini_world(), cam.params("cpu")),
            "spheres": (random_scene(seed=20230328).device("cpu"),
                        stage10_camera(RES).params("cpu"))}


def _render(scenes, engine, stats):
    if engine == "hybrid":
        wd, cp = scenes["legacy"]
        return render_hybrid(wd, cp, RES, spp=4, limit=6, seed=3, camera_model="thinlens",
                             stats=stats)
    wd, cp = scenes["spheres"]
    return render_persistent(wd, cp, RES, spp=4, limit=6, seed=3, engine=engine,
                             stats=stats)


@pytest.fixture(scope="module")
def with_stats(scenes):
    """``engine -> (image, segments, stats)`` of a render with ``stats``,
    made once an engine."""
    done = {}

    def get(engine):
        if engine not in done:
            done[engine] = _render(scenes, engine, True)
        return done[engine]
    return get


def expected_host_reads(engine, st, on_card=False):
    """The host reads a render's schedule implies: the modular engine's
    first live count and one a pass; the mega engine's two lane-list
    ``nonzero`` and one a pass; the hybrid's hit count a chunk and the live
    and hit counts a pool pass, and on the card the traversal kernel's error
    flag at each of those launches."""
    if engine == "modular":
        return 1 + st["passes_full"] + sum(st["drain_passes"])
    if engine == "mega":
        return st["passes"] + 2
    return (2 if on_card else 1) * st["n_chunks"] + (3 if on_card else 2) * st["passes"]


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_stats_carry_the_tables(with_stats, engine):
    _, _, st = with_stats(engine)
    assert isinstance(st["kernels"], dict) and isinstance(st["host_reads"], int)
    root = "lpt.render.modular" if engine == "modular" else f"lpt.render.{engine}"
    assert st["spans"][root][0] == 1
    assert all(name.startswith("lpt.") and count > 0 and seconds >= 0
               for name, (count, seconds) in st["spans"].items())
    want = {"hybrid": {"lpt.hybrid.slab", "lpt.hybrid.survivors", "lpt.hybrid.batch",
                       "lpt.hybrid.pool_pass", "lpt.hybrid.flush", "lpt.legacy.trace",
                       "lpt.legacy.attrs", "lpt.legacy.env", "lpt.bsdf.scatter",
                       "lpt.sync"},
            "modular": {"lpt.persistent.pass", "lpt.persistent.hit", "lpt.bsdf.scatter",
                        "lpt.camera.primary", "lpt.persistent.accumulate",
                        "lpt.persistent.drain", "lpt.sync"},
            "mega": {"lpt.render.mega", "lpt.sync"}}[engine]
    assert want <= set(st["spans"])
    assert st["spans"]["lpt.sync"][0] == st["host_reads"]


@pytest.mark.parametrize("engine", ENGINES)
def test_host_reads_follow_the_schedule(with_stats, engine):
    _, _, st = with_stats(engine)
    assert st["host_reads"] == expected_host_reads(engine, st)
    if engine == "hybrid":
        assert st["spans"]["lpt.hybrid.pool_pass"][0] == st["passes"]
        assert st["spans"]["lpt.hybrid.slab"][0] == st["n_chunks"]
    if engine == "mega":
        assert set(st["spans"]) == {"lpt.render.mega", "lpt.sync"}
    if engine == "modular":
        assert st["spans"]["lpt.persistent.pass"][0] == (st["passes_full"]
                                                         + sum(st["drain_passes"]))


@pytest.mark.parametrize("engine", ENGINES)
def test_stats_leave_the_frame_as_it_was(scenes, with_stats, engine):
    img, segs, _ = with_stats(engine)
    ref_img, ref_segs = _render(scenes, engine, False)
    assert segs == ref_segs and torch.equal(img.view(torch.int32), ref_img.view(torch.int32))


# ----------------------------------------------------------------- the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The stand-in mesh world (one mesh, no spheres: the hybrid cell's
    kind of world) at a test's size."""
    world = standin_world(str(tmp_path_factory.mktemp("standin")), level=3, tex_size=64,
                          env_size=(128, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    return world


def _card_scene(engine, device, standin):
    """``(render, world data, camera params, resolution)`` on the card."""
    if engine == "hybrid":
        res = (96, 64)
        return (render_hybrid, standin.device(device),
                standin_camera(res).params(device), res)
    res = (64, 36)
    return (functools.partial(render_persistent, engine=engine),
            random_scene(seed=20230328).device(device), stage10_camera(res).params(device), res)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
def test_host_reads_are_the_syncs_on_the_card(cuda, request, engine):
    """One frame of each one-card benchmark cell's entry (the hybrid on a
    stand-in world, the modular and mega engines on the cover scene) at a
    test's size: ``host_reads`` is the number of synchronising CUDA
    operations of the render call, and the schedule's count."""
    standin = request.getfixturevalue("standin") if engine == "hybrid" else None
    render, wd, cp, res = _card_scene(engine, cuda, standin)
    kw = dict(spp=4, limit=8, seed=5, stats=True)
    render(wd, cp, res, **kw)                       # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")    # its first call warns itself: not counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, _, st = render(wd, cp, res, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchronizing" in str(w.message)]
    assert st["host_reads"] == len(syncs), syncs
    assert st["host_reads"] == expected_host_reads(engine, st, on_card=True)
    kernels = st["kernels"]
    if engine == "mega":
        assert kernels["k4"]["launches"] == st["passes"]
    elif engine == "modular":
        assert kernels["k1"]["launches"] == st["passes_full"] + sum(st["drain_passes"])
    else:
        assert kernels["k2"]["launches"] == st["n_chunks"] + st["passes"]
        assert kernels["k2"]["lanes"] > 0 and kernels["k6b"]["bytes"] > 0
