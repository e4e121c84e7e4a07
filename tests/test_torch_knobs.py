"""Port parity: the schedule knobs of the persistent engine and the two
environment knobs of the mesh path, on the CPU at small sizes.

- ``integrator.persistent.schedule(n, spp, pool_mult, pool_div,
  drain_ratio, drain_floor)`` against the pool and drain widths the JAX
  package's ``_persistent_core`` builds for the same arguments (read from
  the widths its trace hands the camera, ``jax.make_jaxpr``: nothing runs),
  over a grid of sizes and knobs, and the same ``ValueError`` where JAX
  raises one.
- ``render_persistent`` under each knob (``drain_unroll`` included): the
  auto image bit for bit with its segments (the schedule only changes which
  lane traces which sample, and the int64 accumulator is order-free);
  against the JAX package's render with the same knobs at 32x18, limit 1
  (no bounce, so no discrete event can differ): the pool, drain widths,
  passes of every level and segments exactly; at limit 8: the schedule
  exactly and the image by ``utils.checks.render_agreement`` (the bound of
  ``test_torch_integrator.py``).
- ``bench_torch``'s ``--pool-mult``/``--pool-div`` and its ``schedule``.
- The card's pool rule (``card_schedule``, ``pool_rule``), which no JAX
  function has: its arithmetic over the sizes above and a few more; a CPU
  render with ``pool_rule`` answering 'card' (as on a CUDA device) and each
  range of a mesh under it, bit for bit the JAX rule's frame with its
  segments; ``pool_rule`` in the stats of every path into the engine.
- ``LPT_PACKET_BF16=1`` and ``LPT_TREELET_RESTART=1`` on a single-mesh
  world: unset, nothing changes; the restart frame is bit for bit the
  default frame (hybrid and wavefront engines); the bf16 world keeps f32
  treelet boxes, and its frame is held to the image bounds of
  ``render_agreement`` against the default one, its segments to 2 % (the
  bf16 slab test drops short bounce hits: ``test_bf16_world_frame``); its
  bf16 table is the JAX package's bit for bit, and ``convert`` keeps it.
"""

import dataclasses
import math
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import bench_torch
import learn_path_tracing_tpu.integrator.persistent as jpers
import learn_path_tracing_tpu_torch.integrator.persistent as tpers
from learn_path_tracing_tpu.integrator.persistent import render_persistent as j_render_persistent
from learn_path_tracing_tpu.models import random_scene as j_random_scene
from learn_path_tracing_tpu.models import stage10_camera as j_stage10_camera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent, schedule
from learn_path_tracing_tpu_torch.integrator.wavefront import render
from learn_path_tracing_tpu_torch.models import random_scene, stage10_camera
from learn_path_tracing_tpu_torch.models.standin import standin_camera, standin_world
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.scene import legacy_world as tlw
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES = (32, 18)
SEED = 20230328

SIZES = [(1280 * 720, 64), (480 * 240, 4), (32 * 18, 4), (30 * 20, 7), (2304, 16)]
KNOBS = [{}, {"pool_mult": 1}, {"pool_mult": 2}, {"pool_mult": 3}, {"pool_div": 2},
         {"pool_div": 16}, {"pool_div": 10 ** 6}, {"drain_ratio": 4},
         {"drain_ratio": 2, "drain_floor": 1024}, {"pool_mult": 1, "pool_div": 2}]
LEGACY_KNOBS = [{}, {"pool_mult": 2}, {"pool_div": 16}, {"drain_ratio": 4}]


@pytest.fixture(scope="module")
def jax_world():
    return j_random_scene(seed=SEED).device()


def _jax_schedule(jax_world, n, spp, knobs, monkeypatch, scene="spheres"):
    """``(pool, drain widths)`` of the JAX package's ``_persistent_core``,
    from the ray widths its trace generates, or the ``ValueError`` it
    raises. ``scene`` is what its schedule reads; the trace runs the sphere
    scene's hit and background functions (the widths do not depend on
    them)."""
    widths = []
    camera = jpers.generate_rays_for_pixels
    scene_fns = jpers._scene_fns

    def record(cam, resolution, pixel, *args, **kw):
        widths.append(int(pixel.shape[0]))
        return camera(cam, resolution, pixel, *args, **kw)

    monkeypatch.setattr(jpers, "generate_rays_for_pixels", record)
    monkeypatch.setattr(jpers, "_scene_fns", lambda _: scene_fns("spheres"))
    res = (n, 1)
    cam = j_stage10_camera(res).params()
    args = {"pool_mult": 0, "pool_div": 0, "drain_ratio": 8, "drain_floor": 0, **knobs}
    try:
        jax.make_jaxpr(lambda: jpers._persistent_core(
            jax_world, cam, res, n, 0, 0, spp, 2, 0, "modern", "thinlens", scene, "auto",
            args["pool_mult"], args["pool_div"], args["drain_ratio"], args["drain_floor"]))()
    except ValueError as e:
        return e
    pool = widths[0]
    levels = []
    for w in widths[1:]:
        if w != pool and w not in levels:
            levels.append(w)
    return pool, tuple(levels)


@pytest.mark.parametrize("n,spp", SIZES)
def test_schedule_matches_jax(jax_world, monkeypatch, n, spp):
    """Every knob on the sphere scene; on the legacy scene (whose auto pool
    is ``n``) the auto schedule and the pool overrides."""
    for scene, knobs_of_scene in (("spheres", KNOBS), ("legacy", LEGACY_KNOBS)):
        for knobs in knobs_of_scene:
            want = _jax_schedule(jax_world, n, spp, knobs, monkeypatch, scene)
            if isinstance(want, ValueError):
                with pytest.raises(ValueError) as got:
                    schedule(n, spp, **knobs, scene=scene)
                assert str(got.value) == str(want), knobs
                continue
            s = schedule(n, spp, **knobs, scene=scene)
            assert (s.pool, s.drain_widths) == want, (n, spp, knobs, scene)
            assert s.items_per == (math.ceil(n * spp / s.pool) if n % spp == 0 else spp)
            if scene == "legacy" and not knobs:
                assert s.pool == n


def test_schedule_rules():
    auto = schedule(1280 * 720, 64)
    assert (auto.pool, auto.drain_widths) == (57344, (7168, 1024, 256))
    s = schedule(1280 * 720, 64, pool_mult=1)
    assert (s.pool, s.items_per, s.drain_widths) == (921600, 64, (115200, 14592, 2048, 256))
    s = schedule(1280 * 720, 64, pool_div=2)
    assert (s.pool, s.items_per) == (460800, 128)
    with pytest.raises(ValueError, match="mutually exclusive"):
        schedule(576, 4, pool_mult=1, pool_div=2)
    with pytest.raises(ValueError, match="drain_ratio=0"):
        schedule(576, 4, drain_ratio=0)


# the existing sizes, one pixel count above the card's lane budget, and spp = 1
CARD_SIZES = SIZES + [(4096 * 4096, 16), (3000 * 2000, 7), (600, 1)]


@pytest.mark.parametrize("n,spp", CARD_SIZES)
def test_card_schedule_is_the_widest_grouped_pool_in_the_budget(n, spp):
    """The card's rule: on a CUDA device a grouped sphere render takes the
    widest ``q·n`` lanes, ``q | spp``, within ``CARD_POOL_LANES`` (each lane
    runs ``spp / q`` items, the drain levels are the JAX rule's from that
    pool: ``schedule``'s under ``pool_mult = q``); above the budget the pool
    halves from ``n`` until it fits, rounded to spp and aligned to
    ``POOL_ALIGN``. The CPU, ungrouped renders and the legacy scene keep the
    JAX rule; ``pool_mult``/``pool_div`` override both."""
    budget = tpers.CARD_POOL_LANES
    grouped = n % spp == 0
    assert tpers.pool_rule("cuda", n, spp) == ("card" if grouped else "jax")
    assert tpers.pool_rule(torch.device("cuda", 0), n, spp) == ("card" if grouped else "jax")
    assert tpers.pool_rule("cpu", n, spp) == "jax"
    assert tpers.pool_rule("cuda", n, spp, "legacy") == "jax"
    assert tpers.pool_rule("cuda", n, spp, "spheres", 1, 0) == "override"
    assert tpers.pool_rule("cuda", n, spp, "spheres", 0, 2) == "override"
    if not grouped:
        return
    for drain in ({}, {"drain_ratio": 4}, {"drain_ratio": 2, "drain_floor": 1024}):
        s = tpers.card_schedule(n, spp, **drain)
        assert s.grouped and s.pool <= budget
        if n <= budget:
            q = s.pool // n
            assert s.pool == q * n and spp % q == 0 and s.items_per == spp // q
            assert all(spp % d or d * n > budget for d in range(q + 1, spp + 1))
            assert s == schedule(n, spp, pool_mult=q, **drain)
        else:
            align = math.lcm(tpers.POOL_ALIGN, spp)
            assert s.pool % align == 0 and 2 * s.pool > budget - align
            assert s.items_per == math.ceil(n * spp / s.pool)
            ratio, floor = drain.get("drain_ratio", 8), drain.get("drain_floor", 256)
            widths, w = [], -(-(s.pool // ratio) // 256) * 256
            while floor <= w < (widths[-1] if widths else s.pool):
                widths.append(w)
                w = -(-(w // ratio) // 256) * 256
            assert s.drain_widths == tuple(widths)
    with pytest.raises(ValueError, match="drain_ratio=0"):
        tpers.card_schedule(n, spp, drain_ratio=0)


def test_card_schedule_rules(monkeypatch):
    """The cell's frame (1280x720, 8 spp) and the staged scripts' chunks on
    the card, and a pool halved to a small budget by hand."""
    assert tpers.CARD_POOL_LANES == 8 * 1024 * 1024
    s = tpers.card_schedule(1280 * 720, 8)
    assert (s.pool, s.items_per, s.drain_widths) == (
        7372800, 1, (921600, 115200, 14592, 2048, 256))
    assert tpers.card_schedule(1280 * 720, 256).items_per == 32
    assert tpers.card_schedule(1260 * 720, 7).pool == 7 * 907200
    with pytest.raises(ValueError, match="spp [|] n"):      # 7 does not divide 921,600
        tpers.card_schedule(1280 * 720, 7)
    assert tpers.card_schedule(1280 * 720, 12).pool == 6 * 921600
    assert tpers.card_schedule(3840 * 2160, 64).pool == 3840 * 2160
    monkeypatch.setattr(tpers, "CARD_POOL_LANES", 10_000)
    # 921,600 halved 7 times is 7,200; up to 64s, 7,232; down to 1,024s, 7,168
    s = tpers.card_schedule(1280 * 720, 64)
    assert (s.pool, s.items_per, s.drain_widths) == (7168, 8229, (1024, 256))
    # 19,600 halved once is 9,800, a multiple of 7; down to 7,168s (1,024 × 7)
    s = tpers.card_schedule(19_600, 7)
    assert (s.pool, s.items_per, s.drain_widths) == (7168, 20, (1024, 256))


def _port(knobs, limit, spp=4, **kw):
    img, segs, st = render_persistent(random_scene(seed=SEED).device("cpu"),
                                      stage10_camera(RES).params("cpu"), RES, spp=spp,
                                      limit=limit, stats=True, **knobs, **kw)
    return img, segs, st


@pytest.mark.parametrize("budget", [0, 500])
def test_card_pool_renders_the_jax_rules_frame(monkeypatch, budget):
    """With ``pool_rule`` answering 'card', as it does for a CUDA device,
    the CPU render takes ``card_schedule``'s pool (4 × 576 lanes, one item a
    lane; with a budget of 500 lanes, 576 halved to 288, eight items a
    lane) and gives the JAX rule's image and segments bit for bit, with one
    host read a pass and one more."""
    ref_img, ref_segs, ref_st = _port({}, limit=8)
    assert (ref_st["pool_rule"], ref_st["pool"]) == ("jax", 576)
    if budget:
        monkeypatch.setattr(tpers, "CARD_POOL_LANES", budget)
    monkeypatch.setattr(tpers, "pool_rule", lambda *a: "card")
    img, segs, st = _port({}, limit=8)
    want = tpers.card_schedule(576, 4)
    assert want.pool == (288 if budget else 2304)
    assert st["pool_rule"] == "card"
    assert (st["pool"], st["drain_widths"]) == (want.pool, want.drain_widths)
    assert segs == ref_segs and torch.equal(img.view(torch.int32), ref_img.view(torch.int32))
    passes = st["passes_full"] + sum(st["drain_passes"])
    assert st["host_reads"] == 1 + passes
    if not budget:
        assert passes < ref_st["passes_full"] + sum(ref_st["drain_passes"])


def test_card_pool_on_each_range_of_a_mesh(monkeypatch):
    """``parallel.mesh`` runs ``_persistent_core`` over each rank's pixel
    and sample range, with the rule of the range's device: two pixel tiles
    × two sample ranges under the card's rule add up to the whole frame's
    accumulator under the JAX rule, bit for bit, with its segments."""
    wd = random_scene(seed=SEED).device("cpu")
    cam = stage10_camera(RES).params("cpu")
    n = RES[0] * RES[1]
    args = (6, 0, "modern", "thinlens", "spheres", "auto")
    acc, segs, st = tpers._persistent_core(wd, cam, RES, n, 0, 0, 4, *args)
    assert st["pool_rule"] == "jax"
    monkeypatch.setattr(tpers, "pool_rule", lambda *a: "card")
    parts, part_segs = torch.zeros_like(acc), 0
    for tile in range(2):
        for half in range(2):
            a, sg, st = tpers._persistent_core(wd, cam, RES, n // 2, tile * n // 2, half * 2, 2,
                                               *args)
            assert st["pool_rule"] == "card"
            assert st["pool"] == tpers.card_schedule(n // 2, 2).pool == n
            parts[tile * n // 2:(tile + 1) * n // 2] += a
            part_segs += sg
    assert part_segs == segs and torch.equal(parts, acc)


@pytest.mark.parametrize("path", ["auto", "override", "ungrouped", "stage", "bench",
                                  "bench_override"])
def test_pool_rule_in_the_stats(tmp_path, path):
    """Every path into the modular engine reports the rule that set its pool
    beside the pool: the JAX rule on the CPU, 'override' under a pool knob."""
    from learn_path_tracing_tpu_torch.stages import s10_final

    if path in ("auto", "override", "ungrouped"):
        knobs = {"pool_div": 2} if path == "override" else {}
        _, _, st = _port(knobs, limit=2, spp=7 if path == "ungrouped" else 4)
        rule, pool = st["pool_rule"], st["pool"]
        assert pool == {"auto": 576, "override": 288, "ungrouped": 576}[path]
    elif path == "stage":
        _, rep = s10_final.main(["--width", "24", "--height", "16", "--spp", "4", "--limit",
                                 "4", "--device", "cpu", "--out", str(tmp_path / "s.png")])
        rule = rep["chunks"][0]["pool_rule"]
    else:
        row = bench_torch.run_cell(engine="persistent", resolution=RES, spp=4, limit=2,
                                   device="cpu", frames=1,
                                   pool_mult=2 if path == "bench_override" else 0)
        rule = row["schedule"]["pool_rule"]
    assert rule == ("override" if "override" in path else "jax")


RENDER_KNOBS = [{"pool_mult": 2}, {"pool_div": 2, "drain_ratio": 2},
                {"drain_unroll": 4, "drain_ratio": 2}]


@pytest.mark.parametrize("knobs", RENDER_KNOBS)
def test_render_knobs_match_auto_and_jax(knobs):
    auto_img, auto_segs, auto_st = _port({}, limit=8)
    img, segs, st = _port(knobs, limit=8)
    assert segs == auto_segs and torch.equal(img, auto_img)
    j_img, j_segs, j_st = j_render_persistent(
        j_random_scene(seed=SEED).device(), j_stage10_camera(RES).params(), RES, spp=4,
        limit=8, stats=True, **knobs)
    assert st["pool"] == int(j_st["pool"])
    assert st["drain_widths"] == tuple(int(w) for w in j_st["drain_widths"])
    rep = render_agreement(img.numpy(), np.asarray(j_img), segs, float(j_segs))
    assert rep["ok"], rep
    # no bounce: every pass and segment is JAX's exactly
    img1, segs1, st1 = _port(knobs, limit=1)
    _, j_segs1, j_st1 = j_render_persistent(
        j_random_scene(seed=SEED).device(), j_stage10_camera(RES).params(), RES, spp=4,
        limit=1, stats=True, **knobs)
    assert segs1 == int(j_segs1)
    assert st1["passes_full"] == int(j_st1["passes_full"])
    assert st1["drain_passes"] == tuple(int(p) for p in j_st1["drain_passes"])


def test_drain_unroll_reads_once_per_group():
    """``drain_unroll = k``: the full-width passes as before; each drain
    level's passes a multiple of k (its first level's the unroll-1 count
    rounded up to one), one host read per group, the same image."""
    base_img, base_segs, base = _port({"drain_ratio": 2}, limit=8)
    img, segs, st = _port({"drain_ratio": 2, "drain_unroll": 4}, limit=8)
    assert segs == base_segs and torch.equal(img, base_img)
    assert st["passes_full"] == base["passes_full"] and len(st["drain_passes"]) == 2
    assert all(p % 4 == 0 for p in st["drain_passes"])
    assert st["drain_passes"][0] == -(-base["drain_passes"][0] // 4) * 4
    assert st["host_reads"] == 1 + st["passes_full"] + sum(p // 4 for p in st["drain_passes"])
    assert base["host_reads"] == 1 + base["passes_full"] + sum(base["drain_passes"])


def test_knobs_equal_on_the_ungrouped_schedule_and_wavefront():
    """spp not dividing n: the auto pool; ``drain_ratio``/``drain_floor``
    allowed (no drain there), the pool knobs refused as in JAX."""
    img, segs, st = _port({"drain_ratio": 4, "drain_floor": 512}, limit=6, spp=7)
    ref, ref_segs = render(random_scene(seed=SEED).device("cpu"),
                           stage10_camera(RES).params("cpu"), RES, spp=7, limit=6)
    assert segs == ref_segs and st["drain_widths"] == ()
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="need spp"):
        _port({"pool_div": 2}, limit=6, spp=7)


@pytest.mark.parametrize("knob,value", [("pool_mult", 1), ("pool_div", 2), ("drain_ratio", 4),
                                        ("drain_floor", 1024), ("drain_unroll", 2)])
def test_mega_refuses_the_knobs(knob, value):
    with pytest.raises(ValueError, match=f"engine 'mega' takes only {knob}="):
        _port({knob: value}, limit=2, engine="mega")


def test_bench_pool_flags(capsys):
    row = bench_torch.run_cell(engine="persistent", resolution=RES, spp=4, limit=4,
                               device="cpu", frames=1, pool_mult=2)
    auto = bench_torch.run_cell(engine="persistent", resolution=RES, spp=4, limit=4,
                                device="cpu", frames=1)
    assert row["schedule"]["pool"] == 2 * RES[0] * RES[1] == 2 * auto["schedule"]["pool"]
    assert set(row["schedule"]) == {"pool", "pool_rule", "passes_full", "drain_widths",
                                    "drain_passes", "host_reads"}
    assert row["segments"] == auto["segments"] and torch.equal(row["image"], auto["image"])
    mega = bench_torch.run_cell(engine="mega", resolution=RES, spp=4, limit=4, device="cpu",
                                frames=1)
    assert set(mega["schedule"]) == {"passes", "host_reads"}
    with pytest.raises(ValueError, match="hybrid engine does not take them"):
        bench_torch.run_cell(resolution=RES, pool_div=2, device="cpu", engine="hybrid")
    for argv in (["--engine", "hybrid", "--pool-mult", "1"],
                 ["--engine", "mega", "--pool-div", "2"],
                 ["--scene", "yoimiya", "--pool-div", "2"]):
        with pytest.raises(SystemExit) as e:
            bench_torch.main(argv + ["--device", "cpu"])
        assert e.value.code == 2
    assert "--pool-mult/--pool-div" in capsys.readouterr().err


# ------------------------------------------------------ the mesh path's knobs --

@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The stand-in world at level 3 (its top two BVH levels full, so
    blocks of coherent rays can be seeded)."""
    d = tmp_path_factory.mktemp("standin")
    world = standin_world(str(d), level=3, tex_size=64, env_size=(128, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    return world


def _build(world, monkeypatch, bf16):
    if bf16:
        monkeypatch.setenv("LPT_PACKET_BF16", "1")
    else:
        monkeypatch.delenv("LPT_PACKET_BF16", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.build()
    monkeypatch.delenv("LPT_PACKET_BF16", raising=False)
    return wd


def _hybrid(wd, **kw):
    cam = standin_camera((64, 64)).params()
    return render_hybrid(wd, cam, (64, 64), spp=2, limit=6, seed=2, camera_model="jitter",
                         pool_w=4096, stats=True, **kw)


def test_restart_frame_is_the_default_frame(standin, monkeypatch):
    """``LPT_TREELET_RESTART=1``: the hybrid's pool passes and the wavefront
    engine's hits take ``packet_traverse_sorted(restart=True)``; both frames
    are the default ones bit for bit. (At this size every 1024-ray block
    enters more than 8 treelets, so the JAX package's block rows would walk
    each from the root; most rays are seeded from their own treelets.)"""
    wd = _build(standin, monkeypatch, bf16=False)
    monkeypatch.delenv("LPT_TREELET_RESTART", raising=False)
    ref_img, ref_segs, _ = _hybrid(wd)
    cam = standin_camera((64, 64)).params()
    wf = dict(spp=1, limit=4, seed=1, bsdf="legacy", scene="legacy", camera_model="jitter")
    ref_wf = render(wd, cam, (64, 64), **wf)

    rows, seeded = [], [0, 0]
    walk, step = tlw.packet_traverse_sorted, tpt.traverse

    def counted(*args, restart=False, **kw):
        rows.append(restart)
        return walk(*args, restart=restart, **kw)

    def seeds_counted(*args, seeds=None, **kw):
        if seeds is not None:
            seeded[0] += int(((seeds.counts() <= 8) & args[6]).sum())
            seeded[1] += int(args[6].sum())
        return step(*args, seeds=seeds, **kw)

    seeds_counted.launches, seeds_counted.lanes = step.launches, step.lanes
    monkeypatch.setattr(tlw, "packet_traverse_sorted", counted)
    monkeypatch.setattr(tpt, "traverse", seeds_counted)
    monkeypatch.setenv("LPT_TREELET_RESTART", "1")
    img, segs, _ = _hybrid(wd)
    assert rows and all(rows)
    assert segs == ref_segs and torch.equal(img, ref_img)
    assert seeded[0] > seeded[1] // 2
    rows.clear()
    img_wf, segs_wf = render(wd, cam, (64, 64), **wf)
    assert rows and all(rows)
    assert segs_wf == ref_wf[1] and torch.equal(img_wf, ref_wf[0])
    # a world the restart does not take (version 1) runs as before
    rows.clear()
    img1, segs1, _ = _hybrid(dataclasses.replace(wd, packet_version=1))
    assert rows and not any(rows)
    assert segs1 == ref_segs and torch.equal(img1, ref_img)


def test_bf16_world_frame(standin, monkeypatch):
    """``LPT_PACKET_BF16=1`` at build time: the mesh's node table is
    ``nodes_to_bf16`` of the f32 one and the treelet boxes are the f32 ones;
    unset, the tables are f32. The bf16 frame is not the f32 frame: the
    bf16 ray terms (``bf(ro/rd)``, off by ~|ro/rd|·2^-9) drop short bounce
    hits (``test_torch_k2_modes.test_bf16_surface_rays_against_jax``), ~1 %
    of the segments at this size, so it is held to the image bounds of
    ``render_agreement`` (mean absolute difference at most 1 % of the
    mean, 80 % of pixels within 1e-4) and its segments to 2 %, not 0.5 %."""
    from learn_path_tracing_tpu_torch.ops.packet_traverse import nodes_to_bf16

    ref = _build(standin, monkeypatch, bf16=False)
    wd = _build(standin, monkeypatch, bf16=True)
    m, r = wd.meshes[0], ref.meshes[0]
    assert r.packet[0].dtype == torch.float32 and m.packet[0].dtype == torch.bfloat16
    assert torch.equal(m.packet[0].view(torch.int16), nodes_to_bf16(r.packet[0]).view(torch.int16))
    for a, b in zip(m.treelets, r.treelets):
        assert torch.equal(a, b)
    img, segs, _ = _hybrid(wd)
    ref_img, ref_segs, _ = _hybrid(ref)
    rep = render_agreement(img.numpy(), ref_img.numpy(), segs, ref_segs)
    print(rep)
    assert rep["finite"] and rep["mean_abs_frac"] <= 0.01 and rep["pixels_agree"] >= 0.8
    assert rep["segments_rel"] <= 0.02
    assert "LPT_PACKET_BF16" not in os.environ


def test_bf16_world_tables_match_jax_and_convert(tmp_path, monkeypatch):
    """Built under ``LPT_PACKET_BF16=1``, the port's mesh node table is the
    JAX package's bf16 table bit for bit (the treelet boxes f32 in both),
    and ``convert.legacy_world_from_numpy`` of the JAX world keeps it
    bf16."""
    from learn_path_tracing_tpu_torch import convert
    from test_torch_legacy import _build_both, _same

    monkeypatch.setenv("LPT_PACKET_BF16", "1")
    _, jwd, _, twd = _build_both(tmp_path, "ibl")
    cwd = convert.legacy_world_from_numpy(jax.tree_util.tree_map(np.asarray, jwd))
    for m, jm in zip(twd.meshes, jwd.meshes):
        jbits = np.asarray(jm.packet[0]).view(np.uint16)
        for wd in (twd, cwd):
            nodes = wd.meshes[0].packet[0]
            assert nodes.dtype == torch.bfloat16
            np.testing.assert_array_equal(nodes.view(torch.int16).numpy().view(np.uint16), jbits)
        for a, b in zip(m.treelets, jm.treelets):
            assert a.dtype == torch.float32 and _same(a, b)


def test_legacy_auto_pool_is_the_jax_packages(standin, monkeypatch):
    """``render_persistent(scene='legacy')`` takes the JAX package's legacy
    auto pool, ``n`` lanes (30,400 here, where the sphere rule gives 29,696):
    the image and segments of the sphere rule's pool bit for bit (the
    schedule only changes which lane traces which sample), and at limit 1
    (no bounce: every pass consumes one item a lane, whatever it hits) the
    pool, drain widths and passes of every level of the JAX package's
    ``_persistent_core`` under ``scene='legacy'`` (traced with the sphere
    scene's hit functions, which the schedule does not read)."""
    import learn_path_tracing_tpu_torch.integrator.persistent as tpers

    wd = _build(standin, monkeypatch, bf16=False)
    res = (160, 190)
    n = res[0] * res[1]
    cam = standin_camera(res).params()
    kw = dict(spp=2, seed=3, bsdf="legacy", camera_model="jitter", scene="legacy",
              stats=True)
    img, segs, st = render_persistent(wd, cam, res, limit=2, **kw)
    assert st["pool"] == n
    rule = tpers.schedule
    monkeypatch.setattr(tpers, "schedule",
                        lambda n, spp, *a: rule(n, spp, *a[:4], "spheres"))
    old_img, old_segs, old_st = render_persistent(wd, cam, res, limit=2, **kw)
    monkeypatch.setattr(tpers, "schedule", rule)
    assert old_st["pool"] == 29696     # and one pass more (3 + 1 against 3 + 0)
    assert old_st["passes_full"] + sum(old_st["drain_passes"]) > (
        st["passes_full"] + sum(st["drain_passes"]))
    assert segs == old_segs and torch.equal(img.view(torch.int32), old_img.view(torch.int32))

    _, _, st1 = render_persistent(wd, cam, res, limit=1, **kw)
    scene_fns = jpers._scene_fns
    monkeypatch.setattr(jpers, "_scene_fns", lambda _: scene_fns("spheres"))
    _, _, j_st = j_render_persistent(j_random_scene(seed=SEED).device(),
                                     j_stage10_camera(res).params(), res, spp=2, limit=1,
                                     seed=3, scene="legacy", stats=True)
    assert st1["pool"] == int(j_st["pool"]) == n
    assert st1["drain_widths"] == tuple(int(w) for w in j_st["drain_widths"])
    assert st1["passes_full"] == int(j_st["passes_full"])
    assert st1["drain_passes"] == tuple(int(p) for p in j_st["drain_passes"])
