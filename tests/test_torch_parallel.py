"""The port's multi-device rendering (``parallel.mesh`` on
``torch.distributed``) on the CPU: four gloo ranks started once by
``parallel.launch`` for every sharded case, against the port's single-device
renders and the JAX package's sharded functions on the virtual 8-device CPU
mesh of ``conftest.py`` (four of its devices).

Tolerances, with their reasons:

- Persistent and hybrid, tile and spp splits (the forced small ``cap``
  included): the image bit for bit the single-device render's and the
  segments equal. Each rank accumulates its samples in int64 fixed point,
  whose sum does not depend on its order, and the RNG keys on absolute
  (pixel, sample).
- Wavefront: the tile split bit for bit (each pixel's samples are added in
  the single-device order), the spp split within rtol 1e-5, atol 1e-6 (the
  ranks' f32 partial sums are added in another order; JAX's test holds its
  own spp split to the same bound), segments equal.
- Against the JAX package's sharded functions (its default CPU path):
  ``utils.checks.render_agreement``, the bound of the matching
  single-device port tests (JAX's XLA quadratic and triangle test differ by
  ulps that flip a few discrete events).
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

import bench_torch
from learn_path_tracing_tpu.camera import Camera as JCamera
from learn_path_tracing_tpu.camera import LegacyCamera as JLegacyCamera
from learn_path_tracing_tpu.io.obj import MeshData as JMeshData
from learn_path_tracing_tpu.models import stage8_scene as j_stage8_scene
from learn_path_tracing_tpu.parallel import make_mesh as j_make_mesh
from learn_path_tracing_tpu.parallel import mesh as j_mesh
from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld as JLegacyWorld
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator.hybrid import _hybrid_core, render_hybrid
from learn_path_tracing_tpu_torch.integrator.persistent import (_persistent_core, radiance,
                                                                render_persistent)
from learn_path_tracing_tpu_torch.integrator.wavefront import render, trace_sample_pixels
from learn_path_tracing_tpu_torch.models import stage8_scene
from learn_path_tracing_tpu_torch.parallel import launch as launch_mod
from learn_path_tracing_tpu_torch.parallel import mesh
from learn_path_tracing_tpu_torch.parallel.dryrun import (SMALL_CAP, dryrun_multichip,
                                                          legacy_mini_world)
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES, SPP, LIMIT, SEED = (40, 24), 4, 6, 5
PAD_RES, PAD_SPP, PAD_LIMIT = (17, 11), 2, 4       # 187 pixels: 4 tiles of 47
LEGACY = dict(bsdf="legacy", scene="legacy")
# bench_torch.sharded_cells: (scene, engine, resolution, spp, n_spp) at a
# small size; the 'yoimiya' cell renders the mini-world saved by the fixture
BENCH_RES, BENCH_LIMIT = (16, 8), 3
BENCH_CELLS = [(scene, engine, BENCH_RES, 2, n_spp) for n_spp in (1, 2)
               for scene, engine in (("yoimiya", "hybrid"), ("10_final", "persistent"),
                                     ("10_final", "wavefront"))]


def _spheres(res=RES):
    cam = Camera(res)
    cam.set_position((0, 0.4, 4))
    return stage8_scene().device("cpu"), cam.params("cpu")


def _legacy():
    world, cam = legacy_mini_world(RES)
    return world.device("cpu"), cam.params("cpu")


def _calls(world_path):
    """Every sharded case of the four-rank job: ``name → (fn, args, kwargs,
    mesh shape)``; ``world_path`` is the mini-world's ``.world.npy``."""
    s, l = _spheres(), _legacy()
    run = dict(limit=LIMIT, seed=SEED)
    wf, pe, hy = (mesh.render_multichip, mesh.render_persistent_multichip,
                  mesh.render_hybrid_multichip)
    return {
        "wavefront 4x1": (wf, (*s, RES, SPP), run, (4, 1)),
        "wavefront 2x2": (wf, (*s, RES, SPP), run, (2, 2)),
        "wavefront legacy 4x1": (wf, (*l, RES, SPP), {**run, **LEGACY}, (4, 1)),
        "wavefront padding": (wf, (*s, PAD_RES, PAD_SPP), dict(limit=PAD_LIMIT, seed=3),
                              (4, 1)),
        "persistent 4x1": (pe, (*s, RES, SPP), run, (4, 1)),
        "persistent 2x2": (pe, (*s, RES, SPP), run, (2, 2)),
        "persistent legacy 4x1": (pe, (*l, RES, SPP), {**run, **LEGACY}, (4, 1)),
        "hybrid 4x1": (hy, (*l, RES, SPP), run, (4, 1)),
        "hybrid 2x2": (hy, (*l, RES, SPP), run, (2, 2)),
        "hybrid small cap 2x2": (hy, (*l, RES, SPP), {**run, "cap": SMALL_CAP}, (2, 2)),
        "mesh 3x3": (mesh.make_mesh, (3, 3), {}, None),
        "persistent tiles": (pe, (*s, (41, 7), SPP), run, (4, 1)),
        "persistent spp": (pe, (*s, RES, 3), run, (2, 2)),
        "hybrid tiles": (hy, (*l, (41, 7), SPP), run, (4, 1)),
        "hybrid spp": (hy, (*l, RES, 3), run, (2, 2)),
        "hybrid backend": (hy, (*l, RES, SPP), {**run, "hit_backend": "nope"}, (4, 1)),
        "hybrid backend pallas": (hy, (*l, RES, SPP), {**run, "hit_backend": "pallas"},
                                  (4, 1)),
        "persistent pool_mult 2x2": (pe, (*s, RES, SPP), {**run, "pool_mult": 2}, (2, 2)),
        "persistent pool_div 4x1": (pe, (*s, RES, SPP), {**run, "pool_div": 2,
                                                         "drain_ratio": 2}, (4, 1)),
        "persistent pool_mult spp": (pe, (*s, RES, SPP), {**run, "pool_mult": 4}, (2, 2)),
        "bench cells": (bench_torch.sharded_cells,
                        (BENCH_CELLS, BENCH_LIMIT, "cpu", world_path,
                         os.path.dirname(world_path)), {}, None),
    }


@pytest.fixture(scope="module")
def world_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("world") / "mini.world.npy")
    legacy_mini_world()[0].save(path)
    return path


@pytest.fixture(scope="module")
def sharded(world_path):
    """Rank 0's result of every case, from one job of four gloo ranks."""
    calls = _calls(world_path)
    out = launch_mod.launch(4, launch_mod.run_calls, list(calls.values()), device="cpu")
    return dict(zip(calls, out))


def _ok(sharded, name):
    kind, value = sharded[name]
    assert kind == "ok", (name, value)
    img, segs = value
    return img, segs


def _single(engine, res=RES, spp=SPP):
    if engine == "wavefront":
        return render(*_spheres(res), res, spp, limit=LIMIT, seed=SEED)
    if engine == "persistent":
        return render_persistent(*_spheres(res), res, spp, limit=LIMIT, seed=SEED)
    return render_hybrid(*_legacy(), res, spp, limit=LIMIT, seed=SEED)


@pytest.mark.parametrize("engine", ["wavefront", "persistent", "hybrid"])
def test_tile_split_is_single_device_bitwise(sharded, engine):
    img, segs = _ok(sharded, f"{engine} 4x1")
    ref, ref_segs = _single(engine)
    assert segs == ref_segs and torch.equal(img, ref)


@pytest.mark.parametrize("engine", ["wavefront", "persistent", "hybrid"])
def test_spp_split_matches_single_device(sharded, engine):
    img, segs = _ok(sharded, f"{engine} 2x2")
    ref, ref_segs = _single(engine)
    assert segs == ref_segs
    if engine == "wavefront":
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(img, ref)


@pytest.mark.parametrize("engine", ["wavefront", "persistent"])
def test_legacy_tile_split_is_single_device_bitwise(sharded, engine):
    img, segs = _ok(sharded, f"{engine} legacy 4x1")
    fn = render if engine == "wavefront" else render_persistent
    ref, ref_segs = fn(*_legacy(), RES, SPP, limit=LIMIT, seed=SEED, **LEGACY)
    assert segs == ref_segs and torch.equal(img, ref)


def test_hybrid_sharded_takes_jax_hit_backends(sharded):
    """A backend name the JAX package takes ('pallas', its TPU kernel) is
    accepted and read by neither package: the render is the default one."""
    img, segs = _ok(sharded, "hybrid backend pallas")
    ref, ref_segs = _single("hybrid")
    assert segs == ref_segs and torch.equal(img, ref)


def test_hybrid_small_cap_sharded_is_single_device_bitwise(sharded):
    img, segs = _ok(sharded, "hybrid small cap 2x2")
    ref, ref_segs = _single("hybrid")
    assert segs == ref_segs and torch.equal(img, ref)


def test_padding_over_four_tiles(sharded):
    """17x11 = 187 pixels over 4 tiles of 47: the padding's radiance is
    dropped (bit for bit the single-device image); its rays are traced and
    counted, as in the JAX package."""
    img, segs = _ok(sharded, "wavefront padding")
    ref, ref_segs = render(*_spheres(PAD_RES), PAD_RES, PAD_SPP, limit=PAD_LIMIT, seed=3)
    assert img.shape == (17, 11, 3) and torch.equal(img, ref)
    assert segs >= ref_segs


@pytest.mark.parametrize("index", range(len(BENCH_CELLS)))
def test_bench_sharded_cells_match_single_device(sharded, world_path, index):
    """``bench_torch.sharded_cells`` (the multi-card job of ``chip_smoke.py``)
    on four ranks as 4 tiles and as 2 tiles x 2 spp: each frame is the
    single-device render of the bench's scene, bit for bit (the wavefront's
    spp split within rtol 1e-5, atol 1e-6), with equal segments."""
    kind, (frames, _) = sharded["bench cells"]
    assert kind == "ok"
    scene, engine, res, spp, n_spp = BENCH_CELLS[index]
    wd, cp, scene_kind, bsdf, cam_model = bench_torch.cell_scene(
        scene, res, "cpu", world_path, os.path.dirname(world_path))
    fn = {"hybrid": render_hybrid, "persistent": render_persistent, "wavefront": render}[engine]
    ref, ref_segs = fn(wd, cp, res, spp, limit=BENCH_LIMIT, bsdf=bsdf, camera_model=cam_model,
                       scene=scene_kind)[:2]
    img, segs = frames[index]["image"], frames[index]["segments"]
    assert segs == ref_segs and frames[index]["seconds"] > 0
    if engine == "wavefront" and n_spp > 1:
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(img, ref)


def test_bench_sharded_cells_time_the_collectives(sharded):
    """One entry a mesh shape, the spp axis's sum only where it has two
    ranks, each a positive time."""
    _, (_, collectives) = sharded["bench cells"]
    assert set(collectives) == {"4x1", "2x2"}
    assert set(collectives["4x1"]) == {"all_gather_into_tensor tile", "all_reduce all ranks"}
    assert set(collectives["2x2"]) == {"all_reduce spp", "all_gather_into_tensor tile",
                                       "all_reduce all ranks"}
    assert all(ms > 0 for t in collectives.values() for ms in t.values())


def test_mesh_validation(sharded):
    kind, msg = sharded["mesh 3x3"]
    assert kind == "ValueError" and "3x3" in msg and "4 ranks" in msg


@pytest.mark.parametrize("name", ["persistent pool_mult 2x2", "persistent pool_div 4x1"])
def test_pool_knobs_sharded_are_single_device_bitwise(sharded, name):
    """``render_persistent_multichip``'s pool and drain knobs, applied to
    each rank's range-local schedule: the single-device auto image bit for
    bit, with its segments."""
    img, segs = _ok(sharded, name)
    ref, ref_segs = _single("persistent")
    assert segs == ref_segs and torch.equal(img, ref)


@pytest.mark.parametrize("name,match", [
    ("persistent pool_mult spp", "pool_mult=4 must divide spp=2"),
    ("persistent tiles", "tile axis 4"), ("persistent spp", "spp=3"),
    ("hybrid tiles", "tile axis 4"), ("hybrid spp", "spp=3"),
    ("hybrid backend", "hit_backend")])
def test_split_errors(sharded, name, match):
    kind, msg = sharded[name]
    assert kind == "ValueError" and match in msg, (kind, msg)


def _jax_legacy():
    world = JLegacyWorld()
    world.add_mesh(JMeshData(
        positions=np.array([[-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]], np.float32),
        normals=np.array([[0, 0, 1]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.array([[0, 0, 0], [0, 0, 0]], np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.array([0, 0], np.int32)))
    world.add_sphere((0, 1, 2), 0.5, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.build()
    cam = JLegacyCamera(RES)
    cam.set_fov(30)
    cam.set_position((0, 1, 6))
    cam.look_at((0, 1, 0))
    return wd, cam.params()


def _jax_spheres(res=RES):
    cam = JCamera(res)
    cam.set_position((0, 0.4, 4))
    return j_stage8_scene().device(), cam.params()


@pytest.mark.parametrize("engine", ["wavefront", "persistent", "hybrid"])
def test_tile_split_agrees_with_jax_sharded(sharded, engine):
    img, segs = _ok(sharded, f"{engine} 4x1")
    jm = j_make_mesh(n_tile=4, n_spp=1, devices=jax.devices()[:4])
    if engine == "wavefront":
        j_img, j_segs = j_mesh.render_multichip(*_jax_spheres(), RES, SPP, jm, limit=LIMIT,
                                                seed=SEED)
    elif engine == "persistent":
        j_img, j_segs = j_mesh.render_persistent_multichip(*_jax_spheres(), RES, SPP, jm,
                                                           limit=LIMIT, seed=SEED)
    else:   # jitted as a whole: op by op, shard_map would dispatch every pass
        hybrid = jax.jit(j_mesh.render_hybrid_multichip,
                         static_argnames=("resolution", "spp", "mesh", "limit"))
        j_img, j_segs = hybrid(*_jax_legacy(), resolution=RES, spp=SPP, mesh=jm,
                               limit=LIMIT, seed=SEED)
    rep = render_agreement(img.numpy(), np.asarray(j_img), segs, float(j_segs))
    assert rep["ok"], rep


def test_padding_agrees_with_jax_sharded(sharded):
    img, segs = _ok(sharded, "wavefront padding")
    jm = j_make_mesh(n_tile=4, n_spp=1, devices=jax.devices()[:4])
    j_img, j_segs = j_mesh.render_multichip(*_jax_spheres(PAD_RES), PAD_RES, PAD_SPP, jm,
                                            limit=PAD_LIMIT, seed=3)
    rep = render_agreement(img.numpy(), np.asarray(j_img), segs, float(j_segs))
    assert rep["ok"], rep


def _split_2x2(core):
    """``core(pixel_base, sample_base, n_local, spp_local) -> (acc, segs)``
    for each coordinate of a 2 tile x 2 spp split in this process, combined
    as the collectives combine them (sum over spp, tiles in order)."""
    n, tiles, segments = RES[0] * RES[1], [], 0
    for t in range(2):
        parts = []
        for s in range(2):
            acc, segs = core(t * n // 2, s * SPP // 2, n // 2, SPP // 2)
            parts.append(acc)
            segments += segs
        tiles.append(parts[0] + parts[1])
    return torch.cat(tiles), segments


@pytest.mark.parametrize("engine", ["wavefront", "persistent", "hybrid"])
def test_range_local_integrators_per_coordinate(engine):
    """The range-local integrators called for each coordinate of a 2x2 split
    in one process: persistent and hybrid (a small ``cap``, so that its
    make-room merges run in every range) bit for bit the single-device
    image, the wavefront within the spp split's bound; segments equal."""
    w, h = RES
    stats = []
    if engine == "wavefront":
        wd, cam = _spheres()

        def core(p0, s0, n, spp):
            acc, segs = torch.zeros((n, 3)), 0
            for k in range(spp):
                rad, sg = trace_sample_pixels(wd, cam, RES, torch.arange(p0, p0 + n), SEED,
                                              s0 + k, LIMIT)
                acc, segs = acc + rad, segs + sg
            return acc, segs
    elif engine == "persistent":
        wd, cam = _spheres()

        def core(p0, s0, n, spp):
            acc, segs, _ = _persistent_core(wd, cam, RES, n, p0, s0, spp, LIMIT, SEED,
                                            "modern", "thinlens", "spheres", "auto")
            return acc, segs
    else:
        wd, cam = _legacy()

        def core(p0, s0, n, spp):
            acc, segs, st = _hybrid_core(wd, cam, RES, n, p0, s0, spp, LIMIT, SEED, "legacy",
                                         "jitter", 0, SMALL_CAP, 0, 2)
            stats.append(st)
            return acc, segs
    acc, segs = _split_2x2(core)
    ref, ref_segs = _single(engine)
    img = (acc / SPP if engine == "wavefront" else radiance(acc) / SPP).reshape(w, h, 3)
    assert segs == ref_segs
    if engine == "wavefront":
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(img, ref)
    if engine == "hybrid":   # more survivors than one batch in every range: merges
        assert all(st["primary_hits"] > SMALL_CAP for st in stats), stats


def test_entry_renders_the_cover_pass_as_jax():
    """``parallel.dryrun.entry``: one pass of the 10_final cover scene at
    64x36, spp 2, limit 8, against the JAX package's ``__graft_entry__``
    (its XLA path) by ``render_agreement``."""
    import __graft_entry__

    from learn_path_tracing_tpu_torch.parallel.dryrun import entry

    fn, args = entry("cpu")
    img, segs = fn(*args)
    j_fn, j_args = __graft_entry__.entry()
    j_img, j_segs = jax.jit(j_fn)(*j_args)
    assert img.shape == (64, 36, 3)
    rep = render_agreement(img.numpy(), np.asarray(j_img), segs, float(j_segs))
    assert rep["ok"], rep


def test_dryrun_multichip_on_two_ranks():
    report = dryrun_multichip(2, "cpu")
    assert report["mesh"] == {"tile": 1, "spp": 2}
    runs = [k for k in report if k != "mesh"]
    assert len(runs) == 6 and all(report[k]["segments"] > 0 for k in runs)
    assert (report["hybrid legacy"]["segments"] == report["hybrid legacy small cap"]["segments"]
            == report["persistent legacy"]["segments"])


def test_launch_on_cuda_needs_a_card_a_rank(monkeypatch):
    """No card: the launcher, the dry run and the CLI's ``multichip`` (whose
    ``--device`` defaults to cuda) raise, with no CPU fallback. Cards: one
    rank a card at most (NCCL refuses two ranks on one card)."""
    from learn_path_tracing_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: launch_mod.launch(1, launch_mod.run_calls, [], device="cuda"),
                lambda: dryrun_multichip(2, "cuda"),
                lambda: main(["multichip", "--nproc", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank a card"):
        launch_mod.launch(2, launch_mod.run_calls, [], device="cuda")
