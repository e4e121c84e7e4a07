"""The port's legacy stages 11, 12 and 15, the progressive renderer on
sphere scenes, ``LegacyWorld.load(rebuild_bvh=False, textures_from_obj=…)``
and ``companion_obj_for``, against the JAX package on the CPU at 32x18,
spp 4, limit 8.

Tolerances, with their reasons:

- Host-side data (l11's sphere tables, l15's world tables, the loaded
  worlds' tables and texture configs, the companion OBJ paths): byte for
  byte or equal (the same numpy and Python operations).
- The port against itself: l11 under ``--hit-backend bvh`` and ``auto``
  bit for bit, segments equal (the walk finds the scan's hits).
- Frames against the JAX package's: ``utils.checks.render_agreement``
  (segments within 0.5 %, mean absolute difference at most 1 % of the
  mean, at least 80 % of pixels within 1e-4): a few ulps between the two
  implementations flip a few discrete events a render. The JAX side's
  l11 frame scans the spheres with its Pallas kernel in interpret mode
  (``hit_backend='pallas'``), the kernel the port's K1 replaces, whose pair
  test the port's repeats; so does its renderer's under l12's script.
  JAX's CPU default (the XLA formulation, ``c = o·o - 2
  o·c + (c·c - r²)``) is more exact on this world's r = 10000 ground,
  where ``oc·oc`` is ~1e8 and an f32 ulp of it is 8: measured at 32x18,
  its ground ``t`` is within 2.4e-4 of an f64 solve where the kernel's
  (and the port's) is within 0.061, enough to move a bounce's origin and
  fail the agreement bounds (3.6 % mean difference at spp 4).
- l12's camera after a script: within 4 ulps of JAX's (the camera tests'
  tolerance; both are Python float arithmetic rounded once to f32). Its
  spp sequence: equal.
"""

import functools
import os
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import learn_path_tracing_tpu.ops.sphere_scan as jss
import learn_path_tracing_tpu.viewer.progressive as jprog
from learn_path_tracing_tpu.camera import LegacyCamera as JLegacyCamera
from learn_path_tracing_tpu.integrator.wavefront import render as j_render
from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld as JLegacyWorld
from learn_path_tracing_tpu.stages import l11_bvh as jl11
from learn_path_tracing_tpu.stages import l12_free_view as jl12
from learn_path_tracing_tpu.stages import l15_module as jl15
from learn_path_tracing_tpu.stages import legacy_common as jlc
from learn_path_tracing_tpu_torch.camera import LegacyCamera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.io.obj import load_obj
from learn_path_tracing_tpu_torch.scene import serialize
from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
from learn_path_tracing_tpu_torch.stages import l11_bvh, l12_free_view, l15_module
from learn_path_tracing_tpu_torch.stages import legacy_common as tlc
from learn_path_tracing_tpu_torch.utils.checks import render_agreement
from learn_path_tracing_tpu_torch.viewer.progressive import ProgressiveRenderer

torch.set_num_threads(2)

RES, SPP, LIMIT = (32, 18), 4, 8
SMALL = ["--width", "32", "--height", "18", "--spp", "4", "--limit", "8", "--device", "cpu"]


@pytest.fixture
def jax_scan_interpreted(monkeypatch):
    """JAX's 'pallas' sphere hits through its Pallas kernel in interpret
    mode, as the JAX package's tests run it on the CPU."""
    monkeypatch.setattr(jss, "intersect_spheres_pallas",
                        functools.partial(jss.intersect_spheres_pallas, interpret=True))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.contiguous().numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_legacy_tables_equal(twd, jwd):
    assert len(twd.meshes) == len(jwd.meshes)
    for m, jm in zip(twd.meshes, jwd.meshes):
        for a, b in zip(m.packet + m.treelets, jm.packet + jm.treelets):
            assert _same(a, b)
        for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "tex"):
            assert _same(getattr(m, k), getattr(jm, k)), k
    assert _same(twd.tri_attr, jwd.tri_attr)
    assert (twd.spheres is None) == (jwd.spheres is None)
    for k in ("atlas", "envs"):
        for f in ("table", "info_low", "info_high", "base", "spr", "info"):
            assert _same(getattr(getattr(twd, k), f), getattr(getattr(jwd, k), f)), (k, f)
    assert twd.env_id == int(jwd.env_id) and twd.env_gradient_h == jwd.env_gradient_h


# ------------------------------------------------------------------ l11 --

def test_l11_sphere_tables_match_jax():
    twd = l11_bvh.legacy_random_scene().device("cpu", use_bvh=True)
    jwd = jl11.legacy_random_scene().device(use_bvh=True)
    assert _same(twd.centers, jwd.centers) and _same(twd.radii, jwd.radii)
    for f in ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity"):
        assert _same(getattr(twd.materials, f), getattr(jwd.materials, f)), f


def test_l11_backends_bitwise_and_against_jax(tmp_path, jax_scan_interpreted):
    img_a, rep_a = l11_bvh.main(SMALL + ["--out", str(tmp_path / "a.png")])
    img_b, rep_b = l11_bvh.main(SMALL + ["--hit-backend", "bvh", "--out", str(tmp_path / "b.png")])
    assert rep_a["segments"] == rep_b["segments"]
    assert torch.equal(rep_a["linear"].view(torch.int32), rep_b["linear"].view(torch.int32))
    assert os.path.exists(tmp_path / "a.png") and img_a.shape == (32, 18, 3)

    cam = JLegacyCamera(RES)
    cam.set_fov(20)
    cam.set_len(10, 0.1)
    cam.set_position((15 * np.cos(1e-4), 2, 15 * np.sin(1e-4)))
    cam.look_at((0, 0, 0))
    jimg, jsegs = j_render(jl11.legacy_random_scene().device(), cam.params(), RES, spp=SPP,
                           limit=LIMIT, seed=0, bsdf="legacy", hit_backend="pallas")
    rep = render_agreement(rep_a["linear"].numpy(), np.asarray(jimg), rep_a["segments"],
                           float(jsegs))
    assert rep["ok"], rep


# ------------------------------------------------------------------ l12 --

def _j_script(jwd, cam, backend, script):
    """JAX's ProgressiveRenderer over ``script``'s moves: ``(renderer, spp
    after each keyframe, each batch's segments)``."""
    segs, spp = [], []
    real = jprog.render_accumulate

    def counted(*a, **kw):
        acc, s = real(*a, **kw)
        segs.append(float(s))
        return acc, s

    jprog.render_accumulate = counted
    try:
        jpr = jprog.ProgressiveRenderer(jwd, cam, RES, spp_per_frame=SPP, limit=LIMIT,
                                        bsdf="legacy", scene="spheres", hit_backend=backend)
        for token in script.split(","):
            jpr.render(moved=jl12.apply_move(cam, token))
            spp.append(jpr.spp)
    finally:
        jprog.render_accumulate = real
    return jpr, spp, segs


def _start(cls):
    cam = cls(RES)
    cam.set_fov(20)
    cam.set_position((13, 2, 3))
    cam.look_at((0, 0, 0))
    return cam


@pytest.fixture(scope="module")
def j_l11_world():
    """JAX's l11 world: the JAX side of the renderer and l12 tests, both
    through its interpreted Pallas scan, so they share one compile."""
    return jl11.legacy_random_scene().device()


def test_progressive_renderer_renders_sphere_scenes_as_jax(j_l11_world, jax_scan_interpreted):
    """The engine 'auto' picks the wavefront for sphere scenes and passes
    ``hit_backend`` on (the hybrid integrator raises for them)."""
    twd = l11_bvh.legacy_random_scene().device("cpu", use_bvh=True)
    out = {}
    for backend in ("auto", "bvh"):
        pr = ProgressiveRenderer(twd, _start(LegacyCamera), RES, spp_per_frame=SPP,
                                 limit=LIMIT, bsdf="legacy", scene="spheres",
                                 hit_backend=backend)
        assert pr.engine == "wavefront"
        pr.render(moved=True)
        out[backend] = (pr.acc / pr.spp).numpy(), pr.last_stats["segments"]
    assert out["auto"][1] == out["bvh"][1]
    assert np.array_equal(out["auto"][0], out["bvh"][0])
    jpr, _, segs = _j_script(j_l11_world, _start(JLegacyCamera), "pallas", ".")
    rep = render_agreement(out["auto"][0], np.asarray(jpr.acc / jpr.spp), out["auto"][1],
                           segs[-1])
    assert rep["ok"], rep


@pytest.mark.parametrize("token,message", [("x", "unknown move token 'x'"),
                                           ("r+1", "bad rotate token 'r+1'")])
def test_l12_move_errors_match_jax(token, message):
    for apply_move, cls in ((l12_free_view.apply_move, LegacyCamera),
                            (jl12.apply_move, JLegacyCamera)):
        with pytest.raises(ValueError, match=re.escape(message)):
            apply_move(cls(RES), token)


def test_l12_script_against_jax(tmp_path, monkeypatch, j_l11_world, jax_scan_interpreted):
    script = "w,.,r+15-5"
    monkeypatch.chdir(tmp_path)
    frame, rep = l12_free_view.main(SMALL + ["--script", script])
    assert len(list((tmp_path / "outputs").glob("l12_free_view_*.png"))) == 3
    cam = _start(JLegacyCamera)
    jpr, jspp, segs = _j_script(j_l11_world, cam, "pallas", script)
    assert rep["spp"] == jspp == [4, 8, 4]
    tp, jp = rep["camera"].params(), cam.params()
    for f in ("position", "yaw", "pitch", "roll", "fov"):
        np.testing.assert_array_max_ulp(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), 4)
    pr = rep["renderer"]
    agree = render_agreement((pr.acc / pr.spp).numpy(), np.asarray(jpr.acc / jpr.spp),
                             pr.last_stats["segments"], segs[-1])
    assert agree["ok"], agree


# ------------------------------------------------------------------ l15 --

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The stand-in's asset tree at a small size (the reference's layout)."""
    root = str(tmp_path_factory.mktemp("assets"))
    chip_smoke.standin_asset_tree(root, level=2, tex_size=16, env_size=(64, 32), segments=8,
                                  rings=1, rows=1)
    return root


@pytest.fixture(scope="module")
def l15_worlds(assets, tmp_path_factory):
    """``build_yoimiya_world`` of both packages over ``assets``, each saved."""
    out = tmp_path_factory.mktemp("l15")
    paths = {k: str(out / f"{k}.world.npy") for k in ("t", "j")}
    twd = l15_module.build_yoimiya_world(assets, save_path=paths["t"], device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(jl15, "ASSETS", assets)
    mp.setattr(jl15, "make_asset_path_map", lambda: jlc.make_asset_path_map(assets))
    try:
        jwd = jl15.build_yoimiya_world(save_path=paths["j"])
    finally:
        mp.undo()
    return twd, jwd, paths


def test_l15_world_matches_jax(l15_worlds):
    twd, jwd, paths = l15_worlds
    _assert_legacy_tables_equal(twd, jwd)
    t, j = serialize.load_world_npy(paths["t"]), serialize.load_world_npy(paths["j"])
    assert t["textures"] == j["textures"] and t["environments"] == j["environments"]


@pytest.mark.parametrize("rebuild", [True, False])
def test_load_matches_jax(l15_worlds, assets, rebuild):
    _, _, paths = l15_worlds
    path_map = tlc.make_asset_path_map(assets)
    tw, jw = LegacyWorld(), JLegacyWorld()
    twd = tw.load(paths["t"], path_map=path_map, rebuild_bvh=rebuild)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jwd = jw.load(paths["t"], path_map=jlc.make_asset_path_map(assets), rebuild_bvh=rebuild)
    _assert_legacy_tables_equal(twd, jwd)
    assert tw.textures.configs == jw.textures.configs


def test_load_file_trees_with_fat_leaves(assets, tmp_path):
    """A 14-era file (no texture configs) whose stored trees have leaves of
    up to ~60 triangles, loaded with its own trees and the companion OBJ's
    textures (fixed 2048-wide slots), gives JAX's tables and configs. Loaded
    with its own trees and without the OBJ (no atlas to pack), its render
    agrees with the rebuilt world's: the fat leaves' multi-row runs find the
    rebuilt tree's hits."""
    obj_path = os.path.join(assets, l15_module.OBJ)
    world = LegacyWorld()
    world.add_mesh(load_obj(obj_path, texture_start_id=0))
    world.build(mesh_max_depth=3)
    records, _ = world._bvh_records
    assert int(np.diff(records[0]["cut"]).max()) > 16
    path = str(tmp_path / "Yoimiya_ShapeChange.world.npy")
    serialize.save_world_npy(path, meshes_bvhs=records, environment=0)
    tw, jw = LegacyWorld(), JLegacyWorld()
    twd = tw.load(path, rebuild_bvh=False, textures_from_obj=obj_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jwd = jw.load(path, rebuild_bvh=False, textures_from_obj=obj_path)
    _assert_legacy_tables_equal(twd, jwd)
    assert tw.textures.configs == jw.textures.configs and tw.textures.size == jw.textures.size
    assert tw.textures.configs[0]["area"] == {"low": (0, 0), "high": (2048, 2048)}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # no textures: the fallback
        own, rebuilt = (LegacyWorld().load(path, rebuild_bvh=r) for r in (False, True))
    cam = LegacyCamera(RES)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))
    a, sa = render_hybrid(own, cam.params(), RES, spp=SPP, limit=LIMIT)
    b, sb = render_hybrid(rebuilt, cam.params(), RES, spp=SPP, limit=LIMIT)
    rep = render_agreement(a.numpy(), b.numpy(), sa, sb)
    assert rep["ok"], rep


def test_l15_stage_renders(assets, tmp_path):
    out = tmp_path / "l15.png"
    frame, rep = l15_module.main(SMALL + ["--assets", assets, "--passes", "2",
                                          "--out", str(out)])
    assert out.exists() and os.path.exists(rep["world"])
    assert rep["spp_total"] == 2 * SPP and torch.isfinite(frame).all()
    assert 0.02 < float(rep["linear"].mean()) < 10.0


def test_l15_missing_asset_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="Yoimiya_ShapeChange.obj"):
        l15_module.build_yoimiya_world(str(tmp_path))


def test_companion_obj_matches_jax():
    for name in ("Zhongli.world.npy", "/x/Ganyu.world.npy", "Yoimiya_ShapeChange.world.npy",
                 "Yoimiya.world.npy", "other.npy"):
        assert tlc.companion_obj_for(name) == jlc.companion_obj_for(name)
    assert tlc.make_asset_path_map()("./textures/a.exr") == \
        jlc.make_asset_path_map()("./textures/a.exr")
