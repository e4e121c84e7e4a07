"""The mesh path under the packet versions (the JAX package's
``LPT_PACKET_VERSION``; ``LegacyWorldData.packet_version``, l14's
``--packet-version``): version 1 (kernel K5a) and version 3 (K5b) against
version 2 (K2) and against the JAX package's render under the same version,
on the CPU at small sizes, where each version runs its kernel's plain twin.

Tolerances, with their reasons:

- Port against port: segments and the linear image bit for bit equal to
  version 2's. The versions differ only in the ray order of the traversal
  (coherence-sorted for 1 and 3, lane order for 2) and in the slab form,
  and the sorts are permutations and the tie rule is order-free, so every
  lane sees the same ``(t, prim)`` (sampled rays have no direction
  component of exactly 0, where version 1's slab form differs).
- Against the JAX package's ``render_hybrid`` run with the same version on
  its accelerator path (Pallas interpret mode through
  ``_FORCE_ACCEL_INTERPRET``): ``utils.checks.render_agreement`` (segments
  within 0.5 %, mean absolute difference at most 1 % of the mean, at least
  80 % of pixels within 1e-4). XLA contracts the kernels' multiply-adds and
  transcendentals differ by ulps, which flips a few discrete events.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import learn_path_tracing_tpu.scene.legacy_world as jlw
from learn_path_tracing_tpu.camera import Camera as JCamera
from learn_path_tracing_tpu.integrator.hybrid import render_hybrid as j_render_hybrid
from learn_path_tracing_tpu.io.obj import MeshData as JMeshData
from learn_path_tracing_tpu.ops import packet_traverse as jpt
from learn_path_tracing_tpu_torch.camera import Camera
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.io.obj import MeshData
from learn_path_tracing_tpu_torch.models.standin import standin_camera, standin_world
from learn_path_tracing_tpu_torch.scene import legacy_world as tlw
from learn_path_tracing_tpu_torch.stages import l14_mesh
from learn_path_tracing_tpu_torch.utils.checks import render_agreement

torch.set_num_threads(2)

RES = (28, 20)


def _mini_world(world_cls, mesh_cls):
    """The JAX package's tests/test_hybrid.py mini-world: a quad floor and a
    sphere under the sky-gradient environment."""
    world = world_cls()
    world.add_mesh(mesh_cls(
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
        world.build()
    return world


def _cam(cls=Camera):
    cam = cls(RES)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    return cam


@pytest.fixture(scope="module")
def mini():
    return _mini_world(tlw.LegacyWorld, MeshData)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The stand-in world at 1,024 + 2,944 triangles, saved as .world.npy."""
    d = tmp_path_factory.mktemp("standin")
    world = standin_world(str(d), level=2, tex_size=64, env_size=(128, 64))
    world.build()
    path = str(d / "standin.world.npy")
    world.save(path)
    return world, path


@pytest.fixture
def jax_version(monkeypatch):
    """Puts the JAX package's legacy world on its accelerator path (Pallas
    interpret mode) under a given ``LPT_PACKET_VERSION``. Both are read
    when a function is traced, so the jit caches are cleared around it."""
    def use(version):
        monkeypatch.setattr(jlw, "_FORCE_ACCEL_INTERPRET", True)
        monkeypatch.setattr(jpt, "PACKET_VERSION", version)
        jax.clear_caches()

    yield use
    jax.clear_caches()


def _hybrid(wd, **kw):
    return render_hybrid(wd, _cam().params(), RES, spp=4, limit=8, seed=3,
                         camera_model="thinlens", **kw)


@pytest.mark.parametrize("version", [1, 3])
def test_hybrid_equals_version_2(mini, version):
    img, segs = _hybrid(mini.device(packet_version=version))
    ref_img, ref_segs = _hybrid(mini.device())
    assert mini.device(packet_version=version).packet_version == version
    assert segs == ref_segs and torch.equal(img, ref_img)


@pytest.mark.parametrize("version", [1, 3])
def test_hybrid_matches_jax_under_the_same_version(mini, jax_version, version):
    jax_version(version)
    jwd = _mini_world(jlw.LegacyWorld, JMeshData).device()
    j_img, j_segs = j_render_hybrid(jwd, _cam(JCamera).params(), RES, spp=4, limit=8, seed=3,
                                    bsdf="legacy", scene="legacy", camera_model="thinlens")
    img, segs = _hybrid(mini.device(packet_version=version))
    rep = render_agreement(img.numpy(), np.asarray(j_img), segs, float(j_segs))
    print(rep)
    assert rep["ok"], rep


@pytest.mark.parametrize("version", [1, 3])
def test_sorted_pool_passes_equal_version_2(standin, monkeypatch, version):
    """A single-mesh world with a 4,096-lane pool: its pool passes take
    ``packet_traverse_sorted`` (payload through the coherence sort), its
    narrower cascade levels ``trace_legacy``; the render is version 2's."""
    world, _ = standin
    calls = []
    sorted_walk = tlw.packet_traverse_sorted

    def counted(*args, **kw):
        calls.append(args[3].shape[0])
        return sorted_walk(*args, **kw)

    monkeypatch.setattr(tlw, "packet_traverse_sorted", counted)
    cam = standin_camera((48, 27)).params()
    kw = dict(spp=4, limit=6, seed=2, camera_model="jitter", pool_w=4096, stats=True)
    img, segs, st = render_hybrid(world.device(packet_version=version), cam, (48, 27), **kw)
    assert calls and min(calls) >= 4096 and st["passes"] > len(calls)
    calls.clear()
    ref_img, ref_segs, _ = render_hybrid(world.device(), cam, (48, 27), **kw)
    assert not calls
    assert segs == ref_segs and torch.equal(img, ref_img)


def _l14(path, out, *extra):
    return l14_mesh.main(["--world", path, "--width", "32", "--height", "18", "--spp", "2",
                          "--limit", "6", "--device", "cpu", "--out", str(out), *extra])


def test_l14_packet_versions_and_engines(standin, tmp_path):
    """``--packet-version 1`` and ``3`` give version 2's frame and linear
    image bit for bit and name the version; ``--engine wavefront`` gives the
    hybrid engine's segments and its image within 1e-6 (f32 sums against
    fixed point). On the CPU no kernel is launched."""
    _, path = standin
    ref, ref_rep = _l14(path, tmp_path / "v2.png")
    assert ref_rep["packet_version"] == 2 and ref_rep["engine"] == "hybrid"
    for version in (1, 3):
        frame, rep = _l14(path, tmp_path / f"v{version}.png", "--packet-version", str(version))
        assert rep["packet_version"] == version and rep["launches"] == {}
        assert rep["segments"] == ref_rep["segments"]
        assert torch.equal(frame, ref) and torch.equal(rep["linear"], ref_rep["linear"])
    frame, rep = _l14(path, tmp_path / "wf.png", "--engine", "wavefront", "--packet-version", "1")
    assert rep["engine"] == "wavefront" and rep["segments"] == ref_rep["segments"]
    np.testing.assert_allclose(rep["linear"].numpy(), ref_rep["linear"].numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(SystemExit):
        _l14(path, tmp_path / "x.png", "--packet-version", "4")


def test_world_packet_version_is_checked(mini):
    with pytest.raises(ValueError, match="packet_version"):
        mini.device(packet_version=0)
