"""The port's progressive viewer, the l14 mesh stage on a saved world, and
the stand-in world of ``models.standin``, on the CPU at small sizes.

Tolerances: accumulation and resume are exact (the viewer sums f32 images
times their spp, so two frames equal one frame of twice the spp to f32
rounding, 1e-6; a restored state continues bit for bit); the stage's frame
equals the viewer's own render bit for bit; the wavefront engine's image
is the hybrid engine's to 1e-6 (f32 sums against fixed point) with the
same segments.
"""

import numpy as np
import pytest
import torch

from learn_path_tracing_tpu_torch.camera import LegacyCamera
from learn_path_tracing_tpu_torch.core.image import read_png
from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu_torch.models.standin import (N_SPHERES, STANDIN_SEED, build_quiet,
                                                          sphere_world, standin_camera,
                                                          standin_mesh, standin_world)
from learn_path_tracing_tpu_torch.stages import l14_mesh
from learn_path_tracing_tpu_torch.utils.config import STAGE_CONFIGS
from learn_path_tracing_tpu_torch.viewer import ProgressiveRenderer

torch.set_num_threads(2)

RES = (32, 18)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The stand-in world at 1,024 + 2,944 triangles, saved as .world.npy."""
    d = tmp_path_factory.mktemp("standin")
    world = standin_world(str(d), level=2, tex_size=64, env_size=(128, 64))
    wd = world.build()
    path = str(d / "standin.world.npy")
    world.save(path)
    return world, wd, path


def _renderer(wd, **kw):
    return ProgressiveRenderer(wd, standin_camera(RES), RES, spp_per_frame=2, limit=6,
                               camera_model="jitter", **kw)


def test_accumulates_and_resets_on_move(standin):
    _, wd, _ = standin
    pr = _renderer(wd)
    pr.render(moved=True)
    f2 = pr.render(moved=False)
    assert pr.spp == 4 and pr.last_stats["spp"] == 2
    img, _ = render_hybrid(wd, standin_camera(RES).params(), RES, spp=4, limit=6)
    np.testing.assert_allclose(f2.numpy(), (img.clamp_min(0) ** (1 / 2.2)).numpy(),
                               rtol=0, atol=1e-6)
    f_again = pr.render(moved=True)                     # a move starts over
    assert pr.spp == 2
    first = _renderer(wd).render(moved=True)
    assert torch.equal(f_again, first)


def test_state_restore_continues_exactly(standin):
    _, wd, _ = standin
    a = _renderer(wd)
    a.render(moved=True)
    state = a.state()
    b = _renderer(wd, seed=99)
    b.restore(state)
    assert b.seed == a.seed and b.spp == 2
    assert torch.equal(a.render(moved=False), b.render(moved=False))
    with pytest.raises(ValueError, match="resolution"):
        ProgressiveRenderer(wd, LegacyCamera((8, 8)), (8, 8)).restore(state)


def test_preview_then_full_quality(standin):
    _, wd, _ = standin
    pr = _renderer(wd, preview_spp=1, preview_limit=2)
    pr.render(moved=True)
    assert pr.spp == 1 and pr.last_stats["spp"] == 1
    pr.render(moved=False)                    # the first still frame restarts
    assert pr.spp == 2 and pr.last_stats["spp"] == 2


def test_wavefront_engine_matches_hybrid(standin):
    """``engine='wavefront'`` (``render_accumulate``, one ``hit_legacy`` a
    bounce pass) against the hybrid engine, frame after frame: the same
    RNG counters, so the same segments, and the accumulated image within
    1e-6 (f32 sums against fixed point)."""
    _, wd, _ = standin
    prs = {engine: _renderer(wd, engine=engine) for engine in ("hybrid", "wavefront")}
    for moved in (True, False):
        for pr in prs.values():
            pr.render(moved=moved)
        wf, hy = prs["wavefront"], prs["hybrid"]
        assert wf.engine == "wavefront" and wf.spp == hy.spp
        assert wf.last_stats["segments"] == hy.last_stats["segments"] > 0
        np.testing.assert_allclose(wf.acc.numpy() / wf.spp, hy.acc.numpy() / hy.spp,
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="engine"):
        _renderer(wd, engine="mega")


def test_l14_renders_a_saved_world(standin, tmp_path):
    world, wd, path = standin
    out = tmp_path / "l14.png"
    frame, rep = l14_mesh.main(["--world", path, "--width", str(RES[0]), "--height",
                                str(RES[1]), "--spp", "2", "--limit", "6", "--device", "cpu",
                                "--out", str(out)])
    assert frame.shape == (RES[0], RES[1], 3) and torch.isfinite(frame).all()
    assert read_png(str(out)).shape == (RES[0], RES[1], 3)
    assert rep["segments"] >= RES[0] * RES[1] * 2 and rep["n_chunks"] == 1
    assert 0.05 < rep["primary_hit_fraction"] < 0.5
    assert rep["load_warnings"] == [] and not rep["env_gradient"]
    # the stage's frame is the viewer's render of the reloaded world
    pr = _renderer(world.device())
    assert torch.equal(frame, pr.render(moved=True))
    assert STAGE_CONFIGS["l14"].scene == "legacy"


def test_l14_reports_asset_fallbacks(tmp_path):
    """A world whose textures and EXR are gone still renders, on the
    neutral fills and the sky gradient, and the report says so."""
    world = standin_world(str(tmp_path), level=1, tex_size=16, env_size=(32, 16))
    world.build()
    path = str(tmp_path / "standin.world.npy")
    world.save(path)
    for f in tmp_path.iterdir():
        if f.suffix in (".png", ".exr"):
            f.unlink()
    frame, rep = l14_mesh.main(["--world", path, "--width", str(RES[0]), "--height",
                                str(RES[1]), "--spp", "1", "--limit", "2", "--device", "cpu",
                                "--out", str(tmp_path / "l14.png")])
    assert torch.isfinite(frame).all()
    assert rep["env_gradient"]
    assert any("texture missing" in w for w in rep["load_warnings"])
    assert any("environment missing" in w for w in rep["load_warnings"])


def test_standin_world_shape():
    """Level 5 of the stand-in mesh has the reference mesh's size; the
    figure stands on its base, 16 units tall, in front of l14's camera."""
    mesh = standin_mesh(5, STANDIN_SEED)
    assert mesh.n_faces == 23424
    p = mesh.positions
    assert 0.0 <= p[:, 1].min() < 0.6 and 16.0 < p[:, 1].max() < 18.0
    assert np.abs(p[:, [0, 2]]).max() < 4.5
    # every edge is shared by exactly two faces of its component: closed
    f = mesh.face_p
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).mean() > 0.97


def test_sphere_world_takes_the_packet_kernel():
    """Past the 4,096-sphere ceiling ``build`` packs sphere-leaf tables (K3)."""
    wd = build_quiet(sphere_world())
    assert wd.spheres.center.shape[0] == N_SPHERES > 4096
    assert wd.spheres.packet is not None and wd.spheres.stack > 1
