"""Port parity: the legacy mesh world (textures, OBJ/EXR, ``.world.npy``,
``LegacyWorld`` tables, ``hit_legacy``, ``trace_shade_compact``,
``environment_color``, ``scatter_legacy``) against the JAX package.

Tolerances, with their reasons:

- Host-side data (texture placements, atlases, OBJ arrays, EXR pixels, the
  world's traversal tables, triangle rows and sphere arrays, and a JAX world
  carried over by ``convert.legacy_world_from_numpy``): equal byte for byte.
- Hits against JAX's accelerator path (Pallas interpret mode through
  ``_FORCE_ACCEL_INTERPRET``, as ``tests/test_legacy.py`` runs it): ``t``
  to 1e-5 relative, hit/miss and ``obj`` on at least 99.9 % of rays; hit
  point, uv and the tapped material to 1e-4 absolute on a smooth texture,
  the shading normal to 1e-3. XLA contracts multiply-adds in the
  barycentrics (the divisions by ``d·n`` amplify them), sphere UVs come
  from asin/atan2, which differ by ulps between XLA and PyTorch, the tap
  multiplies a UV difference by the texture's gradient, and the sphere
  normal-map frame divides by the distance from the pole axis (measured:
  uv within 3.6e-5, sphere normals within 3.6e-4, mesh normals equal).
  Shading alone from the same traced hits (``shade_from_trace``; both
  sides tap the same strip-packed atlas): mesh hits bit for bit, sphere
  hits to 1e-6 (1e-5 for the normal); a texture id past the last rect
  gives NaN materials on a multi-texture atlas on both sides.
- Environment lookups to 1e-5 relative; ``scatter_legacy`` to 2e-5
  absolute (the ``sampling.py`` tolerances: asin/atan2/sin/cos differ by
  ulps between XLA and PyTorch).
- Port against port (the sorted traversal entry against lane order, the
  compacted bounce step against the composed hit path, the packet versions
  against each other, save/load round trip): bit for bit.
"""

import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import learn_path_tracing_tpu.scene.legacy_world as jlw
from learn_path_tracing_tpu.bsdf.bsdf import scatter_legacy as j_scatter_legacy
from learn_path_tracing_tpu.core import rng as jrng
from learn_path_tracing_tpu.core.types import Hits as JHits
from learn_path_tracing_tpu.core.types import Materials as JMaterials
from learn_path_tracing_tpu.core.types import Rays as JRays
from learn_path_tracing_tpu.io import exr as jexr
from learn_path_tracing_tpu.io import obj as jobj
from learn_path_tracing_tpu.io import texture as jtex
from learn_path_tracing_tpu_torch import convert
from learn_path_tracing_tpu_torch.bsdf.bsdf import scatter_legacy
from learn_path_tracing_tpu_torch.core import rng
from learn_path_tracing_tpu_torch.core.types import Hits, Materials, Rays
from learn_path_tracing_tpu_torch.io import exr, obj, texture
from learn_path_tracing_tpu_torch.ops import packet_traverse as tpt
from learn_path_tracing_tpu_torch.scene import legacy_world as tlw
from learn_path_tracing_tpu_torch.scene import serialize

torch.set_num_threads(2)


# ------------------------------------------------------ worlds on both sides --

def _env(path):
    h, w = 32, 64
    ys = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    env = np.zeros((h, w, 3), np.float32)
    env[:] = (1 - ys) * np.array([4.0, 2.0, 0.5]) + ys * np.array([0.2, 0.4, 1.5])
    env[:, 20:24] += 3.0                           # a bright band: u matters
    exr.write_exr(path, env, half=False, compression="zip")
    return path


def _quad(obj_mod, scale=2.0, tex=0):
    return obj_mod.MeshData(
        positions=np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                           np.float32) * scale,
        normals=np.array([[0, 1, 0]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.zeros((2, 3), np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.full(2, tex, np.int32))


def _blob(obj_mod, seed=5, n=120):
    """A closed random triangle soup around (0, 1, 0) with smooth normals."""
    r = np.random.default_rng(seed)
    p = r.normal(size=(n, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    nrm = p.copy()
    p = p * 0.9 + np.array([0, 1, 0], np.float32)
    faces = np.stack([np.arange(n), np.roll(np.arange(n), 1), np.roll(np.arange(n), 7)],
                     1).astype(np.int32)
    uv = (p[:, [0, 2]] * 0.5 + 0.5).astype(np.float32)
    return obj_mod.MeshData(positions=p, normals=nrm, uvs=uv, face_p=faces, face_n=faces,
                            face_t=faces, face_tex=np.zeros(n, np.int32))


def _texture_set(directory, size=16):
    """A tiny smooth PBR texture set (albedo/roughness/metallic/normal PNGs,
    each channel a seeded low-frequency wave)."""
    from PIL import Image

    r = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size] * (2 * np.pi / size)
    base = os.path.join(directory, "mat")
    for name, ch in (("albedo", 3), ("roughness", 1), ("metallic", 1), ("normal", 3)):
        ph = r.uniform(0, 2 * np.pi, (2, ch))
        a = 0.5 + 0.2 * np.sin(x[..., None] + ph[0]) + 0.2 * np.cos(y[..., None] + ph[1])
        a = (a * 255 + 0.5).astype(np.uint8)
        Image.fromarray(a[..., 0] if ch == 1 else a).save(f"{base}_{name}.png")
    return base


def _populate(world, obj_mod, directory, kind):
    """'ibl': quad + sphere under an EXR environment (the self-golden world),
    with a PBR texture; 'mesh': one closed mesh alone (the single-mesh
    path); 'two': two meshes and a glass sphere."""
    if kind == "mesh":
        world.add_mesh(_blob(obj_mod))
    else:
        world.add_mesh(_quad(obj_mod))
        world.add_sphere((0.0, 1.0, 0.0), 0.8, transparency=0, texture_id=0)
    if kind == "two":
        world.add_mesh(_blob(obj_mod))
        world.add_sphere((1.5, 0.5, 1.0), 0.4, transparency=1, texture_id=1)
        world.textures.add("missing", 1, size=(8, 8))
    world.textures.add(_texture_set(directory), 0)
    world.environments.add(_env(os.path.join(directory, "env.exr")), 0)
    world.set_environment(0)


def _build_both(tmp_path, kind, **kw):
    jw = jlw.LegacyWorld(environment_size=(128, 64))
    tw = tlw.LegacyWorld(environment_size=(128, 64))
    _populate(jw, jobj, str(tmp_path), kind)
    _populate(tw, obj, str(tmp_path), kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jw, jw.build(**kw), tw, tw.build(**kw)


def _rays_at(n, seed, target=(0.0, 0.8, 0.0), spread=1.6, inactive=False):
    r = np.random.default_rng(seed)
    ro = (r.normal(size=(n, 3)) * 4 + np.array([0, 2.0, 0])).astype(np.float32)
    goal = np.array(target) + r.uniform(-spread, spread, (n, 3))
    rd = (goal - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    alive = r.uniform(size=n) > 0.15 if inactive else np.ones(n, bool)
    return ro, rd.astype(np.float32), alive


def _j_rays(ro, rd, alive):
    n = ro.shape[0]
    return JRays(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                 throughput=jnp.ones((n, 3), jnp.float32), alive=jnp.asarray(alive))


def _t_rays(ro, rd, alive):
    n = ro.shape[0]
    return Rays(ro=torch.tensor(ro), rd=torch.tensor(rd),
                throughput=torch.ones((n, 3)), alive=torch.tensor(alive))


def _same(a, b):
    a = np.asarray(a.float() if a.dtype == torch.bfloat16 else a) \
        if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.float64), b.astype(np.float64),
                                                 equal_nan=True)


def _bits(x):
    """The raw bytes of a tensor (bfloat16 read as 16-bit words)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.contiguous().numpy().tobytes()


# ---------------------------------------------------------- host-side data --

def test_texture_manager_packing_matches_jax():
    sizes = [(64, 64), (32, 128), (128, 32), (16, 16), (64, 64), (200, 40), (8, 8)]
    jm, tm = jtex.TextureManager((256, 256)), texture.TextureManager((256, 256))
    for i, s in enumerate(sizes):
        jm.add(f"t{i}", i, size=s)
        tm.add(f"t{i}", i, size=s)
    jm.build()
    tm.build()
    assert [c["area"] for c in tm.configs] == [c["area"] for c in jm.configs]
    assert [c["id"] for c in tm.configs] == [c["id"] for c in jm.configs]
    tm2 = texture.TextureManager((1, 1))
    tm2.load(tm.dump())
    assert tm2.configs == tm.configs
    over = texture.TextureManager((64, 64))
    over.add("big", 0, size=(65, 8))
    with pytest.raises(MemoryError):
        over.build()


def test_atlases_and_sampler_match_jax(tmp_path):
    tm = texture.TextureManager((64, 32))
    tm.add(_texture_set(str(tmp_path)), 0)
    tm.add("missing", 2, size=(8, 8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tm.build()
        atlas_t = texture.build_texture_atlas(tm.configs, (64, 32))
        atlas_j = jtex.build_texture_atlas(tm.configs, (64, 32))
        env_cfg = [{"file_path": _env(str(tmp_path / "e.exr")), "id": 0,
                    "area": {"low": (0, 0), "high": (64, 32)}},
                   {"file_path": "missing.exr", "id": 1,
                    "area": {"low": (64, 0), "high": (80, 32)}}]
        env_t, grad_t = texture.build_environment_atlas(env_cfg, (80, 32))
        env_j, grad_j = jtex.build_environment_atlas(env_cfg, (80, 32))
    assert atlas_t.tobytes() == atlas_j.tobytes()
    assert env_t.tobytes() == env_j.tobytes() and grad_t == grad_j == {1}
    low, high = texture.make_info_arrays(tm.configs)
    jlow, jhigh = jtex.make_info_arrays(tm.configs)
    assert np.array_equal(low, jlow) and np.array_equal(high, jhigh)

    r = np.random.default_rng(3)
    n = 500
    tex = r.choice([0, 2], n).astype(np.int32)
    u = r.uniform(-0.5, 1.5, n).astype(np.float32)      # wraps in the rect
    v = r.uniform(-0.5, 1.5, n).astype(np.float32)
    out = texture.sample_bilinear(torch.tensor(atlas_t), torch.tensor(low),
                                  torch.tensor(high), torch.tensor(tex),
                                  torch.tensor(u), torch.tensor(v)).numpy()
    ref = np.asarray(jtex.sample_bilinear(jnp.asarray(atlas_j), jnp.asarray(jlow),
                                          jnp.asarray(jhigh), jnp.asarray(tex),
                                          jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_obj_and_exr_match_jax(tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl a\nmap_Kd tex_a.png\nnewmtl b\nmap_Kd tex_b.png\n")
    (tmp_path / "m.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0.5\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nusemtl b\nf 2/2/1 4/1/1 3/3/1\n")
    kw = dict(texture_start_id=3, flip_z=True, flip_textcoord=True,
              transform=np.diag([2.0, 1.0, 1.0]))
    a, b = obj.load_obj(str(tmp_path / "m.obj"), **kw), jobj.load_obj(str(tmp_path / "m.obj"), **kw)
    for k in ("positions", "normals", "uvs", "face_p", "face_n", "face_t", "face_tex"):
        assert getattr(a, k).tobytes() == getattr(b, k).tobytes(), k
    assert a.textures == b.textures

    img = np.random.default_rng(1).uniform(0, 50, (37, 21, 3)).astype(np.float32)
    for half, comp in ((True, "zip"), (False, "zips"), (False, "none")):
        exr.write_exr(str(tmp_path / "p.exr"), img, half=half, compression=comp)
        jexr.write_exr(str(tmp_path / "j.exr"), img, half=half, compression=comp)
        assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
        assert exr.read_exr(str(tmp_path / "j.exr")).tobytes() == \
            jexr.read_exr(str(tmp_path / "p.exr")).tobytes()


@pytest.mark.parametrize("kind,kw", [("ibl", {}), ("two", {"sphere_packet": True}),
                                     ("two", {"merge_meshes": False})])
def test_world_tables_match_jax_and_convert(tmp_path, kind, kw):
    """``LegacyWorld.build`` gives the JAX package's tables byte for byte,
    and ``convert.legacy_world_from_numpy`` of the JAX world gives the
    port's own world."""
    _, jwd, _, twd = _build_both(tmp_path, kind, **kw)
    cwd = convert.legacy_world_from_numpy(jax.tree_util.tree_map(np.asarray, jwd))
    for wd in (twd, cwd):
        assert len(wd.meshes) == len(jwd.meshes)
        for m, jm in zip(wd.meshes, jwd.meshes):
            for a, b in zip(m.packet, jm.packet):
                assert _same(a, b)
            for a, b in zip(m.treelets, jm.treelets):
                assert _same(a, b)
            for k in ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "tex"):
                assert _same(getattr(m, k), getattr(jm, k)), k
        assert _same(wd.tri_attr, jwd.tri_attr)
        s, js = wd.spheres, jwd.spheres
        for k in ("center", "radius", "transparency", "tex"):
            assert _same(getattr(s, k), getattr(js, k)), k
        assert (s.packet is None) == (js.packet is None)
        if s.packet is not None:
            for a, b in zip(s.packet, js.packet):
                assert _same(a, b)
        # the host trees the tables were packed from (legacy_world.py:962)
        for m, jm in zip(wd.to("cpu").meshes + (s,), jwd.meshes + (js,)):
            for k in ("left", "right", "low", "high", "data", "cut", "prim"):
                assert _same(getattr(m.bvh, k), getattr(jm.bvh, k)), k
            assert m.bvh.n_nodes == jm.bvh.n_nodes
        for m, jm in zip(wd.meshes, jwd.meshes):
            for k in ("child_low", "child_high", "child_entry", "prim"):
                assert _same(getattr(m.wide, k), getattr(jm.wide, k)), k
            assert (m.wide.depth, m.wide.max_leaf) == (jm.wide.depth, jm.wide.max_leaf)
        assert wd.env_id == int(jwd.env_id) and wd.env_gradient_h == jwd.env_gradient_h
    for a, b in zip(cwd.meshes + (cwd.spheres,), twd.meshes + (twd.spheres,)):
        assert a.stack == b.stack
    for k in ("atlas", "envs"):
        for f in ("table", "info_low", "info_high", "base", "spr", "info"):
            mine, conv = getattr(getattr(twd, k), f), getattr(getattr(cwd, k), f)
            ref = np.asarray(getattr(getattr(jwd, k), f))
            assert _bits(mine) == _bits(conv) == ref.tobytes(), (k, f)
            assert mine.dtype == conv.dtype and tuple(mine.shape) == ref.shape, (k, f)
    assert twd.atlas.table.dtype == torch.bfloat16 and twd.envs.table.dtype == torch.float32


def test_device_data_trees_walk_as_in_jax(tmp_path):
    """The JAX package's walks over a world's own trees
    (``legacy_world.py:962``): ``traverse_wide(mesh.wide, ...)`` over a mesh
    and ``traverse(spheres.bvh, ...)`` over the sphere set, each with the
    leaf test of the device data's own primitives, against JAX's (hit masks
    equal, ``t`` within rtol 1e-5, ``prim`` equal away from ties: where no
    other primitive's ``t`` is within that bound of the nearest)."""
    from learn_path_tracing_tpu.accel import traverse as jtr
    from learn_path_tracing_tpu.accel import wide as jwide
    from learn_path_tracing_tpu_torch.accel import traverse as ttr
    from learn_path_tracing_tpu_torch.accel import wide as twide
    from learn_path_tracing_tpu_torch.geometry.sphere import sphere_t
    from learn_path_tracing_tpu_torch.geometry.triangle import triangle_t

    _, jwd, _, twd = _build_both(tmp_path, "two", merge_meshes=False)
    ro, rd, _ = _rays_at(600, 21)
    jro, jrd, tro, trd = jnp.asarray(ro), jnp.asarray(rd), torch.tensor(ro), torch.tensor(rd)
    jm, tm, js, ts = jwd.meshes[1], twd.meshes[1], jwd.spheres, twd.spheres
    pair = (tro[:, None], trd[:, None])
    t_all = [triangle_t(tm.v0[None], tm.v1[None], tm.v2[None], *pair),
             sphere_t(ts.center[None], ts.radius[None], ts.transparency[None], *pair)]
    walks = [
        (jwide.traverse_wide(jm.wide, jro, jrd, jtr.make_triangle_leaf_test(jm.v0, jm.v1, jm.v2)),
         twide.traverse_wide(tm.wide, tro, trd, ttr.make_triangle_leaf_test(tm.v0, tm.v1, tm.v2))),
        (jtr.traverse(js.bvh, jro, jrd,
                      jtr.make_sphere_leaf_test(js.center, js.radius, js.transparency)),
         ttr.traverse(ts.bvh, tro, trd,
                      ttr.make_sphere_leaf_test(ts.center, ts.radius, ts.transparency)))]
    for ((jt, jp), (tt, tp)), ta in zip(walks, t_all):
        jt, jp, tt, tp = np.asarray(jt), np.asarray(jp), tt.numpy(), tp.numpy()
        hit = np.isfinite(jt)
        assert np.array_equal(np.isfinite(tt), hit) and hit.sum() > 50
        np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
        second = torch.sort(ta, dim=1).values[:, 1].numpy()
        untied = hit & ~np.isclose(second, tt, rtol=1e-5)
        assert untied.sum() > 0.9 * hit.sum() and np.array_equal(tp[untied], jp[untied])


# ------------------------------------------------------------------- hits --

def _hits_agree(th, jh):
    hit_t, hit_j = th.hit.numpy(), np.asarray(jh.hit)
    obj_t, obj_j = th.obj.numpy(), np.asarray(jh.obj)
    differ = np.flatnonzero((hit_t != hit_j) | (obj_t != obj_j))
    print(f"{len(differ)} of {len(hit_t)} rays differ in hit/miss or obj")
    assert len(differ) <= 0.001 * len(hit_t)
    both = hit_t & hit_j & (obj_t == obj_j)
    assert both.sum() > 100
    np.testing.assert_allclose(th.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-5)
    for k, atol in (("point", 1e-4), ("uv", 1e-4), ("normal", 1e-3)):
        np.testing.assert_allclose(getattr(th, k).numpy()[both],
                                   np.asarray(getattr(jh, k))[both], rtol=0, atol=atol)
    for k in ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity"):
        np.testing.assert_allclose(getattr(th.material, k).numpy()[both],
                                   np.asarray(getattr(jh.material, k))[both], rtol=0,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["ibl", "mesh"])
def test_hit_legacy_matches_jax(tmp_path, monkeypatch, kind):
    """The IBL quad+sphere world (sphere scan + triangle packets) and a
    single-mesh world (JAX's fused sorted path, the port's lane-order one),
    rays from both sides of the surfaces, some inactive."""
    monkeypatch.setattr(jlw, "_FORCE_ACCEL_INTERPRET", True)
    _, jwd, _, twd = _build_both(tmp_path, kind)
    ro, rd, alive = _rays_at(1024, 11, inactive=True)
    jh = jlw.hit_legacy(jwd, _j_rays(ro, rd, alive))
    th = tlw.hit_legacy(twd, _t_rays(ro, rd, alive))
    _hits_agree(th, jh)
    if kind == "mesh":        # (the sphere scan of 'ibl' ignores alive, as in JAX)
        assert not th.hit.numpy()[~alive].any()


def _shade_both(jwd, twd, n, seed):
    """``shade_from_trace`` on both sides from the port's own traced
    ``(t, prim, src)``, so only the shading is compared."""
    ro, rd, alive = _rays_at(n, seed)
    trays = _t_rays(ro, rd, alive)
    t, p, s = tlw.trace_legacy(twd, trays)
    th = tlw.shade_from_trace(twd, trays, t, p, s)
    jh = jlw.shade_from_trace(jwd, _j_rays(ro, rd, alive), *(jnp.asarray(x.numpy())
                                                             for x in (t, p, s)))
    return th, jh


def test_shade_from_trace_matches_jax(tmp_path):
    """The IBL quad + sphere world (``tests/test_self_goldens.py:67``, with a
    PBR texture set): the triangle-attribute row gather and the strip tap
    of every hit against JAX's. Mesh hits bit for bit (the same tap, the
    same barycentrics); sphere hits to 1e-6 in uv and material and 1e-5 in
    the normal, whose asin/atan2 UVs and normal-map frame differ by ulps
    between XLA and PyTorch (measured: 2.4e-7 and 1.2e-6)."""
    _, jwd, _, twd = _build_both(tmp_path, "ibl")
    th, jh = _shade_both(jwd, twd, 1024, 21)
    hit = th.hit.numpy()
    assert np.array_equal(hit, np.asarray(jh.hit)) and 200 < hit.sum() < 1000
    assert (th.obj.numpy() == np.asarray(jh.obj)).all()
    mesh = hit & (np.abs(th.point.numpy()[:, 1]) < 1e-6)             # the quad at y = 0
    sphere = hit & ~mesh
    assert mesh.sum() > 100 and sphere.sum() > 100
    fields = [(k, getattr(th, k).numpy(), np.asarray(getattr(jh, k)))
              for k in ("point", "uv", "normal")]
    fields += [(k, getattr(th.material, k).numpy(), np.asarray(getattr(jh.material, k)))
               for k in ("albedo", "roughness", "metallic")]
    for k, mine, ref in fields:
        assert mine[mesh].tobytes() == ref[mesh].tobytes(), k
        np.testing.assert_allclose(mine[sphere], ref[sphere], rtol=0,
                                   atol=1e-5 if k == "normal" else 1e-6, err_msg=k)
        assert k == "point" or float(mine[hit].std()) > 1e-3, k


@pytest.mark.parametrize("rects", [2, 1])
def test_out_of_range_texture_id_shades_as_jax(tmp_path, rects):
    """A mesh whose faces name texture 5: on a 2-rect atlas its hits tap a
    fill row and get NaN materials on both sides (the port clamped the id
    to the last rect before); on a 1-rect atlas every id reads rect 0."""
    worlds = []
    for lw, m in ((jlw, jobj), (tlw, obj)):
        w = lw.LegacyWorld(environment_size=(128, 64))
        w.add_mesh(_quad(m, tex=5))
        w.add_sphere((0.0, 1.0, 0.0), 0.8, transparency=0, texture_id=0)
        w.textures.add(_texture_set(str(tmp_path)), 0)
        if rects == 2:
            w.textures.add("missing", 1, size=(8, 8))
        w.set_environment(0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            worlds.append(w.build())
    jwd, twd = worlds
    th, jh = _shade_both(jwd, twd, 1024, 23)
    quad = (th.obj.numpy() >= 0) & (th.t.numpy() > 0) & th.hit.numpy()
    quad &= np.abs(th.point.numpy()[:, 1]) < 1e-5                    # on the plane y = 0
    sphere = th.hit.numpy() & ~quad
    assert quad.sum() > 50 and sphere.sum() > 50
    mine, ref = th.material.albedo.numpy(), np.asarray(jh.material.albedo)
    assert np.isnan(mine[quad]).all() == np.isnan(ref[quad]).all() == (rects == 2)
    assert np.isfinite(mine[sphere]).all() and np.isfinite(ref[sphere]).all()
    np.testing.assert_allclose(mine[th.hit.numpy()], ref[th.hit.numpy()], rtol=0,
                               atol=1e-4, equal_nan=True)


def test_trace_shade_compact_matches_jax(tmp_path, monkeypatch):
    """Per carried tag: the same hit set in the prefix ``[0, nhits)`` and
    the same hits as JAX's ``trace_shade_compact``."""
    monkeypatch.setattr(jlw, "_FORCE_ACCEL_INTERPRET", True)
    _, jwd, _, twd = _build_both(tmp_path, "mesh")
    ro, rd, alive = _rays_at(1024, 13, inactive=True)
    tag = np.arange(1024, dtype=np.int64) * 7
    jh, _, (jtag,), jn = jlw.trace_shade_compact(jwd, jnp.asarray(ro), jnp.asarray(rd),
                                                 jnp.asarray(alive),
                                                 (jnp.asarray(tag.astype(np.uint32)),))
    th, rd_c, (ttag,), tn = tlw.trace_shade_compact(twd, torch.tensor(ro), torch.tensor(rd),
                                                    torch.tensor(alive), (torch.tensor(tag),))
    assert tn == int(jn) > 100
    assert th.hit.numpy()[:tn].all() and not th.hit.numpy()[tn:].any()
    jtag, ttag = np.asarray(jtag).astype(np.int64), ttag.numpy()
    assert np.array_equal(np.sort(ttag[:tn]), np.sort(jtag[:tn]))
    # JAX order → port order, then compare per work item
    pos = {v: i for i, v in enumerate(jtag[:tn])}
    perm = np.array([pos[v] for v in ttag[:tn]])
    take = jax.tree_util.tree_map(lambda a: np.asarray(a)[:tn][perm], jh)
    mine = Hits(**{f: (getattr(th, f)[:tn] if f != "material" else Materials(
        **{k: getattr(th.material, k)[:tn] for k in JMaterials.__dataclass_fields__}))
        for f in JHits.__dataclass_fields__})
    _hits_agree(mine, take)
    np.testing.assert_array_equal(rd_c.numpy()[:tn], rd[ttag[:tn] // 7])


@pytest.mark.parametrize("kind", ["mesh", "two"])
def test_fused_and_compact_equal_composed(tmp_path, kind):
    """Port against port, bit for bit: the coherence-sorted traversal
    (``packet_traverse_sorted``, the JAX fused path's entry) scattered back
    to lane order against ``trace_legacy``'s lane-order walk of the first
    mesh, ``hit_legacy`` against trace + shade, and ``trace_shade_compact``
    per work item."""
    _, _, _, twd = _build_both(tmp_path, kind)
    ro, rd, alive = _rays_at(1500, 17, inactive=True)
    rays = _t_rays(ro, rd, alive)
    mesh = twd.meshes[0]
    t_s, prim_s, _, _, _, order = tpt.packet_traverse_sorted(
        *mesh.packet, rays.ro, rays.rd, rays.alive, treelets=mesh.treelets, stack=mesh.stack)
    t_l, prim_l = tpt.packet_traverse(*mesh.packet, rays.ro, rays.rd,
                                      torch.full((1500,), float("inf")), rays.alive,
                                      stack=mesh.stack)
    assert torch.equal(t_s, torch.where(prim_l >= 0, t_l, float("inf"))[order])
    assert torch.equal(prim_s, prim_l[order])
    ref = tlw.shade_from_trace(twd, rays, *tlw.trace_legacy(twd, rays))
    got = tlw.hit_legacy(twd, rays)
    for k in ("t", "point", "normal", "uv", "obj", "hit"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in JMaterials.__dataclass_fields__:
        assert torch.equal(getattr(got.material, k), getattr(ref.material, k)), k
    idx = torch.arange(1500)
    hits, _, (tag,), n = tlw.trace_shade_compact(twd, rays.ro, rays.rd, rays.alive, (idx,))
    ref_hit = ref.hit & rays.alive
    assert n == int(ref_hit.sum())
    assert torch.equal(hits.t[:n], ref.t[tag[:n]])
    assert torch.equal(hits.normal[:n], ref.normal[tag[:n]])
    assert torch.equal(hits.material.albedo[:n], ref.material.albedo[tag[:n]])


def test_packet_versions_give_the_same_hits(tmp_path, monkeypatch):
    """Port against port, bit for bit: on a single-mesh world, packet
    versions 1 and 3 (coherence-sorted walks; ``trace_shade_compact`` from
    4,096 rays through ``packet_traverse_sorted`` with the payload) give
    version 2's lane-order ``hit_legacy`` and, per carried tag,
    ``trace_shade_compact``."""
    tw = tlw.LegacyWorld(environment_size=(128, 64))
    _populate(tw, obj, str(tmp_path), "mesh")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tw.build()
    ro, rd, alive = _rays_at(5000, 19, inactive=True)
    rays = _t_rays(ro, rd, alive)
    idx = torch.arange(5000)
    sorted_calls = []
    sorted_walk = tlw.packet_traverse_sorted
    monkeypatch.setattr(tlw, "packet_traverse_sorted",
                        lambda *a, **kw: sorted_calls.append(kw["version"]) or sorted_walk(*a, **kw))

    def run(version):
        wd = tw.device(packet_version=version)
        hits, rd_c, (tag,), n = tlw.trace_shade_compact(wd, rays.ro, rays.rd, rays.alive, (idx,))
        by_lane = {k: torch.zeros_like(getattr(hits, k)) for k in ("t", "point", "normal", "obj")}
        for k, v in by_lane.items():
            v[tag[:n]] = getattr(hits, k)[:n]
        return tlw.hit_legacy(wd, rays), by_lane, n

    ref_hit, ref_compact, ref_n = run(2)
    assert sorted_calls == [] and ref_n > 500
    for version in (1, 3):
        got_hit, got_compact, n = run(version)
        assert sorted_calls[-1] == version and n == ref_n
        for k in ("t", "point", "normal", "uv", "obj", "hit"):
            assert torch.equal(getattr(got_hit, k), getattr(ref_hit, k)), k
        assert torch.equal(got_hit.material.albedo, ref_hit.material.albedo)
        for k in ref_compact:
            assert torch.equal(got_compact[k], ref_compact[k]), k


def test_degenerate_triangle(tmp_path):
    """A zero-area triangle is never hit (the packer clamps its
    denominators), and ``_attrs_block`` divides by the unguarded ``d·n`` as
    the JAX package does: non-finite weights, the same on both sides."""
    mesh = _quad(obj)
    mesh.positions = np.concatenate([mesh.positions, [[0, 0.5, 0], [1, 0.5, 0]]]).astype(np.float32)
    mesh.face_p = np.concatenate([mesh.face_p, [[4, 5, 4]]]).astype(np.int32)
    mesh.face_n = np.concatenate([mesh.face_n, [[0, 0, 0]]]).astype(np.int32)
    mesh.face_t = np.concatenate([mesh.face_t, [[0, 1, 2]]]).astype(np.int32)
    mesh.face_tex = np.zeros(3, np.int32)
    tw, jw = tlw.LegacyWorld(), jlw.LegacyWorld()
    jmesh = jobj.MeshData(**{k: getattr(mesh, k) for k in jobj.MeshData.__dataclass_fields__})
    for w, m in ((tw, mesh), (jw, jmesh)):
        w.add_mesh(m)
        w.textures.add("missing", 0, size=(4, 4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            w.build()
    twd, jwd = tw.device(), jw.device()
    # through the sliver at (0.5, 0.5, 0), then onto the quad at y = 0
    ro = np.array([[0.4, 1.5, -1.0]], np.float32)
    rd = np.array([[0.1, -1.0, 1.0]], np.float32) / np.float32(np.sqrt(2.01))
    t, p, _ = tlw.trace_legacy(twd, _t_rays(ro, rd, np.ones(1, bool)))
    assert p.item() in (0, 1) and abs(t.item() - 1.5 * np.sqrt(2.01)) < 1e-4
    point = np.array([[0.5, 0.5, 0.0]], np.float32)
    outs_t = tlw._attrs_block(twd, torch.tensor(point), torch.tensor([2]),
                              torch.tensor([1]), torch.tensor([True]))
    outs_j = jlw._attrs_block(jwd, jnp.asarray(point), jnp.asarray([2]), jnp.asarray([1]),
                              jnp.asarray([True]))
    assert not np.isfinite(outs_t[0].numpy()).all()
    for a, b in zip(outs_t[:2], outs_j[:2]):          # normal, uv
        np.testing.assert_array_equal(np.isfinite(a.numpy()), np.isfinite(np.asarray(b)))


# ------------------------------------------------------ environment, scatter --

@pytest.mark.parametrize("gradient", [False, True])
def test_environment_color_matches_jax(tmp_path, gradient):
    if gradient:
        jw, tw = jlw.LegacyWorld(), tlw.LegacyWorld()
        for w, m in ((jw, jobj), (tw, obj)):
            w.add_mesh(_quad(m))
            w.textures.add("missing", 0, size=(4, 4))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                w.build()
        jwd, twd = jw.device(), tw.device()
        assert twd.env_gradient_h == jwd.env_gradient_h == 32
    else:
        _, jwd, _, twd = _build_both(tmp_path, "ibl")
        assert twd.env_gradient_h is None
    r = np.random.default_rng(2)
    rd = r.normal(size=(2000, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    mask = r.uniform(size=2000) < 0.7
    jc = np.asarray(jlw.environment_color(jwd.envs, jwd.env_id, jnp.asarray(rd),
                                          mask=jnp.asarray(mask),
                                          gradient_h=jwd.env_gradient_h))
    # JAX's call form, positionally: (envs, env_id, rd, mask, gradient_h)
    tc = tlw.environment_color(twd.envs, twd.env_id, torch.tensor(rd), torch.tensor(mask),
                               twd.env_gradient_h).numpy()
    np.testing.assert_allclose(tc[mask], jc[mask], rtol=1e-5, atol=1e-6)
    assert tc.std() > 0.01


def test_scatter_legacy_matches_jax():
    r = np.random.default_rng(4)
    n = 3000
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where((np.sum(d * nrm, 1) > 0)[:, None], -nrm, nrm).astype(np.float32)
    f = dict(point=r.normal(size=(n, 3)), albedo=r.uniform(size=(n, 3)),
             roughness=r.uniform(size=n), metallic=r.uniform(size=n),
             ior=r.choice([1.5, 1 / 1.5], n), transparency=(r.uniform(size=n) < 0.4) * 1.0,
             absorptivity=r.choice([0.25, 0.0], n), through=r.uniform(size=(n, 3)))
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    pix = np.arange(n, dtype=np.int64) * 13

    def run(T, M, R, H, xp, rng_mod, scat):
        mat = M(**{k: xp(f[k]) for k in ("albedo", "roughness", "metallic", "ior",
                                         "transparency", "absorptivity")})
        hits = H(t=xp(np.ones(n, np.float32)), point=xp(f["point"]), normal=xp(nrm),
                 uv=xp(np.zeros((n, 2), np.float32)), obj=xp(np.zeros(n, np.int32)),
                 hit=xp(np.ones(n, bool)), material=mat)
        rays = R(ro=xp(np.zeros((n, 3), np.float32)), rd=xp(d), throughput=xp(f["through"]),
                 alive=xp(np.ones(n, bool)))
        base = rng_mod.base(rng_mod.stream(5, 3, 2, rng_mod.STREAM_BSDF), T(pix))
        out = scat(rays, hits, base)
        return [np.asarray(x) for x in (out.ro, out.rd, out.throughput)]

    mine = run(torch.tensor, Materials, Rays, Hits, torch.tensor, rng, scatter_legacy)
    ref = run(lambda a: jnp.asarray(a.astype(np.uint32)), JMaterials, JRays, JHits,
              jnp.asarray, jrng, j_scatter_legacy)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


# --------------------------------------------------------------- .world.npy --

def test_world_npy_roundtrip_renders_identically(tmp_path):
    """A saved and reloaded world renders bit for bit like the built one;
    the file loads in the JAX package with the same tables."""
    from learn_path_tracing_tpu_torch.camera import Camera
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid

    _, _, tw, twd = _build_both(tmp_path, "two")
    path = str(tmp_path / "w.world.npy")
    tw.save(path)
    back = tlw.LegacyWorld(environment_size=(128, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bwd = back.load(path)
        jwd = jlw.LegacyWorld(environment_size=(128, 64)).load(path)
    for a, b in zip(bwd.meshes[0].packet, jwd.meshes[0].packet):
        assert _same(a, b)
    cam = Camera((24, 16))
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    imgs = [render_hybrid(wd, cam.params(), (24, 16), spp=2, limit=4, seed=1)
            for wd in (twd, bwd)]
    assert imgs[0][1] == imgs[1][1] and torch.equal(imgs[0][0], imgs[1][0])


def test_malicious_pickle_rejected(tmp_path):
    import numpy.lib.format as fmt

    path = tmp_path / "evil.world.npy"
    with open(path, "wb") as f:
        fmt.write_array_header_2_0(f, {"descr": "|O", "fortran_order": False, "shape": ()})
        f.write(pickle.dumps(os.system))
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        serialize.load_world_npy(str(path))
