"""Seeded scenes in place of the reference's assets.

The reference's character worlds (the Yoimiya mesh, its PBR texture set and
its HDR sky) are not in the repository. ``standin_world`` builds a world of
the same size from a seed: one closed mesh of 23,424 triangles (a
displaced, subdivided icosphere 16 units tall on a tessellated base), a
1024² PBR texture set and a 2048x1024 HDR environment.
``standin_asset_tree`` writes the same figure as the reference's OBJ + MTL
+ PNG + EXR asset tree for ``stages.l15_module``, ``standin_camera`` is the
character scripts' camera, and ``sphere_world`` is 8,192 seeded spheres,
past the brute-scan ceiling, so that the sphere BVH (K3) runs.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
from PIL import Image

from ..camera import LegacyCamera
from ..io.exr import write_exr
from ..io.obj import MeshData
from ..scene.legacy_world import LegacyWorld

STANDIN_SEED = 20231016
STANDIN_TEX, STANDIN_ENV = 1024, (2048, 1024)   # PBR set side, EXR (w, h)
N_SPHERES = 8192          # past the 4,096-sphere brute-scan ceiling: K3


def icosphere(level):
    """Unit icosphere: ``(verts f64[V,3], faces i64[F,3])``, F = 20 * 4**level."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    return np.array(verts), np.array(faces, np.int64)


def standin_mesh(level, seed, segments=64, rings=6, rows=12):
    """One closed figure on a base, as a ``MeshData``: an icosphere of
    ``level`` subdivisions displaced by seeded smooth noise and stretched
    into a 16-unit-tall body (centre (0, 8.5, 0)), on a cylinder of radius
    4 and height 0.5 tessellated with ``segments`` x (``rings`` per cap,
    ``rows`` on the side). ``level`` 5 gives 20,480 + 2,944 = 23,424
    triangles, the size of the reference's Yoimiya mesh."""
    rs = np.random.default_rng(seed)
    unit, faces = icosphere(level)
    waves = rs.normal(size=(8, 3)) * 2.5
    phase = rs.uniform(0, 2 * np.pi, 8)
    amp = rs.uniform(0.02, 0.05, 8)
    bump = 1.0 + np.sin(unit @ waves.T + phase) @ amp
    body = unit * bump[:, None] * np.array([3.0, 8.0, 3.0]) + np.array([0.0, 8.5, 0.0])
    # area-weighted vertex normals of the displaced body
    fn = np.cross(body[faces[:, 1]] - body[faces[:, 0]], body[faces[:, 2]] - body[faces[:, 0]])
    vn = np.zeros_like(body)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    uv = np.stack([np.arctan2(unit[:, 2], unit[:, 0]) / (2 * np.pi) + 0.5,
                   (unit[:, 1] + 1.0) / 2.0], axis=1)

    # base: two capped discs of concentric rings plus the side wall, each
    # with its own vertices (flat normals), closed where they meet
    ang = np.arange(segments) * (2 * np.pi / segments)
    ring_xz = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    pos, nrm, tex, tris = [body], [vn], [uv], [faces]
    count = body.shape[0]

    def add(p, n, t, f):
        nonlocal count
        pos.append(p)
        nrm.append(n)
        tex.append(t)
        tris.append(f + count)
        count += p.shape[0]

    for y, up in ((0.5, 1.0), (0.0, -1.0)):
        radii = np.arange(1, rings + 1) * (4.0 / rings)
        p = [np.array([[0.0, y, 0.0]])]
        for r in radii:
            p.append(np.stack([r * ring_xz[:, 0], np.full(segments, y), r * ring_xz[:, 1]], 1))
        p = np.concatenate(p)
        f = []
        nxt = np.roll(np.arange(segments), -1)
        f += [(0, 1 + j, 1 + nxt[j]) for j in range(segments)]
        for k in range(rings - 1):
            a, b = 1 + k * segments, 1 + (k + 1) * segments
            for j in range(segments):
                f += [(a + j, b + j, b + nxt[j]), (a + j, b + nxt[j], a + nxt[j])]
        f = np.array(f, np.int64)
        if up < 0:
            f = f[:, ::-1]
        add(p, np.tile([0.0, up, 0.0], (p.shape[0], 1)),
            (p[:, [0, 2]] / 8.0) + 0.5, f)
    ys = np.linspace(0.0, 0.5, rows + 1)
    p = np.concatenate([np.stack([4.0 * ring_xz[:, 0], np.full(segments, y),
                                  4.0 * ring_xz[:, 1]], 1) for y in ys])
    n = np.tile(np.stack([ring_xz[:, 0], np.zeros(segments), ring_xz[:, 1]], 1), (rows + 1, 1))
    t = np.stack([np.tile(ang / (2 * np.pi), rows + 1), np.repeat(ys * 2.0, segments)], 1)
    nxt = np.roll(np.arange(segments), -1)
    f = []
    for k in range(rows):
        a, b = k * segments, (k + 1) * segments
        for j in range(segments):
            f += [(a + j, b + nxt[j], b + j), (a + j, a + nxt[j], b + nxt[j])]
    add(p, n, t, np.array(f, np.int64))

    faces = np.concatenate(tris).astype(np.int32)
    return MeshData(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        uvs=np.concatenate(tex).astype(np.float32),
        face_p=faces, face_n=faces.copy(), face_t=faces.copy(),
        face_tex=np.zeros(faces.shape[0], np.int32))


def standin_assets(directory, seed, tex_size, env_size):
    """A PBR texture set ``<dir>/standin_{albedo,roughness,metallic,normal}.png``
    of ``tex_size``² and an equirect HDR ``<dir>/standin_env.exr`` of
    ``env_size`` (w, h): a sky gradient over a dark ground with a sun of
    radiance ~40. Returns ``(texture base path, exr path)``."""
    rs = np.random.default_rng(seed)
    s = tex_size
    y, x = np.mgrid[0:s, 0:s] / s
    stripes = (np.sin(2 * np.pi * 12 * y + 3 * np.sin(2 * np.pi * 3 * x)) > 0).astype(np.float32)
    noise = rs.uniform(0, 1, (s // 16, s // 16)).repeat(16, 0).repeat(16, 1)
    albedo = np.stack([0.75 * stripes + 0.2, 0.35 + 0.3 * noise, 0.25 + 0.5 * (1 - stripes)], -1)
    rough = 0.25 + 0.6 * noise
    metal = ((np.sin(2 * np.pi * 4 * y) > 0.7) * 1.0).astype(np.float32)
    nrm = np.stack([0.5 + 0.1 * np.sin(2 * np.pi * 32 * x), 0.5 + 0.1 * np.cos(2 * np.pi * 32 * y),
                    np.ones_like(x)], -1)
    base = os.path.join(directory, "standin")
    for name, img in (("albedo", albedo), ("roughness", rough), ("metallic", metal),
                      ("normal", nrm)):
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(
            f"{base}_{name}.png")

    w, h = env_size
    el = (0.5 - (np.arange(h) + 0.5) / h) * np.pi                # row 0 = zenith
    az = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    sky = np.array([0.25, 0.45, 1.2]) + (np.array([1.1, 1.0, 0.9]) - np.array([0.25, 0.45, 1.2])) \
        * np.exp(-np.abs(el) * 4.0)[:, None]
    ground = np.array([0.25, 0.2, 0.15])
    env = np.where((el > 0)[:, None, None], sky[:, None, :], ground)[:, :, :] * np.ones((h, w, 3))
    sun_el, sun_az = 0.6, 0.8
    cosang = (np.sin(el)[:, None] * np.sin(sun_el)
              + np.cos(el)[:, None] * np.cos(sun_el) * np.cos(az[None, :] - sun_az))
    env += 40.0 * np.exp((cosang - 1.0) * 400.0)[:, :, None]
    exr = os.path.join(directory, "standin_env.exr")
    write_exr(exr, env.astype(np.float32), half=True)
    return base, exr


def standin_world(directory, level=5, tex_size=STANDIN_TEX, env_size=STANDIN_ENV,
                  seed=STANDIN_SEED, sphere=False):
    """The stand-in for the reference's character worlds, as a populated
    ``LegacyWorld`` (call ``build()``): ``standin_mesh(level)``, its
    texture set and environment written to ``directory``, and optionally a
    glass-free sphere beside the figure (the GPU-vs-CPU world)."""
    tex, exr = standin_assets(directory, seed, tex_size, env_size)
    world = LegacyWorld()
    world.add_mesh(standin_mesh(level, seed))
    if sphere:
        world.add_sphere((6.0, 3.0, -2.0), 3.0, transparency=0, texture_id=0)
    world.textures.add(tex, 0)
    world.environments.add(exr, 0, size=env_size)
    world.set_environment(0)
    return world


def _obj_rows(tag, rows, fmt):
    return "".join(f"{tag} {fmt % tuple(r)}\n" for r in rows.tolist())


def standin_asset_tree(root, level=5, tex_size=STANDIN_TEX, env_size=STANDIN_ENV,
                       seed=STANDIN_SEED, **base):
    """The stand-in as the reference's asset tree for ``stages.l15_module``
    under ``root``: ``models/Yoimiya/Yoimiya_ShapeChange.obj`` with its MTL
    (one material whose ``map_Kd`` names the PBR set ``standin``, the key
    ``io.obj.load_obj`` turns into a texture) and the set beside it, and
    ``textures/cayley_interior_2k.exr``. The OBJ holds ``standin_mesh``
    mirrored in x and with v flipped, which l15's 180° turn, ``flip_z`` and
    ``flip_textcoord`` undo, so the stage's world is the stand-in's figure
    (``base``: ``standin_mesh``'s tessellation of the base). Returns the
    OBJ's path."""
    model_dir = os.path.join(root, "models", "Yoimiya")
    tex_dir = os.path.join(root, "textures")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(tex_dir, exist_ok=True)
    _, exr = standin_assets(model_dir, seed, tex_size, env_size)
    os.replace(exr, os.path.join(tex_dir, "cayley_interior_2k.exr"))
    mesh = standin_mesh(level, seed, **base)
    mirror = np.array([-1.0, 1.0, 1.0], np.float32)
    uv = np.stack([mesh.uvs[:, 0], 1.0 - mesh.uvs[:, 1].astype(np.float64)], 1)
    faces = np.stack([mesh.face_p, mesh.face_t, mesh.face_n], -1) + 1     # [F, 3, 3]
    with open(os.path.join(model_dir, "Yoimiya_ShapeChange.mtl"), "w") as f:
        f.write("newmtl standin\nmap_Kd standin\n")
    path = os.path.join(model_dir, "Yoimiya_ShapeChange.obj")
    with open(path, "w") as f:
        f.write("mtllib Yoimiya_ShapeChange.mtl\n")
        f.write(_obj_rows("v", mesh.positions * mirror, "%.9g %.9g %.9g"))
        f.write(_obj_rows("vt", uv, "%.17g %.17g"))
        f.write(_obj_rows("vn", mesh.normals * mirror, "%.9g %.9g %.9g"))
        f.write("usemtl standin\n")
        f.write(_obj_rows("f", faces.reshape(-1, 9), "%d/%d/%d %d/%d/%d %d/%d/%d"))
    return path


def standin_camera(res):
    """The camera of the character scripts (``stages.l14_mesh``,
    ``stages.l15_module``): fov 30 from (0, 8, -30) towards (0, 8, 0)."""
    cam = LegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))
    return cam


def sphere_world():
    """8,192 seeded spheres (a tenth of them glass) in a 60-unit box: past
    the brute-scan ceiling, so ``build`` packs sphere tables for K3."""
    rs = np.random.default_rng(STANDIN_SEED + 1)
    world = LegacyWorld()
    centers = rs.uniform(-30, 30, (N_SPHERES, 3)) + np.array([0.0, 8.0, 40.0])
    for c, r, glass in zip(centers, rs.uniform(0.2, 1.2, N_SPHERES),
                           rs.uniform(size=N_SPHERES) < 0.1):
        world.add_sphere(tuple(c), float(r), transparency=int(glass))
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    return world


def build_quiet(world, **kw):
    """``world.build(**kw)`` with its warnings (the sphere world's missing
    texture) silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return world.build(**kw)
