"""The stand-in for the reference's character worlds, frozen for the benchmark.

A copy of the port repository's ``chip_smoke._icosphere``,
``_standin_mesh`` and ``_standin_assets``: one closed figure (an icosphere
of ``level`` subdivisions, displaced by seeded smooth noise and stretched to
16 units) on a tessellated base, 23,424 triangles at level 5, the size of
the reference's Yoimiya mesh; a PBR texture set (albedo, roughness,
metallic, normal) of ``tex_size``²; an equirect HDR sky of ``env_size``
with a sun of radiance ~40. ``generate`` returns the arrays (the textures
as the 8-bit images written to disk, the sky as the f32 array the EXR holds
in half precision); ``write_assets`` writes the files the program loads.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

FIELDS = ("positions", "normals", "uvs", "faces", "face_tex", "albedo", "roughness",
          "metallic", "normal_map", "env")
TEXTURE_NAMES = ("albedo", "roughness", "metallic", "normal")


def _icosphere(level):
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


def _mesh(level, seed, segments=64, rings=6, rows=12):
    rs = np.random.default_rng(seed)
    unit, faces = _icosphere(level)
    waves = rs.normal(size=(8, 3)) * 2.5
    phase = rs.uniform(0, 2 * np.pi, 8)
    amp = rs.uniform(0.02, 0.05, 8)
    bump = 1.0 + np.sin(unit @ waves.T + phase) @ amp
    body = unit * bump[:, None] * np.array([3.0, 8.0, 3.0]) + np.array([0.0, 8.5, 0.0])
    fn = np.cross(body[faces[:, 1]] - body[faces[:, 0]], body[faces[:, 2]] - body[faces[:, 0]])
    vn = np.zeros_like(body)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    uv = np.stack([np.arctan2(unit[:, 2], unit[:, 0]) / (2 * np.pi) + 0.5,
                   (unit[:, 1] + 1.0) / 2.0], axis=1)

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
        add(p, np.tile([0.0, up, 0.0], (p.shape[0], 1)), (p[:, [0, 2]] / 8.0) + 0.5, f)
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
    return {"positions": np.concatenate(pos).astype(np.float32),
            "normals": np.concatenate(nrm).astype(np.float32),
            "uvs": np.concatenate(tex).astype(np.float32),
            "faces": faces, "face_tex": np.zeros(faces.shape[0], np.int32)}


def _assets(seed, tex_size, env_size):
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

    def u8(img):
        return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)

    w, h = env_size
    el = (0.5 - (np.arange(h) + 0.5) / h) * np.pi
    az = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    sky = np.array([0.25, 0.45, 1.2]) + (np.array([1.1, 1.0, 0.9]) - np.array([0.25, 0.45, 1.2])) \
        * np.exp(-np.abs(el) * 4.0)[:, None]
    ground = np.array([0.25, 0.2, 0.15])
    env = np.where((el > 0)[:, None, None], sky[:, None, :], ground)[:, :, :] * np.ones((h, w, 3))
    sun_el, sun_az = 0.6, 0.8
    cosang = (np.sin(el)[:, None] * np.sin(sun_el)
              + np.cos(el)[:, None] * np.cos(sun_el) * np.cos(az[None, :] - sun_az))
    env += 40.0 * np.exp((cosang - 1.0) * 400.0)[:, :, None]
    return {"albedo": u8(albedo), "roughness": u8(rough), "metallic": u8(metal),
            "normal_map": u8(nrm), "env": env.astype(np.float32)}


def generate(config) -> dict:
    """The stand-in of ``config["world"]`` (``level``, ``seed``,
    ``tex_size``, ``env_size``): mesh arrays (``faces`` index positions,
    normals and uvs alike) and asset arrays."""
    world = config["world"]
    out = _mesh(world["level"], world["seed"])
    out.update(_assets(world["seed"], world["tex_size"], tuple(world["env_size"])))
    return out


def digest(arrays) -> str:
    h = hashlib.sha256()
    for name in FIELDS:
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()[:16]


def write_exr_half(path, img):
    """``img f32[H,W,3]`` as an uncompressed half-float scanline EXR."""
    h, w, _ = img.shape
    planes = img.astype(np.float16)

    def attr(name, atype, payload):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chl = b"".join(n.encode() + b"\0" + struct.pack("<i", 1) + b"\0\0\0\0"
                   + struct.pack("<ii", 1, 1) for n in "BGR") + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
              + attr("channels", "chlist", chl)
              + attr("compression", "compression", b"\0")
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    line = 8 + w * 3 * 2
    base = len(header) + 8 * h
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *(base + y * line for y in range(h))))
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 3 * 2))
            for c in (2, 1, 0):
                f.write(planes[y, :, c].tobytes())


def write_assets(arrays, directory) -> tuple:
    """The texture set ``<dir>/standin_<name>.png`` and ``<dir>/standin_env.exr``;
    returns ``(texture base path, exr path)``."""
    from PIL import Image

    base = os.path.join(directory, "standin")
    for name, key in zip(TEXTURE_NAMES, ("albedo", "roughness", "metallic", "normal_map")):
        Image.fromarray(arrays[key]).save(f"{base}_{name}.png")
    exr = os.path.join(directory, "standin_env.exr")
    write_exr_half(exr, arrays["env"])
    return base, exr
