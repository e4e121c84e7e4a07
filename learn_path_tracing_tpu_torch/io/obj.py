"""OBJ/MTL loading → numpy mesh arrays.

The same code as ``learn_path_tracing_tpu.io.obj`` (numpy only), kept in
the port so that it never imports the JAX package.

Parsing semantics mirror the reference's ``load_obj``
(the reference's legacy/PT_in_one_weekend/15_module.py:135-206):

- ``v``/``vn``/``vt``/``f`` with triangle faces indexed ``p/t/n`` (1-based);
- ``mtllib`` → parse ``newmtl``/``map_Kd``; texture files are deduplicated
  and assigned incrementing ids starting at ``texture_start_id``;
- ``usemtl`` selects the texture id applied to subsequent faces;
- options: ``flip_z`` (negate z of positions *and* normals),
  ``flip_textcoord`` (v → 1-v), ``transform`` (3x3 applied to positions and
  normals).

Faces emitted before any ``usemtl`` get texture id -1 (the reference would
crash on such files).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MeshData:
    """Host-side indexed triangle mesh."""

    positions: np.ndarray       # f32[V,3]
    normals: np.ndarray         # f32[Vn,3]
    uvs: np.ndarray             # f32[Vt,2]
    face_p: np.ndarray          # i32[F,3] position indices
    face_n: np.ndarray          # i32[F,3] normal indices
    face_t: np.ndarray          # i32[F,3] uv indices
    face_tex: np.ndarray        # i32[F] texture id per face
    textures: list = field(default_factory=list)  # [{'file_path', 'id'}]

    @property
    def n_faces(self) -> int:
        return self.face_p.shape[0]


def load_obj(file_path, texture_start_id: int = 0, flip_z: bool = False,
             flip_textcoord: bool = False, transform=None) -> MeshData:
    dir_path = os.path.dirname(file_path)
    positions, normals, uvs = [], [], []
    face_p, face_n, face_t, face_tex = [], [], [], []
    textures: list[dict] = []
    textures_name: dict[str, int] = {}
    usemtl = None
    if transform is not None:
        transform = np.asarray(transform, np.float64)

    with open(file_path, "r") as f:
        lines = f.readlines()

    for raw in lines:
        if not raw or raw[0] == "#":
            continue
        line = raw.split()
        if not line:
            continue
        tag = line[0]
        if tag == "mtllib":
            mtl_name = None
            with open(os.path.join(dir_path, line[1]), "r") as mtl:
                for mtl_raw in mtl:
                    mtl_line = mtl_raw.split()
                    if not mtl_line:
                        continue
                    if mtl_line[0] == "newmtl":
                        mtl_name = mtl_line[1]
                    elif mtl_line[0] == "map_Kd":
                        tex_path = os.path.join(dir_path, mtl_line[1])
                        for i, tex in enumerate(textures):
                            if tex["file_path"] == tex_path:
                                textures_name[mtl_name] = i
                                break
                        else:
                            textures_name[mtl_name] = len(textures)
                            textures.append(
                                {"file_path": tex_path, "id": texture_start_id})
                            texture_start_id += 1
        elif tag == "v":
            p = np.array([float(line[1]), float(line[2]), float(line[3])])
            if flip_z:
                p[2] = -p[2]
            if transform is not None:
                p = transform @ p
            positions.append(p)
        elif tag == "vn":
            n = np.array([float(line[1]), float(line[2]), float(line[3])])
            if flip_z:
                n[2] = -n[2]
            if transform is not None:
                n = transform @ n
            normals.append(n)
        elif tag == "vt":
            u, v = float(line[1]), float(line[2])
            if flip_textcoord:
                v = 1.0 - v
            uvs.append((u, v))
        elif tag == "usemtl":
            usemtl = line[1]
        elif tag == "f":
            if len(line) != 4:
                raise ValueError(
                    f"non-triangle face ({len(line)-1} vertices) in {file_path}; "
                    "triangulate the mesh first (reference supports triangles only)")
            verts = [line[i].split("/") for i in (1, 2, 3)]
            face_p.append([int(v[0]) - 1 for v in verts])
            face_t.append([int(v[1]) - 1 for v in verts])
            face_n.append([int(v[2]) - 1 for v in verts])
            if usemtl is not None and usemtl in textures_name:
                face_tex.append(textures[textures_name[usemtl]]["id"])
            else:
                face_tex.append(-1)

    return MeshData(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        face_p=np.asarray(face_p, np.int32).reshape(-1, 3),
        face_n=np.asarray(face_n, np.int32).reshape(-1, 3),
        face_t=np.asarray(face_t, np.int32).reshape(-1, 3),
        face_tex=np.asarray(face_tex, np.int32).reshape(-1),
        textures=textures,
    )
