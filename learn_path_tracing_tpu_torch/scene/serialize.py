"""``.world.npy`` scene serialization (reference-compatible).

The code of ``learn_path_tracing_tpu.scene.serialize`` (numpy only), kept
in the port so that it never imports the JAX package; it reads the ``.npy``
header through numpy's public API.

The reference saves scenes as ``np.save``'d pickled dicts
(the reference's legacy/PT_in_one_weekend/15_module.py:815-836):

    {'meshes_bvhs': [bvh_dump...], 'environment': id,
     'textures': tm_dump, 'environments': tm_dump, 'spheres_bvh'?: bvh_dump}

where each BVH dump is ``{'max_depth', '<field>': {'data': ndarray-or-dict,
'shape': [...]}}`` (taichi ``to_numpy()`` of struct fields yields nested
dicts of plain numpy arrays). Two schema eras exist: 14-era files
(demo/Ganyu/Zhongli) lack the texture-manager dumps; 15-era files
(Yoimiya/Barbara/Yoimiya_ShapeChange) embed them, including pickled
``taichi.lang.struct.Struct`` / ``matrix.Matrix`` objects for rect areas.

This loader needs no taichi: a restricted Unpickler admits only numpy
globals plus shims for those two taichi classes (their pickled state is a
plain ``__dict__`` with an ``entries`` member), and everything is validated
and normalized into plain python/numpy structures before use. Pickles
containing ANY other global are rejected — these files are untrusted input.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

_ALLOWED_NUMPY = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}

_TAICHI_SHIMS = {
    ("taichi.lang.struct", "Struct"),
    ("taichi.lang.matrix", "Matrix"),
}


class _TaichiShim:
    """Stand-in for pickled taichi Struct/Matrix python-scope objects."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"state": state})

    @property
    def entries(self):
        return self.__dict__.get("entries")

    def __getitem__(self, key):
        return self.entries[key]


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED_NUMPY:
            return super().find_class(module, name)
        if (module, name) in _TAICHI_SHIMS:
            return _TaichiShim
        raise pickle.UnpicklingError(
            f"disallowed global in .world.npy: {module}.{name}")


def _load_pickled_npy(path):
    import numpy.lib.format as fmt

    with open(path, "rb") as f:
        # the public header readers: numpy 2.x dropped the private
        # ``_read_array_header`` the JAX package's copy calls
        version = fmt.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = fmt.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = fmt.read_array_header_2_0(f)
        else:
            raise ValueError(f"unsupported .npy format version {version} in {path}")
        if dtype != np.dtype(object) or shape != ():
            raise ValueError(f"unexpected npy payload in {path}: {shape} {dtype}")
        return _RestrictedUnpickler(f).load()


def _norm_vec(v):
    """taichi Matrix shim / list / tuple / ndarray → tuple of python numbers."""
    if isinstance(v, _TaichiShim):
        v = v.entries
    if isinstance(v, np.ndarray):
        v = v.reshape(-1).tolist()
    return tuple(np.asarray(x).item() if isinstance(x, np.ndarray) else x
                 for x in v)


def _norm_area(area):
    if isinstance(area, _TaichiShim):
        return {"low": _norm_vec(area["low"]), "high": _norm_vec(area["high"])}
    if isinstance(area, dict):
        return {"low": _norm_vec(area["low"]), "high": _norm_vec(area["high"])}
    raise ValueError(f"bad area record: {type(area)}")


def _norm_tm(dump):
    configs = []
    for cfg in dump["configs"]:
        configs.append({
            "file_path": str(cfg["file_path"]),
            "size": tuple(int(x) for x in cfg["size"]),
            "id": int(cfg["id"]),
            "area": _norm_area(cfg["area"]),
        })
    return {"size": tuple(int(x) for x in dump["size"]), "configs": configs}


def _field(dump, name):
    rec = dump[name]
    return rec["data"], tuple(rec["shape"])


def load_world_npy(path) -> dict:
    """Load + validate a ``.world.npy`` file into normalized host structures.

    Returns::

        {'environment': int | None,
         'textures': tm_dump | None, 'environments': tm_dump | None,
         'spheres_bvh': {...} | None, 'meshes_bvhs': [{...}]}

    Mesh BVH records carry: max_depth, nodes {left,right,low,high,data},
    cut, faces {p,n,t: i32[P,3], tex: i32[P]} (leaf-inlined order),
    positions/normals/uvs.
    Sphere BVH records carry: max_depth, nodes, cut, spheres
    {center f32[P,3], radius, transparency, texture_id}.
    """
    raw = _load_pickled_npy(path)
    data = raw.item() if isinstance(raw, np.ndarray) else raw
    if not isinstance(data, dict):
        raise ValueError(f"{path}: top-level payload is not a dict")

    out = {
        "environment": None if data.get("environment") is None
        else int(data["environment"]),
        "textures": _norm_tm(data["textures"]) if "textures" in data else None,
        "environments": _norm_tm(data["environments"])
        if "environments" in data else None,
        "spheres_bvh": None,
        "meshes_bvhs": [],
    }

    def norm_nodes(dump):
        nodes, _ = _field(dump, "tree_nodes_field")
        return {
            "left": np.asarray(nodes["left"], np.int32),
            "right": np.asarray(nodes["right"], np.int32),
            "low": np.asarray(nodes["aabb"]["low"], np.float32),
            "high": np.asarray(nodes["aabb"]["high"], np.float32),
            "data": np.asarray(nodes["data"], np.int32),
        }

    if "spheres_bvh" in data and data["spheres_bvh"] is not None:
        d = data["spheres_bvh"]
        leaves, _ = _field(d, "tree_leaves_field")
        cut, _ = _field(d, "tree_leaves_field_cut")
        out["spheres_bvh"] = {
            "max_depth": int(d["max_depth"]),
            "nodes": norm_nodes(d),
            "cut": np.asarray(cut, np.int32),
            "spheres": {
                "center": np.asarray(leaves["center"], np.float32),
                "radius": np.asarray(leaves["radius"], np.float32),
                "transparency": np.asarray(leaves["transparency"], np.int32),
                "texture_id": np.asarray(leaves.get(
                    "texture_id", np.zeros(len(leaves["radius"]))), np.int32),
            },
        }

    for d in data.get("meshes_bvhs", []):
        leaves, _ = _field(d, "tree_leaves_field")
        cut, _ = _field(d, "tree_leaves_field_cut")
        face_p = np.stack([leaves["a"]["p"], leaves["b"]["p"],
                           leaves["c"]["p"]], -1).astype(np.int32)
        face_n = np.stack([leaves["a"]["n"], leaves["b"]["n"],
                           leaves["c"]["n"]], -1).astype(np.int32)
        face_t = np.stack([leaves["a"]["t"], leaves["b"]["t"],
                           leaves["c"]["t"]], -1).astype(np.int32)
        out["meshes_bvhs"].append({
            "max_depth": int(d["max_depth"]),
            "nodes": norm_nodes(d),
            "cut": np.asarray(cut, np.int32),
            "faces": {
                "p": face_p, "n": face_n, "t": face_t,
                "tex": np.asarray(leaves["texture_id"], np.int32),
            },
            "positions": np.asarray(_field(d, "positions_field")[0], np.float32),
            "normals": np.asarray(_field(d, "normals_field")[0], np.float32),
            "uvs": np.asarray(_field(d, "texture_coords_field")[0], np.float32),
        })
    return out


def save_world_npy(path, *, meshes_bvhs, spheres_bvh=None, environment=None,
                   textures=None, environments=None):
    """Write the reference-compatible dict. Inputs use the normalized forms
    produced by load_world_npy / built by scene.legacy_world."""

    def nodes_dump(rec, extra_fields):
        d = {
            "max_depth": rec["max_depth"],
            "tree_nodes_field": {
                "data": {
                    "left": np.asarray(rec["nodes"]["left"], np.int32),
                    "right": np.asarray(rec["nodes"]["right"], np.int32),
                    "aabb": {
                        "low": np.asarray(rec["nodes"]["low"], np.float32),
                        "high": np.asarray(rec["nodes"]["high"], np.float32),
                    },
                    "data": np.asarray(rec["nodes"]["data"], np.int32),
                },
                "shape": [int(rec["nodes"]["left"].shape[0])],
            },
            "tree_leaves_field_cut": {
                "data": np.asarray(rec["cut"], np.int32),
                "shape": [int(rec["cut"].shape[0])],
            },
        }
        d.update(extra_fields)
        return d

    data = {"meshes_bvhs": [], "environment": environment}
    if textures is not None:
        data["textures"] = textures
    if environments is not None:
        data["environments"] = environments

    if spheres_bvh is not None:
        s = spheres_bvh["spheres"]
        data["spheres_bvh"] = nodes_dump(spheres_bvh, {
            "tree_leaves_field": {
                "data": {
                    "center": np.asarray(s["center"], np.float32),
                    "radius": np.asarray(s["radius"], np.float32),
                    "transparency": np.asarray(s["transparency"], np.int32),
                    "texture_id": np.asarray(s["texture_id"], np.int32),
                },
                "shape": [int(s["radius"].shape[0])],
            },
        })

    for rec in meshes_bvhs:
        f = rec["faces"]
        p_count = int(f["tex"].shape[0])
        data["meshes_bvhs"].append(nodes_dump(rec, {
            "tree_leaves_field": {
                "data": {
                    "a": {"p": f["p"][:, 0], "n": f["n"][:, 0], "t": f["t"][:, 0]},
                    "b": {"p": f["p"][:, 1], "n": f["n"][:, 1], "t": f["t"][:, 1]},
                    "c": {"p": f["p"][:, 2], "n": f["n"][:, 2], "t": f["t"][:, 2]},
                    "texture_id": np.asarray(f["tex"], np.int32),
                },
                "shape": [p_count],
            },
            "positions_field": {"data": np.asarray(rec["positions"], np.float32),
                                "shape": [int(rec["positions"].shape[0])]},
            "normals_field": {"data": np.asarray(rec["normals"], np.float32),
                              "shape": [int(rec["normals"].shape[0])]},
            "texture_coords_field": {"data": np.asarray(rec["uvs"], np.float32),
                                     "shape": [int(rec["uvs"].shape[0])]},
        }))

    np.save(path, data)  # allow_pickle implied for object arrays
