"""Program entry: ``integrator.hybrid.render_hybrid`` on a legacy mesh world.

Set-up writes the stand-in's assets once per checkout into the benchmark's
cache (``.cache/<scene>_<digest>/``): the texture set, the HDR sky and the
``.world.npy`` the port builds from them. Every run then loads that file
through ``LegacyWorld.load``, the path of the reference's stage 14 user
(the BVH is rebuilt on load), and renders with the legacy BSDF and the
jittered pinhole camera of the configuration.
"""

from __future__ import annotations

import os

WORLD_FILE = "standin.world.npy"


def prepare(config, cell, scene, cache_dir):
    """The world file, written here when the cache lacks it."""
    import warnings

    from learn_path_tracing_tpu_torch.io.obj import MeshData
    from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map

    from ..scenes import standin

    directory = os.path.join(cache_dir, f"{config['scene']}_{config['digest']}")
    path = os.path.join(directory, WORLD_FILE)
    if not os.path.exists(path):
        os.makedirs(directory, exist_ok=True)
        standin.write_assets(scene, directory)
        faces = scene["faces"]
        world = LegacyWorld()
        world.add_mesh(MeshData(positions=scene["positions"], normals=scene["normals"],
                                uvs=scene["uvs"], face_p=faces, face_n=faces.copy(),
                                face_t=faces.copy(), face_tex=scene["face_tex"]))
        wsize = config["world"]
        world.textures.add("./standin", 0, size=(wsize["tex_size"], wsize["tex_size"]))
        world.environments.add("./standin_env.exr", 0, size=tuple(wsize["env_size"]))
        world.set_environment(0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            world.build(path_map=make_asset_path_map(directory))
        missing = [str(w.message) for w in caught if "missing" in str(w.message)]
        if missing:
            raise FileNotFoundError("; ".join(missing))
        tmp = os.path.join(directory, f"tmp{os.getpid()}.world.npy")
        world.save(tmp)
        os.replace(tmp, path)
    return {"world": path}


def _camera(config, device):
    from learn_path_tracing_tpu_torch.camera import LegacyCamera

    c = config["camera"]
    cam = LegacyCamera(tuple(config["resolution"]))
    cam.set_fov(c["fov"])
    cam.set_position(c["position"])
    cam.look_at(c["look_at"])
    return cam.params(device)


def load_world(config, prepared, device):
    from learn_path_tracing_tpu_torch.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu_torch.stages.legacy_common import make_asset_path_map

    path = prepared["world"]
    return LegacyWorld().load(path, path_map=make_asset_path_map(os.path.dirname(path)),
                              device=device)


def setup(config, cell, prepared, device):
    return {"wd": load_world(config, prepared, device), "cp": _camera(config, device),
            "res": tuple(config["resolution"]), "spp": cell["spp"], "limit": config["depth"]}


def frame(state, seed):
    from learn_path_tracing_tpu_torch.integrator.hybrid import render_hybrid

    img, segments, stats = render_hybrid(
        state["wd"], state["cp"], state["res"], state["spp"], limit=state["limit"], seed=seed,
        bsdf="legacy", camera_model="jitter", scene="legacy", stats=True)
    return {"image": img, "segments": segments, "stats": stats}
