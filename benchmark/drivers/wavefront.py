"""Program entry: ``integrator.wavefront.render`` on a sphere scene walked
through its BVH.

Set-up builds the port's ``World`` from the benchmark's own sphere arrays
and its device tables with the SAH sphere BVH (``World.device(use_bvh=True)``:
K3's tables), and the legacy camera of the configuration (``fov`` the half
angle, a thin lens). Every frame is the stage's own call: the legacy BSDF,
the cell's ``hit_backend`` (``'bvh'``: K3 on every bounce pass) and
``early_exit``, the thin-lens camera model, with the render's stats.
"""

from __future__ import annotations


def prepare(config, cell, scene, cache_dir):
    """What every rank needs: the scene's arrays (a few kB)."""
    return {"scene": scene}


def world(scene):
    """The port's ``World`` of the scene's arrays."""
    from learn_path_tracing_tpu_torch.core.types import Material
    from learn_path_tracing_tpu_torch.scene.world import Sphere, World

    return World([
        Sphere(tuple(scene["center"][k].tolist()), float(scene["radius"][k]),
               Material(albedo=tuple(scene["albedo"][k].tolist()),
                        roughness=float(scene["roughness"][k]),
                        metallic=float(scene["metallic"][k]), ior=float(scene["ior"][k]),
                        transparency=float(scene["transparency"][k]),
                        absorptivity=float(scene["absorptivity"][k])))
        for k in range(scene["radius"].shape[0])])


def camera(config):
    """The configuration's ``LegacyCamera``."""
    from learn_path_tracing_tpu_torch.camera import LegacyCamera

    c = config["camera"]
    cam = LegacyCamera(tuple(config["resolution"]))
    cam.set_fov(c["fov"])
    cam.set_len(c["focal_length"], c["aperture"])
    cam.set_position(c["position"])
    cam.look_at(c["look_at"])
    return cam


def setup(config, cell, prepared, device):
    return {"wd": world(prepared["scene"]).device(device, use_bvh=True),
            "cp": camera(config).params(device), "res": tuple(config["resolution"]),
            "spp": cell["spp"], "limit": config["depth"], "bsdf": config["bsdf"],
            "hit_backend": cell["hit_backend"], "early_exit": cell["early_exit"]}


def frame(state, seed):
    from learn_path_tracing_tpu_torch.integrator.wavefront import render

    img, segments, stats = render(
        state["wd"], state["cp"], state["res"], spp=state["spp"], limit=state["limit"],
        seed=seed, bsdf=state["bsdf"], hit_backend=state["hit_backend"],
        early_exit=state["early_exit"], stats=True)
    return {"image": img, "segments": segments, "stats": stats}
