"""Program entry: ``integrator.persistent.render_persistent`` on a sphere scene.

The cell's traffic file names the engine (``mega``: one fused bounce kernel
a pass, K4; ``auto``: the engine the port picks, today the modular one, K1
and the per-stage PyTorch ops). The world is the port's ``World`` built
from the benchmark's own sphere arrays; the camera is the port's thin-lens
``Camera`` of the configuration.
"""

from __future__ import annotations


def prepare(config, cell, scene, cache_dir):
    """What every rank needs: the scene's arrays (a few kB)."""
    return {"scene": scene}


def setup(config, cell, prepared, device):
    from learn_path_tracing_tpu_torch.camera import Camera
    from learn_path_tracing_tpu_torch.core.types import Material
    from learn_path_tracing_tpu_torch.scene.world import Sphere, World

    s = prepared["scene"]
    world = World([
        Sphere(tuple(s["center"][k].tolist()), float(s["radius"][k]),
               Material(albedo=tuple(s["albedo"][k].tolist()), roughness=float(s["roughness"][k]),
                        metallic=float(s["metallic"][k]), ior=float(s["ior"][k]),
                        transparency=float(s["transparency"][k])))
        for k in range(s["radius"].shape[0])])
    c = config["camera"]
    res = tuple(config["resolution"])
    cam = Camera(res)
    cam.set_position(c["position"])
    cam.look_at(c["look_at"])
    cam.set_fov(c["fov"])
    cam.set_len(c["focal_length"], c["aperture"])
    return {"wd": world.device(device), "cp": cam.params(device), "res": res,
            "spp": cell["spp"], "limit": config["depth"], "engine": cell["engine"]}


def frame(state, seed):
    from learn_path_tracing_tpu_torch.integrator.persistent import render_persistent

    img, segments, stats = render_persistent(
        state["wd"], state["cp"], state["res"], state["spp"], limit=state["limit"], seed=seed,
        engine=state["engine"], stats=True)
    return {"image": img, "segments": segments, "stats": stats}
