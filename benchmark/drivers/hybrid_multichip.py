"""Program entry: ``parallel.mesh.render_hybrid_multichip`` on a legacy mesh
world, every rank of the process group (``parallel.launch``) a card.

The mesh is ``parallel.mesh.make_mesh()``'s default: every rank a tile of
the flat pixel axis, one spp group. Each rank loads the world the way
``drivers/hybrid.py`` does and renders its tile; the combine gathers the
tiles (NCCL), so every rank returns the whole image.
"""

from __future__ import annotations

from .hybrid import _camera, load_world, prepare  # noqa: F401  (prepare: the same cache)


def setup(config, cell, prepared, device):
    from learn_path_tracing_tpu_torch.parallel.mesh import make_mesh

    return {"wd": load_world(config, prepared, device), "cp": _camera(config, device),
            "res": tuple(config["resolution"]), "spp": cell["spp"], "limit": config["depth"],
            "mesh": make_mesh()}


def frame(state, seed):
    from learn_path_tracing_tpu_torch.parallel.mesh import render_hybrid_multichip

    img, segments = render_hybrid_multichip(
        state["wd"], state["cp"], state["res"], state["spp"], state["mesh"],
        limit=state["limit"], seed=seed, bsdf="legacy", camera_model="jitter", scene="legacy")
    return {"image": img, "segments": segments, "stats": {}}
