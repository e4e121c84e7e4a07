"""The port's entry and multi-device dry run (counterpart of the JAX
package's ``__graft_entry__.py``).

- ``entry(device)`` returns ``(fn, args)``: one render pass of the 10_final
  cover scene at 64x36, spp 2, limit 8;
- ``dryrun_multichip(n, device)`` starts ``n`` ranks (``parallel.launch``)
  and renders, over a ``(tile, spp)`` mesh of them, the sphere world and a
  legacy mini-world (a textured quad and sphere, a missing texture, the
  environment) through every sharded function, the hybrid once more with a
  forced small ``cap`` (its make-room path, sharded). It returns rank 0's
  report.

    python -m learn_path_tracing_tpu_torch multichip --nproc N [--device cpu|cuda]
"""

from __future__ import annotations

import functools
import time
import warnings

import numpy as np

RES = (32, 16)      # the dry run's frame (the JAX package's)
SMALL_CAP = 64      # survivor batches of 64 lanes: every batch after the first makes room


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` renders one pass of the 10_final cover
    scene (``random_scene(size=3, seed=7)``) at 64x36, spp 2, limit 8 and
    returns ``(image f32[64,36,3], segments int)``."""
    from ..integrator.wavefront import render
    from ..models import random_scene, stage10_camera

    resolution = (64, 36)
    fn = functools.partial(render, resolution=resolution, spp=2, limit=8, seed=0,
                           bsdf="modern", camera_model="thinlens", hit_backend="auto")
    return fn, (random_scene(size=3, seed=7).device(device),
                stage10_camera(resolution).params(device))


def legacy_mini_world(resolution=RES):
    """The dry run's legacy world (``__graft_entry__.py``): a textured quad
    and a sphere, one missing texture (neutral fill), environment 0 (the
    sky gradient); and its camera. Returns ``(LegacyWorld built on the
    CPU, LegacyCamera)``."""
    from ..camera import LegacyCamera
    from ..io.obj import MeshData
    from ..scene.legacy_world import LegacyWorld

    world = LegacyWorld()
    world.add_mesh(MeshData(
        positions=np.array([[-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]], np.float32),
        normals=np.array([[0, 0, 1]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.array([[0, 0, 0], [0, 0, 0]], np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.array([0, 0], np.int32)))
    world.add_sphere((0, 1, 2), 0.5, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    cam = LegacyCamera(resolution)
    cam.set_fov(30)
    cam.set_position((0, 1, 6))
    cam.look_at((0, 1, 0))
    return world, cam


def dryrun_rank(device) -> dict:
    """One rank's dry run (run by ``dryrun_multichip`` on every rank): the
    mesh takes two spp shards when the world size is even. Raises where a
    render is not finite, is of the wrong shape, traced nothing, or where the
    hybrid's segments (at the auto and at the small ``cap``) differ from the
    persistent engine's on the same world. Returns ``{name: {"segments",
    "seconds", "mean"}}`` and the mesh shape."""
    import torch
    import torch.distributed as dist

    from ..models import random_scene, stage10_camera
    from .mesh import (make_mesh, render_hybrid_multichip, render_multichip,
                       render_persistent_multichip)

    n = dist.get_world_size()
    n_spp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n_tile=n // n_spp, n_spp=n_spp)
    spp = 2 * n_spp
    wd = random_scene(size=2, seed=7).device(device)
    cam = stage10_camera(RES).params(device)
    lworld, lcam = legacy_mini_world()
    lwd, lcp = lworld.device(device), lcam.params(device)
    legacy = dict(bsdf="legacy", scene="legacy")
    runs = {
        "wavefront spheres": (render_multichip, (wd, cam), {}),
        "wavefront legacy": (render_multichip, (lwd, lcp), legacy),
        "persistent spheres": (render_persistent_multichip, (wd, cam), {}),
        "persistent legacy": (render_persistent_multichip, (lwd, lcp), legacy),
        "hybrid legacy": (render_hybrid_multichip, (lwd, lcp), {}),
        "hybrid legacy small cap": (render_hybrid_multichip, (lwd, lcp), {"cap": SMALL_CAP}),
    }
    report = {"mesh": mesh.shape}
    for name, (fn, (w, c), kw) in runs.items():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, segs = fn(w, c, RES, spp, mesh, limit=4, seed=0, **kw)
        mean = float(img.mean())
        seconds = time.perf_counter() - t0
        if tuple(img.shape) != (RES[0], RES[1], 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: image {tuple(img.shape)} is not a finite frame")
        if segs <= 0:
            raise AssertionError(f"{name}: traced no segment")
        report[name] = {"segments": segs, "seconds": seconds, "mean": mean}
    want = report["persistent legacy"]["segments"]
    for name in ("hybrid legacy", "hybrid legacy small cap"):
        if report[name]["segments"] != want:
            raise AssertionError(f"{name}: {report[name]['segments']} segments, the "
                                 f"persistent engine's {want}")
    return report


def dryrun_multichip(n: int, device="cuda") -> dict:
    """The dry run on ``n`` ranks of a new process group (NCCL, one rank a
    card, on 'cuda'; gloo on 'cpu'); returns rank 0's report."""
    from .launch import launch

    n_tile = n // 2 if n % 2 == 0 else n
    if n < 1 or (RES[0] * RES[1]) % n_tile:
        raise ValueError(f"the dry run's {RES[0]}x{RES[1]} frame does not split over "
                         f"{n_tile} tiles (nproc={n})")
    return launch(n, dryrun_rank, device, device=device)
